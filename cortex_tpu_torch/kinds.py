"""Well-known node kinds (reference: crates/cortex-core/src/kinds.rs:8-36)."""

AGENT = "agent"
DECISION = "decision"
FACT = "fact"
EVENT = "event"
GOAL = "goal"
PREFERENCE = "preference"
PATTERN = "pattern"
OBSERVATION = "observation"
PROMPT = "prompt"

ALL = [AGENT, DECISION, FACT, EVENT, GOAL, PREFERENCE, PATTERN, OBSERVATION, PROMPT]
