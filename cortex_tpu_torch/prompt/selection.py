"""Context-aware prompt variant selection math.

Parity: crates/cortex-core/src/prompt/selection.rs —
  ContextSignals (:9-48) with named signal lookup incl. task_<type>
  one-hot (:63-86); context_fit = normalized weighted dot clamped to
  [0,1] (:125-146); score_variant = 0.5*edge_weight + 0.5*fit (:157-166,
  falls back to edge_weight without usable weights);
  observation_score = 0.5*sentiment + 0.3*(1 - corrections*0.1 capped)
  + 0.2*task_success (:175-184); EMA edge-weight update alpha=0.1
  (:191-194). epsilon-greedy selection (epsilon=0.2) lives at the HTTP
  layer (cortex-server http/selection.rs:38-49), mirrored in
  server.selection here.
"""

from __future__ import annotations

import random
from dataclasses import dataclass
from typing import Dict, Mapping, Optional

BLEND = 0.5
ALPHA = 0.1
TASK_TYPES = ["coding", "planning", "casual", "crisis", "reflection"]


@dataclass
class ContextSignals:
    sentiment: float = 0.5          # 0 = frustrated, 1 = pleased
    task_type: str = "casual"
    correction_rate: float = 0.0
    topic_shift: float = 0.0
    energy: float = 0.5

    def get_signal(self, key: str) -> float:
        if key in ("sentiment_high", "user_pleased"):
            return self.sentiment
        if key == "user_frustrated":
            return 1.0 - self.sentiment
        if key == "correction_rate_high":
            return self.correction_rate
        if key == "topic_shift_high":
            return self.topic_shift
        if key == "energy_high":
            return self.energy
        if key.startswith("task_"):
            return 1.0 if key[5:].lower() == self.task_type.lower() else 0.0
        return 0.0

    def to_signal_map(self) -> Dict[str, float]:
        m = {
            "user_pleased": self.sentiment,
            "sentiment_high": self.sentiment,
            "user_frustrated": 1.0 - self.sentiment,
            "correction_rate_high": self.correction_rate,
            "topic_shift_high": self.topic_shift,
            "energy_high": self.energy,
        }
        for tt in TASK_TYPES:
            m[f"task_{tt}"] = 1.0 if tt == self.task_type.lower() else 0.0
        return m

    @staticmethod
    def from_dict(d: Mapping) -> "ContextSignals":
        return ContextSignals(
            sentiment=float(d.get("sentiment", 0.5)),
            task_type=str(d.get("task_type", "casual")),
            correction_rate=float(d.get("correction_rate", 0.0)),
            topic_shift=float(d.get("topic_shift", 0.0)),
            energy=float(d.get("energy", 0.5)))


def context_fit(context_weights: Optional[Mapping[str, float]],
                signals: ContextSignals) -> Optional[float]:
    """Normalized weighted dot of variant weights vs signals; None when no
    usable weights (absent / empty / all zero)."""
    if not context_weights:
        return None
    dot = 0.0
    abs_sum = 0.0
    for key, w in context_weights.items():
        try:
            w = float(w)
        except (TypeError, ValueError):
            w = 0.0
        dot += signals.get_signal(key) * w
        abs_sum += abs(w)
    if abs_sum < 1e-9:
        return None
    return min(1.0, max(0.0, dot / abs_sum))


def score_variant(edge_weight: float,
                  context_weights: Optional[Mapping[str, float]],
                  signals: ContextSignals) -> float:
    fit = context_fit(context_weights, signals)
    if fit is None:
        return edge_weight
    return min(1.0, max(0.0, BLEND * edge_weight + (1.0 - BLEND) * fit))


def observation_score(sentiment: float, correction_count: int,
                      task_outcome: str) -> float:
    task_success = {"success": 1.0, "partial": 0.5}.get(task_outcome, 0.0)
    correction_penalty = min(correction_count * 0.1, 1.0)
    return min(1.0, max(0.0, 0.5 * sentiment
                        + 0.3 * (1.0 - correction_penalty)
                        + 0.2 * task_success))


def update_edge_weight(old_weight: float, obs_score: float) -> float:
    return min(1.0, max(0.0, old_weight + ALPHA * (obs_score - old_weight)))


def epsilon_greedy_pick(scored: Mapping[str, float], epsilon: float = 0.2,
                        rng: Optional[random.Random] = None) -> Optional[str]:
    """With prob epsilon pick uniformly, else the best-scoring variant
    (http/selection.rs:38-49, epsilon default 0.2 at :49)."""
    if not scored:
        return None
    rng = rng or random
    keys = sorted(scored)
    if rng.random() < epsilon:
        return rng.choice(keys)
    return max(keys, key=lambda k: scored[k])
