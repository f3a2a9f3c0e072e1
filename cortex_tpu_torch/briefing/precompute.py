"""Briefing precomputer: keep hot agents' briefings warm in cache.

Parity: cortex-server/src/serve.rs:249-257 — a background task that
regenerates briefings for a configured agent list (env
CORTEX_BRIEFING_AGENTS, comma-separated, serve.rs:238-247) every 60s so
interactive `GET /briefing/:agent` hits the version-checked cache.
"""

from __future__ import annotations

import os
from typing import List, Optional, Sequence

ENV_BRIEFING_AGENTS = "CORTEX_BRIEFING_AGENTS"


def agents_from_env(env: Optional[dict] = None) -> List[str]:
    raw = (env or os.environ).get(ENV_BRIEFING_AGENTS, "")
    return [a.strip() for a in raw.split(",") if a.strip()]


class BriefingPrecomputer:
    def __init__(self, engine, agents: Sequence[str] = (),
                 interval_secs: float = 60.0):
        self.engine = engine
        self.agents = list(agents) or agents_from_env()
        self.interval_secs = interval_secs
        self.runs = 0
        self.errors = 0

    def run_once(self) -> int:
        """Generate (and thereby cache) each configured agent's briefing;
        errors are logged-and-skipped (serve.rs:253-256)."""
        warmed = 0
        for agent in self.agents:
            try:
                self.engine.generate(agent)
                warmed += 1
            except Exception:
                self.errors += 1
                import logging
                logging.getLogger("cortex.briefing").exception(
                    "briefing precompute failed for agent %r "
                    "(skipped; %d total errors)", agent, self.errors)
        self.runs += 1
        return warmed
