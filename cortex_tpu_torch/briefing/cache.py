"""Per-agent briefing cache: hit requires graph-version match AND TTL
freshness (crates/cortex-core/src/briefing/cache.rs:5-49)."""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Dict, Optional, TYPE_CHECKING

if TYPE_CHECKING:
    from .engine import Briefing


@dataclass
class _Entry:
    briefing: "Briefing"
    stored_at: float
    graph_version: int


#: distinct agent_id entries kept; stale/dead entries were previously
#: never removed, so a stream of unique agent ids (scanner, typo'd
#: clients) grew the dict — and every cached Briefing's node objects —
#: without bound in a long-lived server
MAX_ENTRIES = 1024


class BriefingCache:
    def __init__(self, ttl_secs: float = 300.0,
                 max_entries: int = MAX_ENTRIES):
        self.ttl = ttl_secs
        self.max_entries = max_entries
        self._entries: Dict[str, _Entry] = {}

    def get(self, agent_id: str, current_version: int) -> Optional["Briefing"]:
        e = self._entries.get(agent_id)
        if e is None:
            return None
        if e.graph_version != current_version:
            return None
        if time.monotonic() - e.stored_at >= self.ttl:
            return None
        return e.briefing

    def put(self, agent_id: str, briefing: "Briefing", version: int) -> None:
        if (len(self._entries) >= self.max_entries
                and agent_id not in self._entries):
            # evict expired entries first; if none qualify, drop the
            # stalest — simple bound, briefings regenerate cheaply
            now = time.monotonic()
            dead = [k for k, e in self._entries.items()
                    if now - e.stored_at >= self.ttl]
            for k in dead:
                self._entries.pop(k, None)
            if len(self._entries) >= self.max_entries:
                oldest = min(self._entries,
                             key=lambda k: self._entries[k].stored_at)
                self._entries.pop(oldest, None)
        self._entries[agent_id] = _Entry(
            briefing=briefing, stored_at=time.monotonic(),
            graph_version=version)

    def invalidate(self, agent_id: str) -> None:
        self._entries.pop(agent_id, None)
