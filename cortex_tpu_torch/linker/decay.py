"""Access reinforcement of the edge decay engine.

Counterpart of the host half of cortex_tpu/linker/decay.py: the
storage calls that Cortex.search runs for `record_access`
(should_reinforce / reinforce). The vectorized decay sweep is ported
with the decay slice (ROADMAP queue A, 'Linker and decay').
"""

from __future__ import annotations

import time

from ..config import DecayConfig
from ..storage.base import Storage


class DecayEngine:
    def __init__(self, storage: Storage, config: DecayConfig):
        self.storage = storage
        self.config = config

    REINFORCED_AT_KEY = "_last_reinforced_at"

    def reinforce(self, node_id: str, node=None) -> int:
        """Reset the decay timer on all edges of an accessed node and bump
        its access count (decay.rs:104-135). Called from the search
        access-recording path, throttled by access_reinforcement_days
        (a node reinforces its edges at most once per window). Pass the
        in-memory `node` when the caller holds one so its fields stay in
        sync with what gets persisted."""
        now = time.time()
        edges = self.storage.edges_from(node_id) + self.storage.edges_to(node_id)
        for e in edges:
            # weight unchanged; updated_at reset restarts the decay window
            self.storage.update_edge_weight_atomic(e.id, e.weight, touch=True)
        # atomic conditional bump — a stale put_node here could
        # resurrect a node deleted since the caller read it
        applied = self.storage.record_access(node_id, now=now,
                                             reinforced_at=now)
        if applied and node is not None:
            # sync the caller's copy from what actually landed (field
            # assignment, not increment: MemoryStorage aliases stored
            # objects, so incrementing would double-count)
            fresh = self.storage.get_node(node_id)
            if fresh is not None:
                node.access_count = fresh.access_count
                node.last_accessed_at = fresh.last_accessed_at
                node.updated_at = fresh.updated_at
                node.metadata[self.REINFORCED_AT_KEY] = \
                    fresh.metadata.get(self.REINFORCED_AT_KEY, now)
        return len(edges)

    def should_reinforce(self, node) -> bool:
        """Throttle on the LAST REINFORCEMENT time, not last access —
        last_accessed_at resets on every hit, which would starve
        frequently-used nodes of reinforcement entirely."""
        last = float(node.metadata.get(self.REINFORCED_AT_KEY, 0.0))
        idle_days = (time.time() - last) / 86400.0
        return idle_days >= self.config.access_reinforcement_days
