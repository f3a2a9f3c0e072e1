"""Adjacency cache: in-memory full adjacency with invalidate-on-write.

Role parity: crates/cortex-core/src/graph/cache.rs:10-146 (the ~10x
repeated-traversal speedup, ARCHITECTURE.md:66). Here it is also the
*source* for the device CSR build (cortex_tpu.graph.csr) — the cache
version doubles as the CSR version so device mirrors know when to
rebuild (SURVEY §2: "versioned like the cache validity flag").
"""

from __future__ import annotations

import threading
from typing import Dict, List, Optional

from ..storage.base import Storage
from .types import AdjacencyEntry


class AdjacencyCache:
    def __init__(self, storage: Storage):
        self._storage = storage
        self._out: Dict[str, List[AdjacencyEntry]] = {}
        self._in: Dict[str, List[AdjacencyEntry]] = {}
        self._valid = False
        self._version = 0
        self._lock = threading.RLock()

    @property
    def version(self) -> int:
        return self._version

    def invalidate(self) -> None:
        with self._lock:
            self._valid = False
            self._version += 1

    def _ensure(self) -> None:
        if self._valid:
            return
        with self._lock:
            if self._valid:
                return
            out: Dict[str, List[AdjacencyEntry]] = {}
            inc: Dict[str, List[AdjacencyEntry]] = {}
            for e in self._storage.all_edges():
                out.setdefault(e.from_id, []).append(AdjacencyEntry(
                    edge_id=e.id, neighbor=e.to_id, relation=e.relation,
                    weight=e.weight, created_at=e.created_at))
                inc.setdefault(e.to_id, []).append(AdjacencyEntry(
                    edge_id=e.id, neighbor=e.from_id, relation=e.relation,
                    weight=e.weight, created_at=e.created_at))
            self._out = out
            self._in = inc
            self._valid = True

    def outgoing(self, node_id: str) -> List[AdjacencyEntry]:
        self._ensure()
        return self._out.get(node_id, [])

    def incoming(self, node_id: str) -> List[AdjacencyEntry]:
        self._ensure()
        return self._in.get(node_id, [])

    def all_node_ids(self) -> List[str]:
        self._ensure()
        return list({*self._out.keys(), *self._in.keys()})

    def degree(self, node_id: str) -> int:
        self._ensure()
        return (len(self._out.get(node_id, []))
                + len(self._in.get(node_id, [])))
