"""Host CSR snapshot of the graph, for the native C++ kernels.

Builds directed (out), reverse (in), and undirected CSR arrays from
the AdjacencyCache, versioned against it the same way the device
mirror is (graph/csr.py). Rows cover every node id that appears in at
least one edge; isolated nodes are the caller's concern (singleton
components, unreachable, etc.).
"""

from __future__ import annotations

import threading
from typing import Dict, List, Optional, Tuple

import numpy as np

from .cache import AdjacencyCache


class HostCSR:
    def __init__(self, cache: AdjacencyCache):
        self._cache = cache
        self._built_version = -1
        self._lock = threading.Lock()
        self.ids: List[str] = []
        self.row_of: Dict[str, int] = {}
        # directed out
        self.indptr = np.zeros(1, np.int32)
        self.indices = np.zeros(0, np.int32)
        self.weights = np.zeros(0, np.float32)
        self.edge_ids: List[str] = []
        # undirected (both directions folded in)
        self.u_indptr = np.zeros(1, np.int32)
        self.u_indices = np.zeros(0, np.int32)

    def ensure(self) -> "HostCSR":
        with self._lock:
            v = self._cache.version
            if self._built_version == v:
                return self
            self._build()
            # stamp with the version read BEFORE building: if a write
            # bumped the cache mid-build, the next ensure() must rebuild
            # rather than serve this possibly-mixed snapshot forever
            self._built_version = v
            return self

    def _build(self) -> None:
        cache = self._cache
        ids = sorted(cache.all_node_ids())
        row_of = {nid: r for r, nid in enumerate(ids)}
        n = len(ids)
        out_adj: List[List[Tuple[int, float, str]]] = [[] for _ in range(n)]
        und_adj: List[List[int]] = [[] for _ in range(n)]
        for nid in ids:
            u = row_of[nid]
            for a in cache.outgoing(nid):
                v = row_of.get(a.neighbor)
                if v is None:
                    continue
                out_adj[u].append((v, a.weight, a.edge_id))
                und_adj[u].append(v)
                und_adj[v].append(u)
        indptr = np.zeros(n + 1, np.int32)
        m = sum(len(a) for a in out_adj)
        indices = np.zeros(m, np.int32)
        weights = np.zeros(m, np.float32)
        edge_ids: List[str] = [""] * m
        pos = 0
        for u in range(n):
            indptr[u] = pos
            for v, w, eid in out_adj[u]:
                indices[pos] = v
                weights[pos] = w
                edge_ids[pos] = eid
                pos += 1
        indptr[n] = pos
        u_indptr = np.zeros(n + 1, np.int32)
        um = sum(len(a) for a in und_adj)
        u_indices = np.zeros(um, np.int32)
        pos = 0
        for u in range(n):
            u_indptr[u] = pos
            for v in und_adj[u]:
                u_indices[pos] = v
                pos += 1
        u_indptr[n] = pos

        self.ids, self.row_of = ids, row_of
        self.indptr, self.indices = indptr, indices
        self.weights, self.edge_ids = weights, edge_ids
        self.u_indptr, self.u_indices = u_indptr, u_indices

    # ----------------------------------------------------------- lookups
    def edge_between(self, u: int, v: int) -> Optional[Tuple[str, float]]:
        """Highest-weight directed edge u->v: (edge_id, weight)."""
        best: Optional[Tuple[str, float]] = None
        for e in range(self.indptr[u], self.indptr[u + 1]):
            if self.indices[e] == v:
                if best is None or self.weights[e] > best[1]:
                    best = (self.edge_ids[e], float(self.weights[e]))
        return best
