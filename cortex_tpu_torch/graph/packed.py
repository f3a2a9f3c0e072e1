"""Packed adjacency: vectorized CSR over interned node rows.

The proximity tier's host-side source at scale. The object-graph
AdjacencyCache (cache.py — parity with the reference's
graph/cache.rs) materializes two AdjacencyEntry python objects per
edge: ~200M objects at the reference's 100M-edge ceiling
(ARCHITECTURE.md:313) — tens of GB of pointer-chasing heap plus
catastrophic GC, i.e. the exact structure that CAPS the reference,
reproduced worse. This module replaces it FOR PROXIMITY with three
numpy arrays (int64 indptr + int32 indices over interned rows,
undirected, deduped) built in one streaming pass over a column-only
storage scan (`Storage.edge_endpoints` — no Edge objects):

    100M edges ~= 0.8 GB resident indices + 80 MB indptr; the build
    transiently peaks at ~3.4 GB (2E int64 composite keys sorted in
    place + the deduped copy) — sort/bincount-bound numpy, no python
    loops

Rich adjacency (relations, weights, per-edge metadata) stays on the
AdjacencyCache for the graph engine / linker / briefing, which never
approach this scale per query. Hybrid proximity needs only hop
counts, so it routes here above a size threshold (csr.py).

BFS over the packed CSR is fully vectorized per hop (gather ranges
with repeat/cumsum, mask visited, unique) — the same frontier
semantics as csr._host_multi_bfs, at numpy speed and O(visited)
memory; budget overflow routes to the device frontier walk exactly
like the object-cache tier does.
"""

from __future__ import annotations

import logging
import threading
import time
from typing import Dict, List, Optional, Sequence

import numpy as np

log = logging.getLogger("cortex.packed")

UNREACHED = np.int8(127)


class PackedAdjacency:
    """Immutable undirected CSR snapshot of the edge set."""

    def __init__(self, ids: List[str], row_of: Dict[str, int],
                 indptr: np.ndarray, indices: np.ndarray,
                 edge_count: int):
        self.ids = ids                    # row -> node id
        self.row_of = row_of              # node id -> row
        self.indptr = indptr              # [n+1] int64
        self.indices = indices            # [m] int32, grouped by row
        self.edge_count = edge_count      # directed edges consumed
        self.built_at = time.monotonic()

    @property
    def n(self) -> int:
        return len(self.ids)

    # ------------------------------------------------------------- build
    @classmethod
    def build(cls, storage, chunk: int = 1_000_000) -> "PackedAdjacency":
        """One streaming pass over storage.edge_endpoints: intern ids
        chunk-wise (np.unique collapses repeats before the dict), then
        one global sort/dedup into CSR."""
        row_of: Dict[str, int] = {}
        ids: List[str] = []
        src_chunks: List[np.ndarray] = []
        dst_chunks: List[np.ndarray] = []
        edge_count = 0

        def intern(col: Sequence[str]) -> np.ndarray:
            uniq, inv = np.unique(np.asarray(col, dtype=object),
                                  return_inverse=True)
            rows = np.empty(len(uniq), np.int32)
            get = row_of.get
            for i, s in enumerate(uniq.tolist()):
                r = get(s)
                if r is None:
                    r = len(ids)
                    row_of[s] = r
                    ids.append(s)
                rows[i] = r
            return rows[inv]

        for fs, ts in storage.edge_endpoints(chunk):
            if not fs:
                continue
            edge_count += len(fs)
            src_chunks.append(intern(fs))
            dst_chunks.append(intern(ts))

        n = len(ids)
        if n == 0:
            return cls([], {}, np.zeros(1, np.int64),
                       np.zeros(0, np.int32), 0)
        # undirected: both directions; dedup via composite int64 key.
        # Fill the key array incrementally (chunks freed as consumed)
        # and sort IN PLACE with a mask dedup instead of np.unique —
        # unique's sort copy plus separate u/v concatenations peaked
        # at ~5 GB at the 100M-edge design scale; this path peaks at
        # ~2×E×8 bytes for the key plus the deduped output
        # (~3.4 GB at 100M edges, stated in the module docstring)
        total = sum(len(c) for c in src_chunks)
        key = np.empty(2 * total, np.int64)
        ofs = 0
        while src_chunks:
            s = src_chunks.pop(0)
            d = dst_chunks.pop(0)
            m = len(s)
            ks = s.astype(np.int64)
            ks *= n
            ks += d
            key[ofs:ofs + m] = ks
            kd = d.astype(np.int64)
            kd *= n
            kd += s
            key[total + ofs:total + ofs + m] = kd
            ofs += m
            del ks, kd
        key.sort()
        keep = np.empty(len(key), bool)
        keep[0] = True
        np.not_equal(key[1:], key[:-1], out=keep[1:])
        key = key[keep]
        del keep
        u = (key // n).astype(np.int32)
        v = (key % n).astype(np.int32)
        del key
        counts = np.bincount(u, minlength=n)
        indptr = np.zeros(n + 1, np.int64)
        np.cumsum(counts, out=indptr[1:])
        return cls(ids, row_of, indptr, v, edge_count)

    # --------------------------------------------------------------- BFS
    def _expand(self, frontier: np.ndarray) -> np.ndarray:
        """All neighbor rows of `frontier` (with repeats)."""
        starts = self.indptr[frontier]
        cnt = (self.indptr[frontier + 1] - starts).astype(np.int64)
        total = int(cnt.sum())
        if total == 0:
            return np.zeros(0, np.int32)
        cum = np.concatenate(([0], np.cumsum(cnt)[:-1]))
        idx = np.repeat(starts - cum, cnt) + np.arange(total)
        return self.indices[idx]

    def multi_bfs(self, src_rows: Sequence[int], hops: int,
                  budget: Optional[int] = None) -> Optional[np.ndarray]:
        """[n] int8 hop distances from any source (UNREACHED
        elsewhere); None when visited count exceeds `budget` (caller
        routes to the device tier). Vectorized per hop."""
        dist = np.full(self.n, UNREACHED, np.int8)
        if len(src_rows) == 0:
            return dist
        frontier = np.unique(np.asarray(src_rows, np.int64))
        dist[frontier] = 0
        visited = len(frontier)
        for h in range(hops):
            nb = self._expand(frontier)
            if nb.size == 0:
                break
            nb = np.unique(nb)
            nb = nb[dist[nb] == UNREACHED]
            if nb.size == 0:
                break
            dist[nb] = h + 1
            visited += nb.size
            if budget is not None and visited > budget:
                return None
            frontier = nb.astype(np.int64)
        return dist

    def neighbor_table(self, max_deg: int) -> tuple:
        """([n_pad, deg] int32 row-neighbor table (-1 pad), truncated
        hub count) — the device frontier walk's input, built without
        python loops: per-row column index = position within the CSR
        group, rows beyond max_deg dropped (hub truncation, same
        semantics as csr.DeviceGraphMirror.ensure)."""
        n = self.n
        counts = np.diff(self.indptr)
        u = np.repeat(np.arange(n, dtype=np.int64), counts)
        col = np.arange(len(self.indices), dtype=np.int64) \
            - np.repeat(self.indptr[:-1], counts)
        keep = col < max_deg
        deg = max(8, ((max_deg + 7) // 8) * 8)
        nbrs = np.full((max(n, 8), deg), -1, np.int32)
        nbrs[u[keep], col[keep]] = self.indices[keep]
        truncated = int(np.count_nonzero(counts > max_deg))
        return nbrs, truncated
