"""GraphEngine: traversal dispatch, path finding, analytics.

Parity surface: the reference `GraphEngine` trait
(crates/cortex-core/src/graph/engine.rs:12-52): traverse / find_paths /
neighbors / neighborhood / reachable / roots / leaves / find_cycles /
components / most_connected, with cycle DFS (:371-401) and component BFS
(:404-436). Backed by the AdjacencyCache; analytics run on host over the
cached adjacency (small per-query frontiers), while bulk proximity
scoring for hybrid search runs on device via graph/csr.py.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Set, Tuple

import numpy as np

from ..storage.base import NodeFilter, Storage
from .. import native
from .cache import AdjacencyCache
from .host_csr import HostCSR
from .paths import Path, find_paths as _find_paths
from .subgraph import Subgraph
from .traversal import traverse as _traverse
from .types import (BOTH, INCOMING, OUTGOING, NeighborhoodNode, PathRequest,
                    PathResult, TraversalBudget, TraversalRequest)


class GraphEngine:
    def __init__(self, storage: Storage,
                 budget: Optional[TraversalBudget] = None):
        self.storage = storage
        self.cache = AdjacencyCache(storage)
        self.budget = budget or TraversalBudget()
        self._csr = HostCSR(self.cache)

    # -- write-path hook ---------------------------------------------------
    def invalidate(self) -> None:
        self.cache.invalidate()

    # -- core queries ------------------------------------------------------
    def traverse(self, req: TraversalRequest) -> Subgraph:
        return _traverse(self.storage, self.cache, req, self.budget)

    def find_paths(self, req: PathRequest) -> PathResult:
        native_result = self._find_paths_native(req)
        if native_result is not None:
            return native_result
        return _find_paths(self.storage, self.cache, req)

    def _find_paths_native(self, req: PathRequest) -> Optional[PathResult]:
        """C++ fast path for the unfiltered single-path queries (the
        common case); filtered / k-shortest queries take the Python
        implementation with its per-edge predicates."""
        if (req.max_paths != 1 or req.relation_filter is not None
                # min_weight prunes edges below the floor, which the
                # CSR doesn't encode — bail BEFORE the O(V+E)
                # csr.ensure() below, not after
                or req.min_weight is not None
                or not native.available()):
            return None
        for nid in (req.from_id, req.to_id):
            n = self.storage.get_node(nid)
            if n is None or n.deleted:
                return PathResult()
        if req.from_id == req.to_id:
            return PathResult(paths=[Path([req.from_id], [], 1.0)])
        csr = self._csr.ensure()
        src = csr.row_of.get(req.from_id)
        dst = csr.row_of.get(req.to_id)
        if src is None or dst is None:
            return PathResult()
        out = native.bfs_depths(
            csr.indptr, csr.indices, np.array([src], np.int32),
            # explicit None check: max_length=0 is a real bound (the
            # Python leg returns no paths for it), `or -1` treated it
            # as UNBOUNDED
            max_depth=(-1 if req.max_length is None
                       else req.max_length),
            want_parents=True)
        if out is None:
            return None
        depths, _, parents = out
        if depths[dst] < 0:
            return PathResult()
        rows = [dst]
        while rows[-1] != src:
            rows.append(int(parents[rows[-1]]))
        rows.reverse()
        edges, weight = [], 1.0
        for u, v in zip(rows, rows[1:]):
            e = csr.edge_between(u, v)
            if e is None:
                return None     # cache changed underfoot; python path
            edges.append(e[0])
            weight *= e[1]
        return PathResult(paths=[Path([csr.ids[r] for r in rows], edges,
                                      weight)])

    def neighbors(self, node_id: str, direction: str = BOTH) -> List[str]:
        out: Set[str] = set()
        if direction in (OUTGOING, BOTH):
            out.update(a.neighbor for a in self.cache.outgoing(node_id))
        if direction in (INCOMING, BOTH):
            out.update(a.neighbor for a in self.cache.incoming(node_id))
        return sorted(out)

    def neighborhood(self, node_id: str, depth: int = 1,
                     direction: str = BOTH) -> List[NeighborhoodNode]:
        sub = self.traverse(TraversalRequest(
            start=[node_id], max_depth=depth, direction=direction,
            include_start=False))
        return [NeighborhoodNode(node_id=i, depth=d)
                for i, d in sorted(sub.depths.items(), key=lambda x: (x[1], x[0]))
                if i != node_id]

    def reachable(self, from_id: str, to_id: str,
                  max_depth: Optional[int] = None) -> bool:
        req = PathRequest(from_id=from_id, to_id=to_id, max_length=max_depth)
        return bool(self.find_paths(req).paths)

    def roots(self) -> List[str]:
        """Live nodes with no incoming edges."""
        return [n.id for n in self.storage.list_nodes(NodeFilter())
                if not self.cache.incoming(n.id)]

    def leaves(self) -> List[str]:
        """Live nodes with no outgoing edges."""
        return [n.id for n in self.storage.list_nodes(NodeFilter())
                if not self.cache.outgoing(n.id)]

    def most_connected(self, limit: int = 10) -> List[Tuple[str, int]]:
        degrees = [(n.id, self.cache.degree(n.id))
                   for n in self.storage.list_nodes(NodeFilter())]
        degrees.sort(key=lambda x: (-x[1], x[0]))
        return degrees[:limit]

    def find_cycles(self, max_cycles: int = 100) -> List[List[str]]:
        """Directed cycles via colored DFS (engine.rs:371-401),
        iterative — deep chains must not hit Python's recursion limit."""
        WHITE, GRAY, BLACK = 0, 1, 2
        color: Dict[str, int] = {}
        cycles: List[List[str]] = []

        ids = [n.id for n in self.storage.list_nodes(NodeFilter())]
        for nid in ids:
            color.setdefault(nid, WHITE)

        for start in ids:
            if color[start] != WHITE or len(cycles) >= max_cycles:
                continue
            # stack holds (node, iterator over its outgoing neighbors)
            path: List[str] = [start]
            color[start] = GRAY
            stack = [(start, iter(self.cache.outgoing(start)))]
            while stack and len(cycles) < max_cycles:
                u, it = stack[-1]
                adv = next(it, None)
                if adv is None:
                    stack.pop()
                    path.pop()
                    color[u] = BLACK
                    continue
                v = adv.neighbor
                c = color.get(v, WHITE)
                if c == GRAY:
                    try:
                        i = path.index(v)
                        cycles.append(path[i:] + [v])
                    except ValueError:
                        pass
                elif c == WHITE and v in color:
                    color[v] = GRAY
                    path.append(v)
                    stack.append((v, iter(self.cache.outgoing(v))))
        return cycles

    def components(self) -> List[List[str]]:
        """Weakly-connected components (engine.rs:404-436). Native C++
        labeling over the undirected CSR when available; isolated
        nodes become singleton components either way. LIVE nodes only,
        on BOTH legs: the CSR is built from edges, whose endpoints can
        be tombstones (soft delete keeps edges) — the native leg used
        to return components made of deleted nodes while the Python
        leg omitted them, and both leaked deleted ids into mixed
        components (find_cycles already excludes deleted)."""
        live = {n.id for n in self.storage.list_nodes(NodeFilter())}
        if native.available():
            csr = self._csr.ensure()
            labels = native.components_native(csr.u_indptr, csr.u_indices)
            if labels is not None:
                groups: Dict[int, List[str]] = {}
                for r, lbl in enumerate(labels):
                    if csr.ids[r] in live:
                        groups.setdefault(int(lbl), []).append(csr.ids[r])
                comps = [sorted(g) for g in groups.values() if g]
                in_edge = set(csr.row_of)
                comps.extend([nid] for nid in live if nid not in in_edge)
                comps.sort(key=len, reverse=True)
                return comps
        seen: Set[str] = set()
        comps: List[List[str]] = []
        for nid in sorted(live):
            if nid in seen:
                continue
            comp = []
            frontier = [nid]
            seen.add(nid)
            while frontier:
                cur = frontier.pop()
                comp.append(cur)
                for a in (self.cache.outgoing(cur) + self.cache.incoming(cur)):
                    if a.neighbor not in seen and a.neighbor in live:
                        seen.add(a.neighbor)
                        frontier.append(a.neighbor)
            comps.append(sorted(comp))
        comps.sort(key=len, reverse=True)
        return comps
