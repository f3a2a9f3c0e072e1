"""BFS / DFS / weighted traversal over Storage with budget enforcement.

Behavioral parity with crates/cortex-core/src/graph/traversal.rs:43-467:
  - dispatch by strategy (:43-53)
  - BFS with budget checks (:75-82), per-level circuit breaker (:132-137),
    and a post-pass keeping only edges whose both endpoints were returned
    (:180-186)
  - DFS (:190+), weighted greedy best-first by edge weight (:318+)
  - kind_filter excludes nodes from the *result* but traversal continues
    through them (types.rs:22 note)
  - deleted nodes are not traversed
"""

from __future__ import annotations

import heapq
import time
from typing import Dict, List, Optional, Set, Tuple

from ..storage.base import Storage
from ..types import Edge
from .cache import AdjacencyCache
from .subgraph import Subgraph
from .types import (BFS, BOTH, DFS, INCOMING, OUTGOING, WEIGHTED,
                    AdjacencyEntry, TraversalBudget, TraversalRequest)


def _neighbors(cache: AdjacencyCache, node_id: str, req: TraversalRequest
               ) -> List[AdjacencyEntry]:
    entries: List[AdjacencyEntry] = []
    if req.direction in (OUTGOING, BOTH):
        entries.extend(cache.outgoing(node_id))
    if req.direction in (INCOMING, BOTH):
        entries.extend(cache.incoming(node_id))
    out = []
    for a in entries:
        if req.relation_filter is not None and \
                a.relation not in req.relation_filter:
            continue
        if req.min_weight is not None and a.weight < req.min_weight:
            continue
        if req.created_after is not None and a.created_at < req.created_after:
            continue
        out.append(a)
    return out


class _Collector:
    """Shared result assembly: node hydration, kind filter, edge post-pass."""

    def __init__(self, storage: Storage, req: TraversalRequest,
                 budget: TraversalBudget):
        self.storage = storage
        self.req = req
        self.budget = budget
        self.sub = Subgraph()
        self.t0 = time.monotonic()
        self.included: Set[str] = set()
        self.edge_ids: Set[str] = set()

    def over_time(self) -> bool:
        return (time.monotonic() - self.t0) * 1000 > self.budget.max_time_ms

    def over_visited(self) -> bool:
        return self.sub.visited_count >= self.budget.max_visited

    def over_limit(self) -> bool:
        return (self.req.limit is not None
                and len(self.included) >= self.req.limit)

    def try_include(self, node_id: str, depth: int
                    ) -> "tuple[bool, bool]":
        """Hydrate + include node in results (subject to kind filter/
        limit). Returns (keep_going, expand): keep_going is False when
        the limit is hit; expand is False for missing/soft-deleted
        nodes — a tombstone must not be traversed THROUGH (the module
        invariant is 'deleted nodes are not traversed', and expanding
        one surfaces its neighbors with no connecting edge in the
        result). Kind-filtered nodes stay pass-through: the filter
        shapes the RESULT set, not the walk (traversal.rs)."""
        if node_id in self.included:
            return True, True
        if self.over_limit():
            self.sub.truncated = True
            return False, False
        node = self.storage.get_node(node_id)
        if node is None or node.deleted:
            return True, False
        if self.req.kind_filter is not None and \
                node.kind not in self.req.kind_filter:
            self.sub.depths.setdefault(node_id, depth)
            return True, True
        self.sub.nodes[node_id] = node
        self.sub.depths[node_id] = min(
            self.sub.depths.get(node_id, depth), depth)
        self.included.add(node_id)
        return True, True

    def finish(self, cache: AdjacencyCache) -> Subgraph:
        """Edge post-pass: keep edges with both endpoints in the result
        (traversal.rs:180-186)."""
        for nid in self.included:
            for a in cache.outgoing(nid):
                if a.neighbor in self.included and a.edge_id not in self.edge_ids:
                    e = self.storage.get_edge(a.edge_id)
                    if e is not None:
                        self.sub.edges.append(e)
                        self.edge_ids.add(a.edge_id)
        return self.sub


def traverse(storage: Storage, cache: AdjacencyCache, req: TraversalRequest,
             budget: Optional[TraversalBudget] = None) -> Subgraph:
    budget = budget or TraversalBudget()
    if req.strategy == BFS:
        return _bfs(storage, cache, req, budget)
    if req.strategy == DFS:
        return _dfs(storage, cache, req, budget)
    if req.strategy == WEIGHTED:
        return _weighted(storage, cache, req, budget)
    raise ValueError(f"unknown strategy {req.strategy!r}")


def _seed(col: _Collector, req: TraversalRequest) -> List[str]:
    starts = []
    for s in req.start:
        n = col.storage.get_node(s)
        if n is None or n.deleted:
            continue
        starts.append(s)
        col.sub.visited_count += 1
        if req.include_start:
            col.try_include(s, 0)
        else:
            col.sub.depths.setdefault(s, 0)
    return starts


def _bfs(storage: Storage, cache: AdjacencyCache, req: TraversalRequest,
         budget: TraversalBudget) -> Subgraph:
    col = _Collector(storage, req, budget)
    frontier = _seed(col, req)
    visited: Set[str] = set(frontier)
    depth = 0
    while frontier:
        if req.max_depth is not None and depth >= req.max_depth:
            break
        if col.over_time() or col.over_visited():
            col.sub.truncated = True
            break
        nxt: List[str] = []
        for nid in frontier:
            for a in _neighbors(cache, nid, req):
                if a.neighbor in visited:
                    continue
                if col.over_visited() or col.over_limit():
                    col.sub.truncated = True
                    break
                visited.add(a.neighbor)
                col.sub.visited_count += 1
                go, expand = col.try_include(a.neighbor, depth + 1)
                if not go:
                    break
                if expand:
                    nxt.append(a.neighbor)
                if len(nxt) >= budget.max_nodes_per_level:
                    # circuit breaker (traversal.rs:132-137)
                    col.sub.truncated = True
                    break
            if col.sub.truncated:
                break
        if col.sub.truncated:
            frontier = nxt
            break
        frontier = nxt
        depth += 1
    return col.finish(cache)


def _dfs(storage: Storage, cache: AdjacencyCache, req: TraversalRequest,
         budget: TraversalBudget) -> Subgraph:
    col = _Collector(storage, req, budget)
    starts = _seed(col, req)
    visited: Set[str] = set(starts)
    stack: List[Tuple[str, int]] = [(s, 0) for s in reversed(starts)]
    while stack:
        if col.over_time() or col.over_visited() or col.over_limit():
            col.sub.truncated = True
            break
        nid, depth = stack.pop()
        if req.max_depth is not None and depth >= req.max_depth:
            continue
        for a in reversed(_neighbors(cache, nid, req)):
            if a.neighbor in visited:
                continue
            visited.add(a.neighbor)
            col.sub.visited_count += 1
            go, expand = col.try_include(a.neighbor, depth + 1)
            if not go:
                break
            if expand:
                stack.append((a.neighbor, depth + 1))
    return col.finish(cache)


def _weighted(storage: Storage, cache: AdjacencyCache, req: TraversalRequest,
              budget: TraversalBudget) -> Subgraph:
    """Greedy best-first: highest edge weight expanded first
    (traversal.rs:318+)."""
    col = _Collector(storage, req, budget)
    starts = _seed(col, req)
    visited: Set[str] = set(starts)
    heap: List[Tuple[float, int, str]] = []     # (-weight, depth, node)
    for s in starts:
        for a in _neighbors(cache, s, req):
            if a.neighbor not in visited:
                visited.add(a.neighbor)
                heapq.heappush(heap, (-a.weight, 1, a.neighbor))
    while heap:
        if col.over_time() or col.over_visited() or col.over_limit():
            col.sub.truncated = True
            break
        negw, depth, nid = heapq.heappop(heap)
        col.sub.visited_count += 1
        go, expand = col.try_include(nid, depth)   # pop (weight) order
        if not go:
            break
        if not expand:
            continue
        if req.max_depth is not None and depth >= req.max_depth:
            continue
        for a in _neighbors(cache, nid, req):
            if a.neighbor in visited:
                continue
            visited.add(a.neighbor)
            heapq.heappush(heap, (-a.weight, depth + 1, a.neighbor))
    return col.finish(cache)
