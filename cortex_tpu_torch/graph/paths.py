"""Path finding: unweighted BFS shortest, max-product Dijkstra, Yen's
k-shortest.

Parity with crates/cortex-core/src/graph/paths.rs:42-327:
  - find_paths dispatch (:42-55): max_paths==1 & no weights -> BFS;
    weighted -> Dijkstra on product-of-weights ordering (:113-200);
    max_paths>1 -> Yen's algorithm (:201-295)
  - path weight = product of edge weights (paths.rs:345+); "shortest"
    under weights = maximum product (strongest chain)

Host-side by design: per-query path graphs are small frontiers
(SURVEY §2: "DFS/weighted stay host-side — inherently sequential").
"""

from __future__ import annotations

import heapq
from typing import Dict, List, Optional, Set, Tuple

from ..storage.base import Storage
from .cache import AdjacencyCache
from .types import AdjacencyEntry, Path, PathRequest, PathResult


def _adj(cache: AdjacencyCache, nid: str, req: PathRequest
         ) -> List[AdjacencyEntry]:
    out = []
    for a in cache.outgoing(nid):
        if req.relation_filter is not None and \
                a.relation not in req.relation_filter:
            continue
        if req.min_weight is not None and a.weight < req.min_weight:
            continue
        out.append(a)
    return out


def find_paths(storage: Storage, cache: AdjacencyCache,
               req: PathRequest) -> PathResult:
    # existence/liveness BEFORE the identity short-circuit: a missing
    # or tombstoned node must not be "reachable from itself" (the
    # native fast path checks in this order — results must agree)
    for nid in (req.from_id, req.to_id):
        n = storage.get_node(nid)
        if n is None or n.deleted:
            return PathResult()
    if req.from_id == req.to_id:
        return PathResult(paths=[Path([req.from_id], [], 1.0)])
    if req.max_paths > 1:
        return PathResult(paths=_yen(cache, req))
    if req.min_weight is not None:
        p = _dijkstra(cache, req)
    else:
        p = _bfs_shortest(cache, req)
    return PathResult(paths=[p] if p else [])


def _bfs_shortest(cache: AdjacencyCache, req: PathRequest,
                  banned_nodes: Optional[Set[str]] = None,
                  banned_edges: Optional[Set[str]] = None) -> Optional[Path]:
    banned_nodes = banned_nodes or set()
    banned_edges = banned_edges or set()
    prev: Dict[str, Tuple[str, AdjacencyEntry]] = {}
    visited = {req.from_id}
    frontier = [req.from_id]
    depth = 0
    while frontier:
        if req.max_length is not None and depth >= req.max_length:
            return None
        nxt = []
        for nid in frontier:
            for a in _adj(cache, nid, req):
                if (a.neighbor in visited or a.neighbor in banned_nodes
                        or a.edge_id in banned_edges):
                    continue
                visited.add(a.neighbor)
                prev[a.neighbor] = (nid, a)
                if a.neighbor == req.to_id:
                    return _reconstruct(req, prev)
                nxt.append(a.neighbor)
        frontier = nxt
        depth += 1
    return None


def _dijkstra(cache: AdjacencyCache, req: PathRequest,
              banned_nodes: Optional[Set[str]] = None,
              banned_edges: Optional[Set[str]] = None) -> Optional[Path]:
    """Max-product path: expand by best accumulated product first."""
    banned_nodes = banned_nodes or set()
    banned_edges = banned_edges or set()
    best: Dict[str, float] = {req.from_id: 1.0}
    prev: Dict[str, Tuple[str, AdjacencyEntry]] = {}
    hops: Dict[str, int] = {req.from_id: 0}
    heap: List[Tuple[float, str]] = [(-1.0, req.from_id)]
    while heap:
        negp, nid = heapq.heappop(heap)
        p = -negp
        if p < best.get(nid, 0.0):
            continue
        if nid == req.to_id:
            return _reconstruct(req, prev, total=p)
        if req.max_length is not None and hops[nid] >= req.max_length:
            continue
        for a in _adj(cache, nid, req):
            if a.neighbor in banned_nodes or a.edge_id in banned_edges:
                continue
            cand = p * a.weight
            if cand > best.get(a.neighbor, 0.0):
                best[a.neighbor] = cand
                prev[a.neighbor] = (nid, a)
                hops[a.neighbor] = hops[nid] + 1
                heapq.heappush(heap, (-cand, a.neighbor))
    return None


def _reconstruct(req: PathRequest, prev: Dict[str, Tuple[str, AdjacencyEntry]],
                 total: Optional[float] = None) -> Path:
    nodes = [req.to_id]
    edges: List[str] = []
    weight = 1.0
    cur = req.to_id
    while cur != req.from_id:
        parent, a = prev[cur]
        edges.append(a.edge_id)
        weight *= a.weight
        nodes.append(parent)
        cur = parent
    nodes.reverse()
    edges.reverse()
    return Path(nodes=nodes, edges=edges,
                total_weight=total if total is not None else weight)


def _shortest(cache: AdjacencyCache, req: PathRequest,
              banned_nodes: Set[str], banned_edges: Set[str]
              ) -> Optional[Path]:
    if req.min_weight is not None:
        return _dijkstra(cache, req, banned_nodes, banned_edges)
    return _bfs_shortest(cache, req, banned_nodes, banned_edges)


def _yen(cache: AdjacencyCache, req: PathRequest) -> List[Path]:
    """Yen's k-shortest loopless paths (paths.rs:201-295)."""
    first = _shortest(cache, req, set(), set())
    if first is None:
        return []
    found = [first]
    # candidate ordering must match the dispatch's notion of "shortest":
    # hop count for unweighted queries, max product for weighted ones
    # ("shortest under weights = maximum product", _dijkstra above)
    weighted = req.min_weight is not None

    def key(edges_len: int, w: float):
        return (-w, edges_len) if weighted else (edges_len, -w)

    candidates: List[Tuple] = []
    seen_paths = {tuple(first.nodes)}
    while len(found) < req.max_paths:
        base = found[-1]
        for i in range(len(base.nodes) - 1):
            spur = base.nodes[i]
            root_nodes = base.nodes[:i + 1]
            root_edges = base.edges[:i]
            banned_edges: Set[str] = set()
            for p in found:
                if p.nodes[:i + 1] == root_nodes and len(p.edges) > i:
                    banned_edges.add(p.edges[i])
            banned_nodes = set(root_nodes[:-1])
            spur_req = PathRequest(
                from_id=spur, to_id=req.to_id,
                max_length=(None if req.max_length is None
                            else req.max_length - i),
                relation_filter=req.relation_filter,
                min_weight=req.min_weight, max_paths=1)
            sp = _shortest(cache, spur_req, banned_nodes, banned_edges)
            if sp is None:
                continue
            nodes = root_nodes + sp.nodes[1:]
            if tuple(nodes) in seen_paths:
                continue
            edges = root_edges + sp.edges
            w = _product(cache, nodes, edges)
            seen_paths.add(tuple(nodes))
            k1, k2 = key(len(edges), w)
            heapq.heappush(candidates,
                           (k1, k2, id(nodes), Path(nodes, edges, w)))
        if not candidates:
            break
        _, _, _, best = heapq.heappop(candidates)
        found.append(best)
    return found


def _product(cache: AdjacencyCache, nodes: List[str],
             edges: List[str]) -> float:
    w = 1.0
    for i, eid in enumerate(edges):
        for a in cache.outgoing(nodes[i]):
            if a.edge_id == eid:
                w *= a.weight
                break
    return w
