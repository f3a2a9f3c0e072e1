"""Temporal graph queries (crates/cortex-core/src/graph/temporal.rs:38-144):
changed_since, neighborhood_at (graph state as of time T), timeline."""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional

from ..storage.base import NodeFilter, Storage
from ..types import Edge, Node
from .cache import AdjacencyCache
from .subgraph import Subgraph


def changed_since(storage: Storage, since: float,
                  limit: Optional[int] = None) -> List[Node]:
    out = [n for n in storage.list_nodes(NodeFilter(include_deleted=True))
           if n.updated_at >= since]
    out.sort(key=lambda n: n.updated_at, reverse=True)
    return out[:limit] if limit else out


def neighborhood_at(storage: Storage, cache: AdjacencyCache, node_id: str,
                    at_time: float, depth: int = 1) -> Subgraph:
    """BFS over edges that existed at `at_time`, returning nodes created
    by then (soft-deleted nodes included if created before the cut)."""
    sub = Subgraph()
    center = storage.get_node(node_id)
    if center is None or center.created_at > at_time:
        return sub
    sub.nodes[node_id] = center
    sub.depths[node_id] = 0
    frontier = [node_id]
    seen = {node_id}
    for d in range(depth):
        nxt = []
        for nid in frontier:
            for a in (cache.outgoing(nid) + cache.incoming(nid)):
                if a.created_at > at_time or a.neighbor in seen:
                    continue
                n = storage.get_node(a.neighbor)
                if n is None or n.created_at > at_time:
                    continue
                seen.add(a.neighbor)
                sub.nodes[a.neighbor] = n
                sub.depths[a.neighbor] = d + 1
                e = storage.get_edge(a.edge_id)
                if e is not None:
                    sub.edges.append(e)
                nxt.append(a.neighbor)
        frontier = nxt
    sub.visited_count = len(seen)
    return sub


@dataclass
class TimelineEntry:
    ts: float
    event: str          # "node_created" | "node_updated" | "edge_created"
    target_id: str
    title: Optional[str] = None


def timeline(storage: Storage, node_id: str,
             limit: int = 100) -> List[TimelineEntry]:
    """Chronological activity around one node."""
    out: List[TimelineEntry] = []
    n = storage.get_node(node_id)
    if n is None:
        return out
    out.append(TimelineEntry(ts=n.created_at, event="node_created",
                             target_id=n.id, title=n.title))
    if n.updated_at > n.created_at:
        out.append(TimelineEntry(ts=n.updated_at, event="node_updated",
                                 target_id=n.id, title=n.title))
    for e in storage.edges_from(node_id) + storage.edges_to(node_id):
        out.append(TimelineEntry(ts=e.created_at, event="edge_created",
                                 target_id=e.id, title=e.relation))
    out.sort(key=lambda t: t.ts)
    # keep the NEWEST `limit` entries (an activity timeline is queried
    # for recent activity), presented chronologically — [:limit] kept
    # the oldest and silently dropped everything recent
    return out[-limit:] if limit else out
