"""Traversal result container (crates/cortex-core/src/graph/subgraph.rs:6-165)."""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional

from ..types import Edge, Node


@dataclass
class Subgraph:
    nodes: Dict[str, Node] = field(default_factory=dict)
    edges: List[Edge] = field(default_factory=list)
    depths: Dict[str, int] = field(default_factory=dict)
    visited_count: int = 0
    truncated: bool = False

    def __len__(self) -> int:
        return len(self.nodes)

    def at_depth(self, depth: int) -> List[Node]:
        return [self.nodes[i] for i, d in self.depths.items()
                if d == depth and i in self.nodes]

    def edges_between(self, a: str, b: str) -> List[Edge]:
        return [e for e in self.edges
                if (e.from_id == a and e.to_id == b)
                or (e.from_id == b and e.to_id == a)]

    def neighbors(self, node_id: str) -> List[str]:
        out = set()
        for e in self.edges:
            if e.from_id == node_id:
                out.add(e.to_id)
            elif e.to_id == node_id:
                out.add(e.from_id)
        return sorted(out)

    def topo_sort(self) -> Optional[List[str]]:
        """Kahn's algorithm over contained edges; None when cyclic."""
        indeg = {i: 0 for i in self.nodes}
        adj: Dict[str, List[str]] = {i: [] for i in self.nodes}
        for e in self.edges:
            if e.from_id in self.nodes and e.to_id in self.nodes:
                adj[e.from_id].append(e.to_id)
                indeg[e.to_id] += 1
        queue = sorted([i for i, d in indeg.items() if d == 0])
        order: List[str] = []
        while queue:
            n = queue.pop(0)
            order.append(n)
            for m in adj[n]:
                indeg[m] -= 1
                if indeg[m] == 0:
                    queue.append(m)
        return order if len(order) == len(self.nodes) else None

    def merge(self, other: "Subgraph") -> "Subgraph":
        out = Subgraph(
            nodes={**self.nodes, **other.nodes},
            edges=list(self.edges),
            depths=dict(self.depths),
            visited_count=self.visited_count + other.visited_count,
            truncated=self.truncated or other.truncated,
        )
        seen = {e.id for e in out.edges}
        for e in other.edges:
            if e.id not in seen:
                out.edges.append(e)
        for i, d in other.depths.items():
            out.depths[i] = min(out.depths.get(i, d), d)
        return out
