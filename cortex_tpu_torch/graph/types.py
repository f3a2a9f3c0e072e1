"""Graph traversal request/result types.

Parity with crates/cortex-core/src/graph/types.rs: TraversalRequest
(:6-57), directions/strategies (:60-88), PathRequest (:90-120), Path
(:130-157), TraversalBudget (:160-180 — 10k visited / 5s / 1k per level).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional

OUTGOING = "outgoing"
INCOMING = "incoming"
BOTH = "both"

BFS = "bfs"
DFS = "dfs"
WEIGHTED = "weighted"


@dataclass
class TraversalRequest:
    start: List[str] = field(default_factory=list)
    max_depth: Optional[int] = 3
    direction: str = OUTGOING
    relation_filter: Optional[List[str]] = None
    kind_filter: Optional[List[str]] = None     # filters results, not traversal
    min_weight: Optional[float] = None
    limit: Optional[int] = None
    strategy: str = BFS
    include_start: bool = True
    created_after: Optional[float] = None


@dataclass
class PathRequest:
    from_id: str = ""
    to_id: str = ""
    max_length: Optional[int] = None
    relation_filter: Optional[List[str]] = None
    min_weight: Optional[float] = None
    max_paths: int = 1


@dataclass
class Path:
    nodes: List[str]
    edges: List[str]
    total_weight: float     # product of edge weights

    @property
    def length(self) -> int:
        return len(self.edges)


@dataclass
class PathResult:
    paths: List[Path] = field(default_factory=list)


@dataclass
class TraversalBudget:
    max_visited: int = 10_000
    max_time_ms: int = 5_000
    max_nodes_per_level: int = 1_000


@dataclass
class NeighborhoodNode:
    """A node plus its depth from the center (engine.neighborhood)."""

    node_id: str
    depth: int


@dataclass
class AdjacencyEntry:
    """One cached adjacency record (graph/cache.rs:10-30)."""

    edge_id: str
    neighbor: str
    relation: str
    weight: float
    created_at: float = 0.0
