from .cache import AdjacencyCache
from .csr import DeviceGraphMirror
from .engine import GraphEngine
from .subgraph import Subgraph
from .types import (BFS, BOTH, DFS, INCOMING, OUTGOING, WEIGHTED,
                    AdjacencyEntry, NeighborhoodNode, Path, PathRequest,
                    PathResult, TraversalBudget, TraversalRequest)

__all__ = [
    "AdjacencyCache", "DeviceGraphMirror", "GraphEngine", "Subgraph",
    "BFS", "BOTH", "DFS", "INCOMING", "OUTGOING", "WEIGHTED",
    "AdjacencyEntry", "NeighborhoodNode", "Path", "PathRequest", "PathResult",
    "TraversalBudget", "TraversalRequest",
]
