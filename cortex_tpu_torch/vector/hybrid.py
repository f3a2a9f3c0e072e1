"""Hybrid search: vector similarity x graph proximity.

Behavioral parity with crates/cortex-core/src/vector/hybrid.rs:95-225:
  - HybridQuery{query_text, anchors, vector_weight=0.7, limit=10,
    kind_filter, max_anchor_depth=3}
  - vector search over-fetches limit*3 (:125)
  - no anchors -> pure vector results
  - graph score = 1/(1+depth), best (nearest) anchor kept (:189-225)
  - combined = w*vec + (1-w)*graph (:163-164); sort desc, truncate

The port's copy of cortex_tpu/vector/hybrid.py. The vector leg is the
index's device search (`search_batch_async` of the flat or IVF index),
and anchor proximity routes by frontier size (graph/csr.py): a frontier
BFS over the host adjacency when the anchor neighborhood is small (cost
~ deg^hops, independent of N), falling back to the device tiers (the
frontier walk, then the min-plus relaxation over the device adjacency
table) when the frontier covers a large fraction of the graph. The
vector search is enqueued before the proximity pass and fetched after
it, so the two overlap either way.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional, Tuple

import numpy as np

from ..graph.csr import DeviceGraphMirror
from ..storage.base import Storage
from ..types import Node
from .embedding import EmbeddingService
from .index import TorchFlatIndex, VectorFilter


@dataclass
class HybridQuery:
    query_text: str
    anchors: List[str] = field(default_factory=list)
    vector_weight: float = 0.7
    limit: int = 10
    kind_filter: Optional[List[str]] = None
    max_anchor_depth: int = 3


@dataclass
class HybridResult:
    node: Node
    vector_score: float
    graph_score: float
    combined_score: float
    nearest_anchor: Optional[Tuple[str, int]] = None   # (anchor_id, depth)


class HybridSearch:
    def __init__(self, storage: Storage, embedder: EmbeddingService,
                 index: TorchFlatIndex, mirror: DeviceGraphMirror):
        self.storage = storage
        self.embedder = embedder
        self.index = index
        self.mirror = mirror

    def search(self, query: HybridQuery) -> List[HybridResult]:
        emb = self.embedder.embed(query.query_text)
        flt = VectorFilter(kinds=query.kind_filter) \
            if query.kind_filter else None
        k = max(query.limit * 3, 1)

        if not query.anchors:
            hits = self.index.search(emb, k, flt)
            out = []
            for nid, score in hits:
                # hydrate BEFORE truncating, and skip tombstones: a
                # search dispatched just before a delete can return the
                # deleted id (the plain-search path guards the same
                # race in Cortex.finish_search) — truncating first
                # would also shrink the result below `limit` despite
                # the 3x overfetch
                node = self.storage.get_node(nid)
                if node is None or node.deleted:
                    continue
                out.append(HybridResult(node=node, vector_score=score,
                                        graph_score=0.0,
                                        combined_score=score))
                if len(out) >= query.limit:
                    break
            return out

        # overlap the two legs: enqueue the device search WITHOUT
        # fetching, run the anchor BFS on the host while the device
        # works, then collect
        fetch = self.index.search_batch_async(emb[None, :], k, flt)
        # one call resolves ONE adjacency snapshot and returns both
        # the anchor column order and the depth arrays — resolving
        # them separately can straddle a background packed-snapshot
        # swap, misaligning anchors[j] with the depth columns
        # (ADVICE r4: IndexError / wrong nearest_anchor)
        anchors, depth_map = self.mirror.per_anchor(
            query.anchors, query.max_anchor_depth)
        hits = fetch()[0]

        results: List[HybridResult] = []
        w = query.vector_weight
        for nid, vscore in hits:
            node = self.storage.get_node(nid)
            if node is None or node.deleted:   # delete-race tombstone
                continue
            gscore = 0.0
            nearest: Optional[Tuple[str, int]] = None
            per = depth_map.get(nid)
            if per is not None and anchors:
                j = int(np.argmin(per))
                d = int(per[j])
                if d <= query.max_anchor_depth:
                    gscore = 1.0 / (1.0 + d)
                    nearest = (anchors[j], d)
            if nid in query.anchors and gscore < 1.0:
                # an anchor is depth 0 from itself even when it has no
                # edges (reference BFS visits the start node;
                # hybrid.rs:189-225) — edge-less anchors are absent from
                # the device mirror, so handle them here
                gscore = 1.0
                nearest = (nid, 0)
            results.append(HybridResult(
                node=node, vector_score=vscore, graph_score=gscore,
                combined_score=w * vscore + (1.0 - w) * gscore,
                nearest_anchor=nearest))
        results.sort(key=lambda r: -r.combined_score)
        return results[:query.limit]
