"""Dedup scanner: batched all-pairs high-similarity scan + merge policy.

Behavioral parity with crates/cortex-core/src/linker/dedup.rs:42-280:
  - scan: pairs with similarity >= dedup_threshold (default 0.92),
    deduplicated via sorted-pair set
  - action policy (:130-177): Merge when one side has 2x connections or
    |importance delta| > 0.3 (keep bigger/more important); Supersede when
    sim >= 0.98 (newer wins); else Link related_to
  - execute_action (:187-230) tolerating Duplicate/Invalid races
  - merge_nodes: edge transfer + tombstone (:233+)

TPU redesign: the reference runs one ANN search per node (O(N) index
queries); here ALL embedded nodes are queried as one batched device
top-k (chunked [B,d] x [d,N] matmuls), then thresholded on host.
"""

from __future__ import annotations

import threading
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..errors import DuplicateEdge, InvalidEdge
from ..storage.base import NodeFilter, Storage
from ..types import Edge, EdgeProvenance, Node
from ..vector.config import SimilarityConfig
from ..vector.index import VectorIndex

MERGE = "merge"
SUPERSEDE = "supersede"
LINK = "link"

_BATCH = 256
_CAND_K = 64    # matches >= .92 beyond 64 per node are vanishingly rare


@dataclass
class DuplicatePair:
    node_a: str
    node_b: str
    similarity: float
    action: str
    keep: Optional[str] = None
    retire: Optional[str] = None    # for merge: retire; for supersede: older


@dataclass
class DedupResult:
    duplicates: List[DuplicatePair]


class DedupScanner:
    def __init__(self, storage: Storage, index: VectorIndex,
                 config: SimilarityConfig,
                 persist_lock: Optional[threading.Lock] = None,
                 on_index_pair_failure=None):
        self.storage = storage
        self.index = index
        self.config = config
        # keeps the tombstone write + index removal atomic w.r.t. a
        # concurrent index-snapshot capture (see AutoLinker.persist_lock)
        self.persist_lock = persist_lock or threading.Lock()
        self.on_index_pair_failure = on_index_pair_failure

    # ------------------------------------------------------------------ scan
    def scan(self, nodes: Optional[List[Node]] = None) -> DedupResult:
        """All-pairs high-similarity scan. With `nodes` given, only
        those are used as QUERIES (against the full index) — the
        incremental form the auto-linker drives: a pair of existing
        nodes was already reported when the newer one was first
        scanned, so only pairs involving never-scanned nodes can be
        new. Cost tracks churn, not corpus size (the full scan
        deserializes every row and queries the whole corpus — measured
        277 s inside a linker cycle at 1M after a bulk import).
        Caveat: the incremental keyset orders by created_at, so a node
        EDITED into a duplicate after its first scan is not re-queried
        here — that path is covered by the write gate's duplicate
        check at store time, and by explicit full scans (None ->
        full scan; CLI / trigger)."""
        if nodes is None:
            nodes = self.storage.list_nodes(NodeFilter())
        nodes = [n for n in nodes
                 if n.embedding is not None and n.id in self.index]
        if not nodes:
            return DedupResult(duplicates=[])
        by_id = {n.id: n for n in nodes}
        pairs: List[DuplicatePair] = []
        seen: set[Tuple[str, str]] = set()
        thr = self.config.dedup_threshold

        for start in range(0, len(nodes), _BATCH):
            chunk = nodes[start:start + _BATCH]
            q = np.stack([np.asarray(n.embedding, np.float32) for n in chunk])
            # refine=False: near-duplicates (>= 0.92) rank at the very
            # top of any candidate scan — graph expansion can't add
            # them and only inflates the host re-rank leg
            hits = self.index.search_batch(q, _CAND_K, refine=False)
            for j, node in enumerate(chunk):
                for other_id, score in hits[j]:
                    if other_id == node.id or score < thr:
                        continue
                    key = (min(node.id, other_id), max(node.id, other_id))
                    if key in seen:
                        continue
                    seen.add(key)
                    other = by_id.get(other_id) or self.storage.get_node(other_id)
                    if other is None or other.deleted:
                        continue
                    pairs.append(self._decide(node, other, float(score)))
        return DedupResult(duplicates=pairs)

    # ---------------------------------------------------------------- policy
    def _connections(self, node_id: str) -> int:
        return (len(self.storage.edges_from(node_id))
                + len(self.storage.edges_to(node_id)))

    def _decide(self, a: Node, b: Node, similarity: float) -> DuplicatePair:
        ca, cb = self._connections(a.id), self._connections(b.id)
        if ca > cb * 2 or cb > ca * 2:
            keep, retire = (a.id, b.id) if ca > cb else (b.id, a.id)
            return DuplicatePair(a.id, b.id, similarity, MERGE,
                                 keep=keep, retire=retire)
        if abs(a.importance - b.importance) > 0.3:
            keep, retire = (a.id, b.id) if a.importance > b.importance \
                else (b.id, a.id)
            return DuplicatePair(a.id, b.id, similarity, MERGE,
                                 keep=keep, retire=retire)
        if similarity >= 0.98:
            newer, older = (a.id, b.id) if a.created_at > b.created_at \
                else (b.id, a.id)
            return DuplicatePair(a.id, b.id, similarity, SUPERSEDE,
                                 keep=newer, retire=older)
        return DuplicatePair(a.id, b.id, similarity, LINK)

    # --------------------------------------------------------------- execute
    def execute_action(self, pair: DuplicatePair) -> None:
        try:
            if pair.action == MERGE:
                self.merge_nodes(pair.keep, pair.retire)
            elif pair.action == SUPERSEDE:
                self.storage.put_edge(Edge.new(
                    pair.keep, pair.retire, "supersedes", 0.95,
                    EdgeProvenance.auto_dedup(pair.similarity)))
            else:
                self.storage.put_edge(Edge.new(
                    pair.node_a, pair.node_b, "related_to", pair.similarity,
                    EdgeProvenance.auto_dedup(pair.similarity)))
        except (DuplicateEdge, InvalidEdge):
            pass    # race-tolerant (dedup.rs:203-208)

    def merge_nodes(self, keep: str, retire: str) -> None:
        """Transfer retire's edges to keep, then tombstone retire."""
        keep_node = self.storage.get_node(keep)
        retire_node = self.storage.get_node(retire)
        if keep_node is None or retire_node is None:
            return
        for e in self.storage.edges_from(retire):
            if e.to_id != keep:
                try:
                    self.storage.put_edge(Edge.new(
                        keep, e.to_id, e.relation, e.weight, e.provenance))
                except (DuplicateEdge, InvalidEdge):
                    pass
            self.storage.delete_edge(e.id)
        for e in self.storage.edges_to(retire):
            if e.from_id != keep:
                try:
                    self.storage.put_edge(Edge.new(
                        e.from_id, keep, e.relation, e.weight, e.provenance))
                except (DuplicateEdge, InvalidEdge):
                    pass
            self.storage.delete_edge(e.id)
        with self.persist_lock:
            self.storage.delete_node(retire)
            try:
                self.index.remove(retire)
            except BaseException:
                if self.on_index_pair_failure is not None:
                    self.on_index_pair_failure()
                raise
