"""Backend-agnostic storage interface.

Parity with the reference `Storage` trait
(crates/cortex-core/src/storage/traits.rs:7-87) and filter types
(storage/filters.rs:7-107). Host-side only: durable node/edge/metadata
state lives here; embedding vectors are *also* persisted on nodes for
rebuild-at-boot, but the queryable copy is the device-resident shard set
(cortex_tpu.vector.shard).
"""

from __future__ import annotations

import abc
from dataclasses import dataclass, field
from typing import Any, Dict, Iterable, List, Optional, Tuple

from ..types import Edge, Node

SCHEMA_VERSION = 2  # parity with reference redb schema v2 (redb_storage.rs:37)


@dataclass
class NodeFilter:
    """Declarative node query filter (storage/filters.rs:7-95)."""

    kinds: Optional[List[str]] = None
    tags: Optional[List[str]] = None          # node must carry ALL listed tags
    tags_any: Optional[List[str]] = None      # node must carry AT LEAST ONE
    source_agent: Optional[str] = None
    created_after: Optional[float] = None
    created_before: Optional[float] = None
    min_importance: Optional[float] = None
    max_importance: Optional[float] = None
    include_deleted: bool = False
    deleted_only: bool = False          # only tombstoned nodes
    limit: Optional[int] = None
    offset: int = 0

    def matches(self, node: Node) -> bool:
        if self.deleted_only and not node.deleted:
            return False
        if not self.include_deleted and not self.deleted_only and node.deleted:
            return False
        if self.kinds is not None and node.kind not in self.kinds:
            return False
        if self.tags is not None and not all(t in node.tags for t in self.tags):
            return False
        if self.tags_any is not None and not any(
                t in node.tags for t in self.tags_any):
            return False
        if self.source_agent is not None and node.source.agent != self.source_agent:
            return False
        if self.created_after is not None and node.created_at < self.created_after:
            return False
        if self.created_before is not None and node.created_at > self.created_before:
            return False
        if self.min_importance is not None and node.importance < self.min_importance:
            return False
        if self.max_importance is not None and node.importance > self.max_importance:
            return False
        return True


@dataclass
class StorageStats:
    """O(1) store statistics (storage/filters.rs:99-107)."""

    node_count: int = 0
    edge_count: int = 0
    deleted_node_count: int = 0
    nodes_by_kind: Dict[str, int] = field(default_factory=dict)
    edges_by_relation: Dict[str, int] = field(default_factory=dict)
    db_size_bytes: int = 0


@dataclass
class AuditEntry:
    """Append-only audit record (policies/audit.rs:12-60)."""

    ts: float
    action: str          # node_created|node_updated|node_deleted|node_hard_deleted|
    #                      edge_created|edge_updated|edge_deleted
    target_id: str
    actor: str = "system"
    details: Optional[Dict[str, Any]] = None


class Storage(abc.ABC):
    """Abstract node/edge/metadata store with audit trail."""

    # -- nodes ------------------------------------------------------------
    @abc.abstractmethod
    def put_node(self, node: Node, *, actor: str = "system") -> None: ...

    @abc.abstractmethod
    def get_node(self, node_id: str) -> Optional[Node]: ...

    @abc.abstractmethod
    def delete_node(self, node_id: str, *, actor: str = "system") -> bool:
        """Soft delete (tombstone). Returns False when missing."""

    @abc.abstractmethod
    def hard_delete_node(self, node_id: str, *, actor: str = "system") -> bool:
        """Physical removal including incident edges."""

    def record_access(self, node_id: str, *, now: Optional[float] = None,
                      reinforced_at: Optional[float] = None) -> bool:
        """Atomically bump access_count / last_accessed_at iff the node
        still exists and is not deleted. Unlike a read-modify-write
        put_node of a stale object, this can never resurrect a node
        deleted by a concurrent writer (the reference records access via
        an in-transaction re-read, routes.rs:969-985). When
        reinforced_at is given, also stamps the decay-reinforcement
        marker and updated_at. Returns True iff applied."""
        import time as _time
        now = _time.time() if now is None else now
        n = self.get_node(node_id)
        if n is None or n.deleted:
            return False
        n.access_count += 1
        n.last_accessed_at = now
        if reinforced_at is not None:
            n.updated_at = now
            n.metadata["_last_reinforced_at"] = reinforced_at
        self.put_node(n)
        return True

    def record_access_batch(self, ids: Iterable[str], *,
                            now: Optional[float] = None
                            ) -> Dict[str, Tuple[int, float]]:
        """Atomic access bumps for many ids at once; returns
        {id: (access_count, last_accessed_at)} for the rows actually
        bumped (missing/deleted ids are skipped, like record_access).
        Backends override with one UPDATE + one commit — the default's
        per-id record_access commits per row, and the search hot path
        bumps up to `limit` rows per request."""
        import time as _time
        now = _time.time() if now is None else now
        out: Dict[str, Tuple[int, float]] = {}
        for i in ids:
            if self.record_access(i, now=now):
                n = self.get_node(i)
                if n is not None:
                    out[i] = (n.access_count, n.last_accessed_at)
        return out

    @abc.abstractmethod
    def list_nodes(self, f: Optional[NodeFilter] = None) -> List[Node]: ...

    def list_nodes_since(self, created_after: float, after_id: str,
                         limit: int) -> List[Node]:
        """Oldest-first keyset page for cursor scans: nodes with
        (created_at, id) STRICTLY greater than the cursor pair, sorted
        ascending, at most `limit` rows. The auto-linker's cycle scan
        runs on this — an unbounded created_after filter materializes
        the entire backlog (measured: a 1M-node backlog deserialized
        per cycle took ~40 s holding the storage lock, starving every
        concurrent read/write). Backends override with an indexed
        range scan + LIMIT so cost tracks the page size; this default
        is the semantic reference (O(N) per call)."""
        mark = (created_after, after_id)
        rows = [n for n in self.list_nodes(
                    NodeFilter(created_after=created_after))
                if (n.created_at, n.id) > mark]
        rows.sort(key=lambda n: (n.created_at, n.id))
        return rows[:limit]

    @abc.abstractmethod
    def count_nodes(self, f: Optional[NodeFilter] = None) -> int: ...

    @abc.abstractmethod
    def list_distinct_kinds(self) -> List[str]: ...

    def index_seq(self) -> Optional[int]:
        """Monotonic counter of index-relevant node mutations, or None
        when the backend can't provide one (callers must then rebuild
        the vector index from stored embeddings instead of trusting a
        snapshot)."""
        return None

    # -- edges ------------------------------------------------------------
    @abc.abstractmethod
    def put_edge(self, edge: Edge, *, actor: str = "system") -> None:
        """Validates endpoints exist + live, rejects duplicate
        (from, to, relation) — reference redb_storage.rs:760-862."""

    @abc.abstractmethod
    def get_edge(self, edge_id: str) -> Optional[Edge]: ...

    @abc.abstractmethod
    def delete_edge(self, edge_id: str, *, actor: str = "system") -> bool: ...

    @abc.abstractmethod
    def edges_from(self, node_id: str) -> List[Edge]: ...

    @abc.abstractmethod
    def edges_to(self, node_id: str) -> List[Edge]: ...

    @abc.abstractmethod
    def edges_between(self, a: str, b: str) -> List[Edge]:
        """Edges in either direction between a and b."""

    @abc.abstractmethod
    def all_edges(self) -> List[Edge]: ...

    def edge_endpoints(self, chunk: int = 1_000_000):
        """Yield (from_ids, to_ids) list chunks over every edge — a
        column-only scan for bulk adjacency builds (graph/packed.py):
        at the 100M-edge scale constructing Edge objects would cost
        more than the build itself. Default adapts all_edges() (fine
        for small stores); scale backends override with a real
        column scan."""
        fs: List[str] = []
        ts: List[str] = []
        for e in self.all_edges():
            fs.append(e.from_id)
            ts.append(e.to_id)
            if len(fs) >= chunk:
                yield fs, ts
                fs, ts = [], []
        if fs:
            yield fs, ts

    @abc.abstractmethod
    def update_edge_weight_atomic(self, edge_id: str, weight: float,
                                  touch: bool = True) -> bool:
        """Atomic read-modify-write of one edge's weight
        (redb_storage.rs:459-515). When touch, bumps updated_at."""

    def decay_scan(self, chunk: int = 2_000_000):
        """Yield columnar chunks for the decay sweep:
        (ids, weights[f32], updated_at[f32], max_importance[f32],
        manual[bool]) — everything the sweep kernel needs, no Edge
        objects. max_importance is the max endpoint importance
        (missing endpoints count 0.0, matching the object path).
        Default adapts all_edges(); scale backends override with a
        single JOIN scan (at 100M edges, Edge construction costs more
        than the sweep itself)."""
        import numpy as np
        edges = self.all_edges()
        imp_cache: Dict[str, float] = {}

        def importance(nid: str) -> float:
            v = imp_cache.get(nid)
            if v is None:
                n = self.get_node(nid)
                v = n.importance if n is not None else 0.0
                imp_cache[nid] = v
            return v

        for s in range(0, len(edges), chunk):
            part = edges[s:s + chunk]
            ids = [e.id for e in part]
            weights = np.fromiter((e.weight for e in part), np.float32,
                                  count=len(part))
            updated = np.fromiter((e.updated_at for e in part), np.float64,
                                  count=len(part))
            max_imp = np.fromiter(
                (max(importance(e.from_id), importance(e.to_id))
                 for e in part), np.float32, count=len(part))
            manual = np.fromiter((e.provenance.is_manual for e in part),
                                 bool, count=len(part))
            yield ids, weights, updated, max_imp, manual

    def apply_decay_results(self, updates, deletes, *,
                            actor: str = "system") -> Tuple[int, int]:
        """Persist one decay sweep's outcome in bulk: `updates` yields
        (edge_id, new_weight) pairs (weight-only, updated_at untouched
        — the decay clock keeps running), `deletes` yields edge ids.
        Returns (updated_count, deleted_count). Backends override with
        one transaction of executemany writes — the default's per-edge
        atomic calls commit per row (measured 934 s for one sweep at
        20.8M edges, serializing the r4 soak window)."""
        updated = 0
        deleted = 0
        for eid, w in updates:
            if self.update_edge_weight_atomic(eid, float(w), touch=False):
                updated += 1
        for eid in deletes:
            if self.delete_edge(eid, actor=actor):
                deleted += 1
        return updated, deleted

    # -- batches ----------------------------------------------------------
    def put_nodes_batch(self, nodes: Iterable[Node], *, actor: str = "system") -> int:
        n = 0
        for node in nodes:
            self.put_node(node, actor=actor)
            n += 1
        return n

    def put_edges_batch(self, edges: Iterable[Edge], *,
                        actor: str = "system",
                        tolerant: bool = False) -> int:
        """tolerant=True skips DuplicateEdge/InvalidEdge per edge
        instead of raising — the auto-linker's race-tolerant batch
        write (reference auto_linker.rs:292-303). Backends override
        with a single transaction: the default's per-edge put_edge
        commits (and fsyncs) per row — measured as seconds per linker
        cycle at the 2000-edge budget."""
        from ..errors import DuplicateEdge, InvalidEdge
        n = 0
        for e in edges:
            try:
                self.put_edge(e, actor=actor)
                n += 1
            except (DuplicateEdge, InvalidEdge):
                if not tolerant:
                    raise
        return n

    def bulk_put_nodes(self, nodes: Iterable[Node], *,
                       actor: str = "bulk-import",
                       validate: bool = True) -> int:
        """Bulk-load fast path: additive INSERT semantics (existing
        ids are left untouched, matching `cortex import`'s
        never-clobber contract, cli/import.rs:91-186), no per-row
        audit (backends write one summary row), no gate/hooks — the
        CALLER owns admission policy. Returns the number of rows
        actually inserted. Default adapts put_nodes_batch; the sqlite
        backend overrides with executemany transactions + a suspended
        index_seq trigger (measured 33k -> 150k rows/s)."""
        count = 0
        for n in nodes:
            if validate:
                n.validate()
            if self.get_node(n.id) is None:
                self.put_node(n, actor=actor)
                count += 1
        return count

    def bulk_put_edges(self, edges: Iterable[Edge], *,
                       actor: str = "bulk-import") -> int:
        """Bulk edge load: INSERT OR IGNORE semantics, NO endpoint
        validation (the caller guarantees endpoints — at 100M edges
        per-edge existence SELECTs cost hours, storage_bench r4).
        Returns inserted count. Default adapts tolerant
        put_edges_batch (which does validate); sqlite overrides raw."""
        return self.put_edges_batch(edges, actor=actor, tolerant=True)

    def existing_node_ids(self, ids: Iterable[str]) -> set:
        """Subset of `ids` present in the store (tombstones included)
        — a light existence probe, no Node hydration. Backends
        override with an id-only IN query; the default hydrates."""
        return {i for i in ids if self.get_node(i) is not None}

    def get_nodes(self, ids: Iterable[str]) -> Dict[str, Node]:
        """Batch point-reads: present, non-None nodes keyed by id.
        Backends override with one IN query — the default's per-id
        get_node round trips (the linker hydrates up to
        max_nodes_per_cycle x candidate_k neighbors per cycle)."""
        out: Dict[str, Node] = {}
        for i in ids:
            n = self.get_node(i)
            if n is not None:
                out[i] = n
        return out

    # -- metadata KV ------------------------------------------------------
    @abc.abstractmethod
    def put_metadata(self, key: str, value: str) -> None: ...

    def put_metadata_many(self, kv: Dict[str, str]) -> None:
        """Batch metadata upsert. Backends override with one commit —
        the linker saves its cursor/cycle state (5 keys) every cycle,
        and the default pays a commit per key."""
        for k, v in kv.items():
            self.put_metadata(k, v)

    @abc.abstractmethod
    def get_metadata(self, key: str) -> Optional[str]: ...

    # -- audit ------------------------------------------------------------
    @abc.abstractmethod
    def append_audit(self, entry: AuditEntry) -> None: ...

    @abc.abstractmethod
    def query_audit(self, *, action: Optional[str] = None,
                    target_id: Optional[str] = None,
                    since: Optional[float] = None,
                    limit: int = 100) -> List[AuditEntry]: ...

    # -- maintenance ------------------------------------------------------
    @abc.abstractmethod
    def compact(self) -> None: ...

    @abc.abstractmethod
    def stats(self) -> StorageStats: ...

    @abc.abstractmethod
    def snapshot(self, dest_path: str) -> None: ...

    def close(self) -> None:  # pragma: no cover - default no-op
        pass

    # -- derived helpers ---------------------------------------------------
    def node_exists_live(self, node_id: str) -> bool:
        n = self.get_node(node_id)
        return n is not None and not n.deleted

    def neighbors_of(self, node_id: str) -> List[Tuple[Edge, str]]:
        """(edge, neighbor_id) pairs over both directions."""
        out: List[Tuple[Edge, str]] = []
        for e in self.edges_from(node_id):
            out.append((e, e.to_id))
        for e in self.edges_to(node_id):
            out.append((e, e.from_id))
        return out
