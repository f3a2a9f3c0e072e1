"""In-memory Storage implementation — the hermetic test seam.

Plays the role the reference's trait-parameterized fakes play in its test
suite (SURVEY §4: tests run engines generically over Storage). Identical
behavioral contract to SqliteStorage, dict-backed.
"""

from __future__ import annotations

import contextlib
import copy
import gc
import shutil
import time
from typing import Any, Dict, List, Optional

from ..errors import DuplicateEdge, InvalidEdge
from ..types import Edge, Node
from .base import AuditEntry, NodeFilter, Storage, StorageStats


class MemoryStorage(Storage):
    def __init__(self):
        self._nodes: Dict[str, Node] = {}
        self._edges: Dict[str, Edge] = {}
        self._edges_from: Dict[str, List[str]] = {}
        self._edges_to: Dict[str, List[str]] = {}
        self._meta: Dict[str, str] = {}
        self._audit: List[AuditEntry] = []
        self._index_seq = 0

    # ----------------------------------------------------------------- nodes
    def put_node(self, node: Node, *, actor: str = "system") -> None:
        node.validate()
        action = "node_updated" if node.id in self._nodes else "node_created"
        # COPY boundary, like SQLite's serialization: storing the live
        # reference let later caller-side mutations change stored state
        # retroactively (no audit, no index_seq bump) — tests written
        # against this seam then diverged from production behavior
        self._nodes[node.id] = copy.deepcopy(node)
        self._index_seq += 1
        self._audit.append(AuditEntry(ts=time.time(), action=action,
                                      target_id=node.id, actor=actor))

    def get_node(self, node_id: str) -> Optional[Node]:
        n = self._nodes.get(node_id)
        return copy.deepcopy(n) if n is not None else None

    def record_access(self, node_id: str, *, now: Optional[float] = None,
                      reinforced_at: Optional[float] = None) -> bool:
        n = self._nodes.get(node_id)   # liveness re-checked under the GIL
        if n is None or n.deleted:
            return False
        now = time.time() if now is None else now
        n.access_count += 1
        n.last_accessed_at = now
        if reinforced_at is not None:
            n.updated_at = now
            n.metadata["_last_reinforced_at"] = reinforced_at
        return True

    def delete_node(self, node_id: str, *, actor: str = "system") -> bool:
        n = self._nodes.get(node_id)
        if n is None or n.deleted:
            return False
        n.deleted = True
        n.updated_at = time.time()
        self._index_seq += 1
        self._audit.append(AuditEntry(ts=time.time(), action="node_deleted",
                                      target_id=node_id, actor=actor))
        return True

    def hard_delete_node(self, node_id: str, *, actor: str = "system") -> bool:
        if node_id not in self._nodes:
            return False
        del self._nodes[node_id]
        self._index_seq += 1
        for eid in list(self._edges_from.pop(node_id, [])):
            self._remove_edge_record(eid)
        for eid in list(self._edges_to.pop(node_id, [])):
            self._remove_edge_record(eid)
        self._audit.append(AuditEntry(ts=time.time(), action="node_hard_deleted",
                                      target_id=node_id, actor=actor))
        return True

    def put_nodes_batch(self, nodes, *, actor: str = "system") -> int:
        """Validate-then-apply: SQLite's batch is one transaction, so a
        mid-batch ValidationError must not leave earlier nodes stored
        here while SQLite rolls them all back."""
        nodes = list(nodes)
        for n in nodes:
            n.validate()
        for n in nodes:
            self.put_node(n, actor=actor)
        return len(nodes)

    def list_nodes(self, f: Optional[NodeFilter] = None) -> List[Node]:
        f = f or NodeFilter()
        out = [copy.deepcopy(n) for n in self._nodes.values()
               if f.matches(n)]
        out.sort(key=lambda n: n.created_at, reverse=True)
        if f.offset:
            out = out[f.offset:]
        if f.limit is not None:
            out = out[:f.limit]
        return out

    def count_nodes(self, f: Optional[NodeFilter] = None) -> int:
        f = f or NodeFilter()
        return sum(1 for n in self._nodes.values() if f.matches(n))

    def index_seq(self) -> Optional[int]:
        return self._index_seq

    def list_distinct_kinds(self) -> List[str]:
        return sorted({n.kind for n in self._nodes.values() if not n.deleted})

    # ----------------------------------------------------------------- edges
    def put_edge(self, edge: Edge, *, actor: str = "system") -> None:
        edge.validate()
        for nid, side in ((edge.from_id, "from"), (edge.to_id, "to")):
            n = self._nodes.get(nid)
            if n is None:
                raise InvalidEdge(f"edge {side} endpoint {nid} does not exist")
            if n.deleted:
                raise InvalidEdge(f"edge {side} endpoint {nid} is deleted")
        for eid in self._edges_from.get(edge.from_id, []):
            e = self._edges[eid]
            if (e.to_id == edge.to_id and e.relation == edge.relation
                    and e.id != edge.id):
                raise DuplicateEdge(edge.from_id, edge.to_id, edge.relation)
        is_update = edge.id in self._edges
        if is_update:
            self._remove_edge_record(edge.id)
        self._edges[edge.id] = copy.deepcopy(edge)   # copy boundary
        self._edges_from.setdefault(edge.from_id, []).append(edge.id)
        self._edges_to.setdefault(edge.to_id, []).append(edge.id)
        self._audit.append(AuditEntry(
            ts=time.time(), action="edge_updated" if is_update else "edge_created",
            target_id=edge.id, actor=actor))

    def _remove_edge_record(self, edge_id: str) -> None:
        e = self._edges.pop(edge_id, None)
        if e is None:
            return
        for idx, key in ((self._edges_from, e.from_id), (self._edges_to, e.to_id)):
            lst = idx.get(key)
            if lst and edge_id in lst:
                lst.remove(edge_id)

    def get_edge(self, edge_id: str) -> Optional[Edge]:
        e = self._edges.get(edge_id)
        return copy.deepcopy(e) if e is not None else None

    def delete_edge(self, edge_id: str, *, actor: str = "system") -> bool:
        if edge_id not in self._edges:
            return False
        self._remove_edge_record(edge_id)
        self._audit.append(AuditEntry(ts=time.time(), action="edge_deleted",
                                      target_id=edge_id, actor=actor))
        return True

    def edges_from(self, node_id: str) -> List[Edge]:
        return [copy.deepcopy(self._edges[eid])
                for eid in self._edges_from.get(node_id, [])]

    def edges_to(self, node_id: str) -> List[Edge]:
        return [copy.deepcopy(self._edges[eid])
                for eid in self._edges_to.get(node_id, [])]

    def edges_between(self, a: str, b: str) -> List[Edge]:
        out = [e for e in self.edges_from(a) if e.to_id == b]
        out += [e for e in self.edges_from(b) if e.to_id == a]
        return out

    def all_edges(self) -> List[Edge]:
        return [copy.deepcopy(e) for e in self._edges.values()]

    def edge_endpoints(self, chunk: int = 1_000_000):
        """Column-only scan without deepcopy (ids are immutable)."""
        fs: List[str] = []
        ts: List[str] = []
        for e in list(self._edges.values()):
            fs.append(e.from_id)
            ts.append(e.to_id)
            if len(fs) >= chunk:
                yield fs, ts
                fs, ts = [], []
        if fs:
            yield fs, ts

    # ------------------------------------------------------------- bulk load
    def bulk_insert_node_rows(self, rows, *,
                              actor: str = "bulk-import") -> int:
        """Raw bulk node insert, SqliteStorage's contract: INSERT OR
        IGNORE on ids (an id already stored, or earlier in `rows`, is
        left as it is), NO validation (the caller's contract), no
        per-row audit but one summary row, index_seq moved once by the
        count inserted. `rows` yields tuples of Node's fields in their
        order (id, kind, title, body, then any of the rest); the store
        builds each Node, and takes over any container a row holds.
        All or nothing: a row that fails to build stores none."""
        staged: Dict[str, Node] = {}
        with self._collector_paused():
            for row in rows:
                if row[0] not in self._nodes and row[0] not in staged:
                    staged[row[0]] = Node(*row)
        self._nodes.update(staged)
        if staged:
            self._index_seq += len(staged)
            self._audit.append(AuditEntry(
                ts=time.time(), action="bulk_import_nodes",
                target_id=f"count={len(staged)}", actor=actor))
        return len(staged)

    def bulk_insert_edge_rows(self, rows, *,
                              actor: str = "bulk-import") -> int:
        """Raw bulk edge insert, SqliteStorage's contract: INSERT OR
        IGNORE on ids, NO endpoint validation and no duplicate scan
        (the caller's contract: endpoints exist, and one edge a pair
        and relation), one summary audit row. `rows` yields 8-tuples
        in Edge's field order (id, from_id, to_id, relation, weight,
        provenance, created_at, updated_at), the provenance an
        EdgeProvenance where SQLite takes its JSON. All or nothing."""
        staged: Dict[str, Edge] = {}
        stored = self._edges
        with self._collector_paused():
            for row in rows:
                eid = row[0]
                if eid not in stored and eid not in staged:
                    staged[eid] = Edge(*row)
            stored.update(staged)
            frm, to = self._edges_from, self._edges_to
            for eid, e in staged.items():
                out = frm.get(e.from_id)
                if out is None:
                    frm[e.from_id] = [eid]
                else:
                    out.append(eid)
                into = to.get(e.to_id)
                if into is None:
                    to[e.to_id] = [eid]
                else:
                    into.append(eid)
        if staged:
            self._audit.append(AuditEntry(
                ts=time.time(), action="bulk_import_edges",
                target_id=f"count={len(staged)}", actor=actor))
        return len(staged)

    @staticmethod
    @contextlib.contextmanager
    def _collector_paused():
        """The cyclic garbage collector off for the scope: a bulk load
        makes millions of objects that hold no cycles, and the collector's
        passes over the growing heap would add a third to its time."""
        was = gc.isenabled()
        gc.disable()
        try:
            yield
        finally:
            if was:
                gc.enable()

    def update_edge_weight_atomic(self, edge_id: str, weight: float,
                                  touch: bool = True) -> bool:
        e = self._edges.get(edge_id)
        if e is None:
            return False
        e.weight = min(1.0, max(0.0, weight))
        if touch:
            e.updated_at = time.time()
        return True

    # -------------------------------------------------------------- metadata
    def put_metadata(self, key: str, value: str) -> None:
        self._meta[key] = value

    def get_metadata(self, key: str) -> Optional[str]:
        return self._meta.get(key)

    # ----------------------------------------------------------------- audit
    def append_audit(self, entry: AuditEntry) -> None:
        self._audit.append(entry)

    def query_audit(self, *, action: Optional[str] = None,
                    target_id: Optional[str] = None,
                    since: Optional[float] = None,
                    limit: int = 100) -> List[AuditEntry]:
        out = []
        for e in reversed(self._audit):
            if action is not None and e.action != action:
                continue
            if target_id is not None and e.target_id != target_id:
                continue
            if since is not None and e.ts < since:
                continue
            out.append(e)
            if len(out) >= limit:
                break
        return out

    # ----------------------------------------------------------- maintenance
    def compact(self) -> None:
        pass

    def stats(self) -> StorageStats:
        by_kind: Dict[str, int] = {}
        deleted = 0
        for n in self._nodes.values():
            if n.deleted:
                deleted += 1
            else:
                by_kind[n.kind] = by_kind.get(n.kind, 0) + 1
        by_rel: Dict[str, int] = {}
        for e in self._edges.values():
            by_rel[e.relation] = by_rel.get(e.relation, 0) + 1
        return StorageStats(
            node_count=len(self._nodes) - deleted, edge_count=len(self._edges),
            deleted_node_count=deleted, nodes_by_kind=by_kind,
            edges_by_relation=by_rel, db_size_bytes=0)

    def snapshot(self, dest_path: str) -> None:
        raise NotImplementedError("MemoryStorage has no file to snapshot")
