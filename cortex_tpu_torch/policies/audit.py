"""Audit log facade over the storage audit table.

Parity: crates/cortex-core/src/policies/audit.rs:12-156 — typed actions,
timestamp-keyed entries, filtered queries. The storage backends append
entries fire-and-forget on every mutation; this module is the query/report
surface (`cortex audit` CLI + HTTP).
"""

from __future__ import annotations

import time
from typing import List, Optional

from ..storage.base import AuditEntry, Storage

NODE_CREATED = "node_created"
NODE_UPDATED = "node_updated"
NODE_DELETED = "node_deleted"
NODE_HARD_DELETED = "node_hard_deleted"
EDGE_CREATED = "edge_created"
EDGE_UPDATED = "edge_updated"
EDGE_DELETED = "edge_deleted"

ALL_ACTIONS = [NODE_CREATED, NODE_UPDATED, NODE_DELETED, NODE_HARD_DELETED,
               EDGE_CREATED, EDGE_UPDATED, EDGE_DELETED]


class AuditLog:
    def __init__(self, storage: Storage):
        self.storage = storage

    def record(self, action: str, target_id: str, actor: str = "system",
               details: Optional[dict] = None) -> None:
        self.storage.append_audit(AuditEntry(
            ts=time.time(), action=action, target_id=target_id, actor=actor,
            details=details))

    def query(self, *, action: Optional[str] = None,
              target_id: Optional[str] = None,
              since: Optional[float] = None,
              limit: int = 100) -> List[AuditEntry]:
        return self.storage.query_audit(action=action, target_id=target_id,
                                        since=since, limit=limit)
