"""Retention engine: TTL-driven expiry with score/access/edge protection.

Parity: crates/cortex-core/src/policies/retention.rs:17-297 —
  - RetentionConfig: default_ttl_days (0 = forever), per-kind
    {ttl_days, min_score} (bare ints accepted in TOML), grace_days 30,
    protect_with_inbound_edges, max_nodes {limit, strategy}
  - should_delete (:122-166): age > TTL AND decayed score < min_score
    (when set) AND idle past grace AND no live inbound edges
  - sweep (:181-251): per-kind pass, default-TTL pass (skipping
    explicitly configured kinds), max-node eviction
    (oldest_lowest_importance)
  - purge_expired (:251+): hard-delete tombstones older than grace
  - outbound edges soft-cleaned at delete time (:170-176)

The eligibility computation is also exposed vectorized
(ops.decay.retention_eligibility) for bulk sweeps over packed arrays.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

from ..errors import ValidationError
from ..storage.base import NodeFilter, Storage
from ..types import Node
from ..vector.scoring import ScoreDecayConfig, apply_score_decay


@dataclass
class KindRetention:
    ttl_days: float
    min_score: Optional[float] = None


@dataclass
class RetentionMaxNodes:
    limit: int
    strategy: str = "oldest_lowest_importance"


@dataclass
class RetentionConfig:
    default_ttl_days: float = 0.0
    by_kind: Dict[str, KindRetention] = field(default_factory=dict)
    max_nodes: Optional[RetentionMaxNodes] = None
    grace_days: float = 30.0
    protect_with_inbound_edges: bool = True

    @staticmethod
    def from_dict(d: Dict[str, Any]) -> "RetentionConfig":
        by_kind = {}
        for k, v in d.get("by_kind", {}).items():
            if isinstance(v, (int, float)):
                by_kind[k] = KindRetention(ttl_days=float(v))
            else:
                by_kind[k] = KindRetention(
                    ttl_days=float(v.get("ttl_days", 0)),
                    min_score=v.get("min_score"))
        mn = d.get("max_nodes")
        return RetentionConfig(
            default_ttl_days=float(d.get("default_ttl_days", 0)),
            by_kind=by_kind,
            max_nodes=RetentionMaxNodes(
                limit=int(mn["limit"]),
                strategy=mn.get("strategy", "oldest_lowest_importance"))
            if mn else None,
            grace_days=float(d.get("grace_days", 30)),
            protect_with_inbound_edges=bool(
                d.get("protect_with_inbound_edges", True)))


class RetentionEngine:
    def __init__(self, config: RetentionConfig,
                 score_decay: Optional[ScoreDecayConfig] = None):
        self.config = config
        self.score_decay = score_decay or ScoreDecayConfig()

    # ------------------------------------------------------------- decisions
    def _should_delete(self, node: Node, kr: KindRetention,
                       storage: Storage, now: float) -> bool:
        age_days = (now - node.created_at) / 86400.0
        if age_days <= kr.ttl_days:
            return False
        if kr.min_score is not None:
            decayed = apply_score_decay(node, 1.0, self.score_decay, 1.0,
                                        now=now)
            if decayed >= kr.min_score:
                return False
        idle_days = (now - node.last_accessed_at) / 86400.0
        if idle_days <= self.config.grace_days:
            return False
        if self.config.protect_with_inbound_edges:
            for e in storage.edges_to(node.id):
                src = storage.get_node(e.from_id)
                if src is not None and not src.deleted:
                    return False
        return True

    def _cleanup_outbound(self, node_id: str, storage: Storage) -> None:
        for e in storage.edges_from(node_id):
            storage.delete_edge(e.id)

    # ----------------------------------------------------------------- sweep
    def sweep(self, storage: Storage, now: float | None = None,
              deleter=None) -> int:
        """deleter(node_id) -> bool replaces the raw storage soft
        delete so callers can keep companion state (the vector
        index) in step with each deletion; defaults to
        storage.delete_node."""
        now = time.time() if now is None else now
        if deleter is None:
            deleter = storage.delete_node
        deleted = 0

        for kind, kr in self.config.by_kind.items():
            if kr.ttl_days == 0:
                continue
            cutoff = now - kr.ttl_days * 86400
            for node in storage.list_nodes(NodeFilter(
                    kinds=[kind], created_before=cutoff)):
                if self._should_delete(node, kr, storage, now):
                    self._cleanup_outbound(node.id, storage)
                    deleter(node.id)
                    deleted += 1

        if self.config.default_ttl_days > 0:
            cutoff = now - self.config.default_ttl_days * 86400
            default_kr = KindRetention(ttl_days=self.config.default_ttl_days)
            for node in storage.list_nodes(NodeFilter(created_before=cutoff)):
                if node.kind in self.config.by_kind:
                    continue
                if self._should_delete(node, default_kr, storage, now):
                    self._cleanup_outbound(node.id, storage)
                    deleter(node.id)
                    deleted += 1

        if self.config.max_nodes is not None:
            stats = storage.stats()
            if stats.node_count > self.config.max_nodes.limit:
                excess = stats.node_count - self.config.max_nodes.limit
                for nid in self._eviction_candidates(
                        storage, excess, self.config.max_nodes.strategy):
                    self._cleanup_outbound(nid, storage)
                    deleter(nid)
                    deleted += 1
        return deleted

    def purge_expired(self, storage: Storage,
                      now: float | None = None, deleter=None) -> int:
        now = time.time() if now is None else now
        if deleter is None:
            deleter = storage.hard_delete_node
        grace = self.config.grace_days or 30.0
        cutoff = now - grace * 86400
        purged = 0
        for node in storage.list_nodes(NodeFilter(deleted_only=True)):
            if node.updated_at < cutoff:
                deleter(node.id)
                purged += 1
        return purged

    def _eviction_candidates(self, storage: Storage, count: int,
                             strategy: str) -> List[str]:
        if strategy != "oldest_lowest_importance":
            raise ValidationError(f"Unknown eviction strategy: {strategy}")
        nodes = storage.list_nodes(NodeFilter())
        nodes.sort(key=lambda n: (n.importance, n.created_at))
        return [n.id for n in nodes[:count]]
