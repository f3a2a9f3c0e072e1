"""Core graph types: Node, Edge, kinds, relations, provenance.

Behavioral parity with the reference's type layer
(crates/cortex-core/src/types.rs:26-360) re-expressed as Python dataclasses.
The device-side packed representation of these records lives in
cortex_tpu.ops.tables (int32 row ids, fp32 importance, int64 epoch-seconds)
so sweeps (decay, retention eligibility) run as vectorized array ops.

Validation rules kept for parity (types.rs:316-351, 247-270):
  - title <= 256 chars; importance in [0,1]; <= 32 tags; tag <= 64 chars,
    lowercase alphanumeric + hyphen only.
  - kind: lowercase alphanumeric + hyphen; relation: lowercase alnum + underscore.
  - no self-edges; edge weight in [0,1].
"""

from __future__ import annotations

import os
import re
import time
import uuid
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

from .errors import ValidationError

# ---------------------------------------------------------------------------
# timestamps: epoch seconds as float (UTC). The reference uses chrono
# DateTime<Utc>; we store float seconds everywhere and render RFC3339 at the
# API boundary (utils.timefmt).
# ---------------------------------------------------------------------------

EPOCH = 0.0

_KIND_RE = re.compile(r"^[a-z0-9-]+$")
_RELATION_RE = re.compile(r"^[a-z0-9_]+$")
_TAG_RE = re.compile(r"^[a-zA-Z0-9-]+$")


def now() -> float:
    return time.time()


def new_id() -> str:
    """UUIDv7 for time-sortability (types.rs:28)."""
    try:
        return str(uuid.uuid7())  # py3.13+
    except AttributeError:
        return _uuid7_compat()


_uuid7_state = {"last_ms": 0, "seq": 0}


def _uuid7_compat() -> str:
    """RFC 9562 UUIDv7: 48-bit unix-ms timestamp | ver | rand_a | var | rand_b.

    rand_a carries a per-ms sequence counter so ids minted within the same
    millisecond stay lexically ordered (the reference relies on UUIDv7
    time-sortability, types.rs:28).
    """
    ms = time.time_ns() // 1_000_000
    if ms == _uuid7_state["last_ms"]:
        _uuid7_state["seq"] = (_uuid7_state["seq"] + 1) & 0xFFF
    else:
        _uuid7_state["last_ms"] = ms
        _uuid7_state["seq"] = 0
    rand_a = _uuid7_state["seq"]
    rand_b = int.from_bytes(os.urandom(8), "big") & ((1 << 62) - 1)
    value = ((ms & ((1 << 48) - 1)) << 80
             | 0x7 << 76                  # version 7
             | rand_a << 64
             | 0b10 << 62                 # variant
             | rand_b)
    return str(uuid.UUID(int=value))


def validate_kind(kind: str) -> str:
    if not kind:
        raise ValidationError("NodeKind cannot be empty")
    if not _KIND_RE.match(kind):
        raise ValidationError(
            f"NodeKind '{kind}' must be lowercase alphanumeric + hyphens only"
        )
    return kind


def validate_relation(relation: str) -> str:
    if not relation:
        raise ValidationError("Relation cannot be empty")
    if not _RELATION_RE.match(relation):
        raise ValidationError(
            f"Relation '{relation}' must be lowercase alphanumeric + underscores only"
        )
    return relation


def kind_display(kind: str) -> str:
    """'fact' -> 'Fact' (types.rs Debug impl; used in embedding_input)."""
    return kind[:1].upper() + kind[1:] if kind else ""


def relation_display(relation: str) -> str:
    """'related_to' -> 'RelatedTo'."""
    return "".join(p[:1].upper() + p[1:] for p in relation.split("_"))


# ---------------------------------------------------------------------------
# Provenance
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class EdgeProvenance:
    """Tagged union of how an edge came to exist (types.rs:247-270)."""

    kind: str                    # manual|auto_similarity|auto_structural|auto_contradiction|auto_dedup|imported
    created_by: Optional[str] = None   # manual
    score: Optional[float] = None      # auto_similarity
    rule: Optional[str] = None         # auto_structural
    reason: Optional[str] = None       # auto_contradiction
    similarity: Optional[float] = None  # auto_dedup
    source: Optional[str] = None       # imported

    MANUAL = "manual"
    AUTO_SIMILARITY = "auto_similarity"
    AUTO_STRUCTURAL = "auto_structural"
    AUTO_CONTRADICTION = "auto_contradiction"
    AUTO_DEDUP = "auto_dedup"
    IMPORTED = "imported"

    @staticmethod
    def manual(created_by: str) -> "EdgeProvenance":
        return EdgeProvenance(kind=EdgeProvenance.MANUAL, created_by=created_by)

    @staticmethod
    def auto_similarity(score: float) -> "EdgeProvenance":
        return EdgeProvenance(kind=EdgeProvenance.AUTO_SIMILARITY, score=score)

    @staticmethod
    def auto_structural(rule: str) -> "EdgeProvenance":
        return EdgeProvenance(kind=EdgeProvenance.AUTO_STRUCTURAL, rule=rule)

    @staticmethod
    def auto_contradiction(reason: str) -> "EdgeProvenance":
        return EdgeProvenance(kind=EdgeProvenance.AUTO_CONTRADICTION, reason=reason)

    @staticmethod
    def auto_dedup(similarity: float) -> "EdgeProvenance":
        return EdgeProvenance(kind=EdgeProvenance.AUTO_DEDUP, similarity=similarity)

    @staticmethod
    def imported(source: str) -> "EdgeProvenance":
        return EdgeProvenance(kind=EdgeProvenance.IMPORTED, source=source)

    @property
    def is_manual(self) -> bool:
        return self.kind == self.MANUAL

    def to_dict(self) -> Dict[str, Any]:
        d: Dict[str, Any] = {"kind": self.kind}
        for f_ in ("created_by", "score", "rule", "reason", "similarity", "source"):
            v = getattr(self, f_)
            if v is not None:
                d[f_] = v
        return d

    @staticmethod
    def from_dict(d: Dict[str, Any]) -> "EdgeProvenance":
        return EdgeProvenance(
            kind=d["kind"],
            created_by=d.get("created_by"),
            score=d.get("score"),
            rule=d.get("rule"),
            reason=d.get("reason"),
            similarity=d.get("similarity"),
            source=d.get("source"),
        )


# ---------------------------------------------------------------------------
# Source
# ---------------------------------------------------------------------------


@dataclass
class Source:
    """Who created a node (types.rs Source)."""

    agent: str
    session: Optional[str] = None
    channel: Optional[str] = None

    def to_dict(self) -> Dict[str, Any]:
        return {"agent": self.agent, "session": self.session, "channel": self.channel}

    @staticmethod
    def from_dict(d: Dict[str, Any]) -> "Source":
        return Source(agent=d.get("agent", ""), session=d.get("session"),
                      channel=d.get("channel"))


# ---------------------------------------------------------------------------
# Node
# ---------------------------------------------------------------------------


@dataclass
class Node:
    id: str
    kind: str
    title: str
    body: str
    metadata: Dict[str, Any] = field(default_factory=dict)
    tags: List[str] = field(default_factory=list)
    embedding: Optional[List[float]] = None
    source: Source = field(default_factory=lambda: Source(agent="unknown"))
    importance: float = 0.5
    access_count: int = 0
    last_accessed_at: float = EPOCH
    created_at: float = 0.0
    updated_at: float = 0.0
    deleted: bool = False

    @staticmethod
    def new(kind: str, title: str, body: str, source: Source,
            importance: float = 0.5) -> "Node":
        validate_kind(kind)
        t = now()
        return Node(
            id=new_id(), kind=kind, title=title, body=body, source=source,
            importance=min(1.0, max(0.0, importance)),
            access_count=0, last_accessed_at=t, created_at=t, updated_at=t,
            deleted=False,
        )

    def validate(self) -> None:
        """Raise ValidationError on rule violation (types.rs:316-351)."""
        validate_kind(self.kind)
        if len(self.title) > 256:
            raise ValidationError("Title exceeds 256 characters")
        if not (0.0 <= self.importance <= 1.0):
            raise ValidationError(
                f"Importance {self.importance} out of range [0.0, 1.0]")
        if len(self.tags) > 32:
            raise ValidationError("More than 32 tags")
        for tag in self.tags:
            if len(tag) > 64:
                raise ValidationError(f"Tag '{tag}' exceeds 64 characters")
            if not _TAG_RE.match(tag):
                raise ValidationError(
                    f"Tag '{tag}' contains invalid characters "
                    f"(only alphanumeric and hyphens allowed)")
            if tag != tag.lower():
                raise ValidationError(f"Tag '{tag}' must be lowercase")

    def record_access(self) -> None:
        """Bump access_count + last_accessed_at (types.rs:355-360)."""
        t = now()
        self.access_count += 1
        self.last_accessed_at = t
        self.updated_at = t

    def to_dict(self) -> Dict[str, Any]:
        return {
            "id": self.id,
            "kind": self.kind,
            "data": {
                "title": self.title,
                "body": self.body,
                "metadata": self.metadata,
                "tags": list(self.tags),
            },
            "embedding": self.embedding,
            "source": self.source.to_dict(),
            "importance": self.importance,
            "access_count": self.access_count,
            "last_accessed_at": self.last_accessed_at,
            "created_at": self.created_at,
            "updated_at": self.updated_at,
            "deleted": self.deleted,
        }

    @staticmethod
    def from_dict(d: Dict[str, Any]) -> "Node":
        data = d.get("data", {})
        return Node(
            id=d["id"], kind=d["kind"],
            title=data.get("title", d.get("title", "")),
            body=data.get("body", d.get("body", "")),
            metadata=data.get("metadata", d.get("metadata", {})) or {},
            tags=list(data.get("tags", d.get("tags", [])) or []),
            embedding=d.get("embedding"),
            source=Source.from_dict(d.get("source", {})),
            importance=float(d.get("importance", 0.5)),
            access_count=int(d.get("access_count", 0)),
            last_accessed_at=float(d.get("last_accessed_at", EPOCH)),
            created_at=float(d.get("created_at", 0.0)),
            updated_at=float(d.get("updated_at", 0.0)),
            deleted=bool(d.get("deleted", False)),
        )


# ---------------------------------------------------------------------------
# Edge
# ---------------------------------------------------------------------------


@dataclass
class Edge:
    id: str
    from_id: str
    to_id: str
    relation: str
    weight: float
    provenance: EdgeProvenance
    created_at: float = 0.0
    updated_at: float = 0.0

    @staticmethod
    def new(from_id: str, to_id: str, relation: str, weight: float,
            provenance: EdgeProvenance) -> "Edge":
        validate_relation(relation)
        t = now()
        return Edge(
            id=new_id(), from_id=from_id, to_id=to_id, relation=relation,
            weight=min(1.0, max(0.0, weight)), provenance=provenance,
            created_at=t, updated_at=t,
        )

    def validate(self) -> None:
        validate_relation(self.relation)
        if self.from_id == self.to_id:
            raise ValidationError("Self-edges are not allowed")
        if not (0.0 <= self.weight <= 1.0):
            raise ValidationError(f"Weight {self.weight} out of range [0.0, 1.0]")

    def update_weight(self, new_weight: float) -> None:
        self.weight = min(1.0, max(0.0, new_weight))
        self.updated_at = now()

    def to_dict(self) -> Dict[str, Any]:
        return {
            "id": self.id, "from": self.from_id, "to": self.to_id,
            "relation": self.relation, "weight": self.weight,
            "provenance": self.provenance.to_dict(),
            "created_at": self.created_at, "updated_at": self.updated_at,
        }

    @staticmethod
    def from_dict(d: Dict[str, Any]) -> "Edge":
        return Edge(
            id=d["id"],
            from_id=d.get("from", d.get("from_id")),
            to_id=d.get("to", d.get("to_id")),
            relation=d["relation"],
            weight=float(d["weight"]),
            provenance=EdgeProvenance.from_dict(d.get("provenance", {"kind": "manual"})),
            created_at=float(d.get("created_at", 0.0)),
            updated_at=float(d.get("updated_at", 0.0)),
        )
