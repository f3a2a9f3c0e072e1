"""Write gate: 4-check quality gate on node writes.

Parity: crates/cortex-core/src/gate/mod.rs —
  config defaults (:28-40): conflict .85, duplicate .92, min title 10,
  min body 20, tags required at importance >= .7, per-kind overrides;
  check_substance (:96-231): length floors, body != title, bare URL,
  single word, pure timestamp, kind lexical checks
  (decision/fact/pattern);
  check_specificity (:243+): unresolved leading pronouns, unanchored
  relative time, high-importance body-length floors (>=.9 -> 100 chars,
  >=.8 -> 50), tags at high importance;
  check_conflict (:318+): top-5 similarity probe — duplicate reject
  above .92; same kind+agent above conflict threshold -> duplicate
  reject; same kind other agent -> contradiction flag; search failures
  never block writes;
  check_schema (:390+) -> gate/schema.py.

The conflict check runs on the device index (fused cosine top-k), so
gating a write batch costs one batched search.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np

from ..storage.base import Storage
from ..types import Node
from ..vector.index import VectorIndex
from .schema import KindSchema, SchemaValidator, SchemaViolation

SUBSTANCE = "substance"
SPECIFICITY = "specificity"
CONFLICT = "conflict"
SCHEMA = "schema"

_DECISION_WORDS = ["decided", "chose", "will", "should", "use", "adopt",
                   "switch", "selected", "going to", "opted"]
_FACT_HEDGES = ["i think", "maybe", "probably"]
_PATTERN_WORDS = ["when", "always", "never", "tends to", "pattern",
                  "recurring", "consistently", "typically", "usually"]
_RELATIVE_TERMS = ["yesterday", "last week", "last month", "last year",
                   "this morning", "this afternoon", "this evening",
                   "last night", "earlier today"]
_PRONOUN_STARTS = ["he ", "she ", "they ", "it "]
_TITLE_STOPWORDS = {"The", "A", "An", "This", "That", "These", "Those", "He",
                    "She", "They", "It", "In", "On", "At", "For", "With"}


@dataclass
class KindOverrideConfig:
    min_body_length: Optional[int] = None
    conflict_threshold: Optional[float] = None


@dataclass
class WriteGateConfig:
    enabled: bool = True
    conflict_threshold: float = 0.85
    duplicate_threshold: float = 0.92
    min_title_length: int = 10
    min_body_length: int = 20
    require_tags_above_importance: float = 0.7
    require_body_length_for_importance: bool = True
    overrides: Dict[str, KindOverrideConfig] = field(default_factory=dict)


@dataclass
class GateRejection:
    check: str
    reason: str
    suggestion: str
    existing_node: Optional[str] = None
    existing_title: Optional[str] = None


def _is_pure_url(s: str) -> bool:
    return (s.startswith("http://") or s.startswith("https://")) \
        and " " not in s


def _is_just_timestamp(s: str) -> bool:
    s = s.strip()
    if len(s) >= 8 and s.isdigit():
        return True
    if len(s) >= 10 and s[4:5] == "-" and s[7:8] == "-" \
            and s[:4].isdigit() and s[5:7].isdigit() and s[8:10].isdigit():
        if len(s) == 10:
            return True
        if s[10] == "T":
            return all(c.isdigit() or c in ":.Z+-" for c in s[11:])
    return False


def _has_unresolved_pronouns(title: str, body: str) -> bool:
    body_lower = body.lstrip().lower()
    if not any(body_lower.startswith(p) for p in _PRONOUN_STARTS):
        return False
    title_has_proper = any(
        w[:1].isupper() and w not in _TITLE_STOPWORDS and len(w) > 2
        for w in title.split())
    return not title_has_proper


def _has_unanchored_temporal(title: str, body: str) -> bool:
    tl = title.lower()
    if any(t in tl for t in _RELATIVE_TERMS):
        return True
    start = body[:60].lower()
    return any(start.startswith(t) for t in _RELATIVE_TERMS)


class WriteGate:
    """Stateless check functions; None = pass, GateRejection = reject."""

    @staticmethod
    def check_substance(node: Node,
                        config: WriteGateConfig) -> Optional[GateRejection]:
        ov = config.overrides.get(node.kind)
        min_body = ov.min_body_length if ov and ov.min_body_length is not None \
            else config.min_body_length
        title, body = node.title, node.body

        if len(title) < config.min_title_length:
            return GateRejection(SUBSTANCE,
                f"Title too short ({len(title)} chars, minimum "
                f"{config.min_title_length})",
                "Use a descriptive title that identifies the specific "
                "knowledge being stored")
        if len(body) < min_body:
            return GateRejection(SUBSTANCE,
                f"Body too short ({len(body)} chars, minimum {min_body})",
                "Add more context to make this useful as a standalone memory")
        if body.strip() == title.strip():
            return GateRejection(SUBSTANCE,
                "Body is identical to title — no additional context",
                "Add detail in the body that expands on the title")
        tb = body.strip()
        if _is_pure_url(tb):
            return GateRejection(SUBSTANCE,
                "Body is a bare URL with no context",
                "Add a description of what this URL contains or why it "
                "matters")
        if len(tb.split()) <= 1:
            return GateRejection(SUBSTANCE,
                "Body is a single word — not enough context",
                "Add more context to make this useful as a standalone memory")
        if _is_just_timestamp(tb):
            return GateRejection(SUBSTANCE,
                "Body appears to be just a timestamp — no substantive "
                "content",
                "Add context about what the timestamp refers to")

        bl = body.lower()
        if node.kind == "decision" and \
                not any(w in bl for w in _DECISION_WORDS):
            return GateRejection(SUBSTANCE,
                "Decision nodes must contain an action or choice (e.g., "
                "'decided', 'chose', 'will use', 'should adopt')",
                "Rewrite as a concrete decision: what was decided and why")
        if node.kind == "fact" and \
                any(bl.startswith(h) for h in _FACT_HEDGES):
            return GateRejection(SUBSTANCE,
                "Fact nodes must not start with hedging language ('I think', "
                "'maybe', 'probably') — use kind=observation instead",
                "Either state as a confirmed fact or change kind to "
                "'observation'")
        if node.kind == "pattern" and \
                not any(w in bl for w in _PATTERN_WORDS):
            return GateRejection(SUBSTANCE,
                "Pattern nodes must reference a recurring behavior (e.g., "
                "'when', 'always', 'tends to', 'pattern')",
                "Describe the recurring behavior pattern explicitly")
        return None

    @staticmethod
    def check_specificity(node: Node,
                          config: WriteGateConfig) -> Optional[GateRejection]:
        title, body, imp = node.title, node.body, node.importance
        if _has_unresolved_pronouns(title, body):
            return GateRejection(SPECIFICITY,
                "Body starts with an unresolved pronoun ('He', 'She', "
                "'They', 'It') — the reference is ambiguous without "
                "conversation context",
                "Replace the pronoun with the actual entity name")
        if _has_unanchored_temporal(title, body):
            return GateRejection(SPECIFICITY,
                "Title or body uses a relative time reference without "
                "anchoring (e.g., 'yesterday', 'last week') — ambiguous "
                "outside original context",
                "Use a specific date or event anchor instead of relative "
                "time references")
        if config.require_body_length_for_importance:
            if imp >= 0.9 and len(body) < 100:
                return GateRejection(SPECIFICITY,
                    f"High importance ({imp:.1f}) but body is only "
                    f"{len(body)} chars",
                    "Either add more detail or reduce importance")
            if imp >= 0.8 and len(body) < 50:
                return GateRejection(SPECIFICITY,
                    f"High importance ({imp:.1f}) but body is only "
                    f"{len(body)} chars",
                    "Either add more detail or reduce importance")
        if imp >= config.require_tags_above_importance and not node.tags:
            return GateRejection(SPECIFICITY,
                f"High importance ({imp:.1f}) nodes should have tags for "
                "discoverability",
                "Add relevant tags to make this node findable")
        return None

    @staticmethod
    def check_conflict(node: Node, embedding: np.ndarray,
                       index: VectorIndex, storage: Storage,
                       config: WriteGateConfig) -> Optional[GateRejection]:
        ov = config.overrides.get(node.kind)
        conflict_thr = ov.conflict_threshold \
            if ov and ov.conflict_threshold is not None \
            else config.conflict_threshold
        try:
            # refine=False: duplicates/conflicts (>= 0.85) rank at the
            # top of any candidate scan — graph expansion can't surface
            # one the scan missed, and this check runs on every write
            hits = index.search(np.asarray(embedding, np.float32), 5,
                                refine=False)
        except Exception:  # noqa: BLE001 — search errors never block writes
            return None
        for nid, score in hits:
            if nid == node.id:
                continue
            if score > config.duplicate_threshold:
                existing = storage.get_node(nid)
                if existing is not None:
                    return GateRejection(CONFLICT,
                        f"Near-duplicate found (similarity: {score:.2f})",
                        "Update the existing node instead of creating a "
                        "duplicate",
                        existing_node=existing.id,
                        existing_title=existing.title)
            if score > conflict_thr:
                existing = storage.get_node(nid)
                if existing is None:
                    continue
                same_kind = existing.kind == node.kind
                same_agent = existing.source.agent == node.source.agent
                if same_kind and same_agent:
                    return GateRejection(CONFLICT,
                        f"Near-duplicate found (similarity: {score:.2f})",
                        "Update the existing node instead of creating a "
                        "duplicate",
                        existing_node=existing.id,
                        existing_title=existing.title)
                if same_kind:
                    return GateRejection(CONFLICT,
                        f"Potential contradiction with existing node "
                        f"(similarity: {score:.2f})",
                        "If this supersedes the existing node, use "
                        "PATCH /nodes/:id or add a 'supersedes' edge",
                        existing_node=existing.id,
                        existing_title=existing.title)
        return None

    @staticmethod
    def check_schema(node: Node,
                     validator: SchemaValidator) -> Optional[GateRejection]:
        violations = validator.validate(node)
        if not violations:
            return None
        return GateRejection(SCHEMA,
            "Schema validation failed: "
            + "; ".join(str(v) for v in violations),
            "Ensure node metadata matches the schema defined for this kind")

    @classmethod
    def check_all(cls, node: Node, embedding: Optional[np.ndarray],
                  index: Optional[VectorIndex], storage: Storage,
                  config: WriteGateConfig,
                  validator: SchemaValidator,
                  skip_quality: bool = False) -> Optional[GateRejection]:
        """Run the full pipeline in reference order; `skip_quality` is the
        `?gate=skip` bypass — schema still enforced (routes.rs:468)."""
        if not skip_quality and config.enabled:
            r = cls.check_substance(node, config)
            if r:
                return r
            r = cls.check_specificity(node, config)
            if r:
                return r
            if embedding is not None and index is not None:
                r = cls.check_conflict(node, embedding, index, storage, config)
                if r:
                    return r
        return cls.check_schema(node, validator)


__all__ = [
    "WriteGate", "WriteGateConfig", "KindOverrideConfig", "GateRejection",
    "SchemaValidator", "KindSchema", "SchemaViolation",
    "SUBSTANCE", "SPECIFICITY", "CONFLICT", "SCHEMA",
]
