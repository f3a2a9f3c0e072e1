"""Auto-linker configuration: decay params + user-defined TOML rules.

Parity: crates/cortex-core/src/linker/config.rs —
  AutoLinkerConfig defaults (:57-76), DecayConfig (:167-201),
  ConfigRule (:261-378), RuleCondition 10 variants (:384-516),
  body-field matchers (:530-568), negation detection (:570-590),
  legacy rules auto-disabled when config rules present (:123-125).
"""

from __future__ import annotations

import json
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

from ..errors import ValidationError
from ..types import Node, validate_kind, validate_relation
from ..vector.config import SimilarityConfig

NEGATION_WORDS = ["not", "never", "no longer", "stopped", "removed",
                  "deprecated", "replaced", "obsolete"]


def has_negation_pattern(a: Node, b: Node) -> bool:
    """True when exactly one of the two nodes carries negation language."""
    a_text = f"{a.title} {a.body}".lower()
    b_text = f"{b.title} {b.body}".lower()
    a_has = any(w in a_text for w in NEGATION_WORDS)
    b_has = any(w in b_text for w in NEGATION_WORDS)
    return a_has != b_has


@dataclass
class DecayConfig:
    daily_decay_rate: float = 0.01
    prune_threshold: float = 0.1
    delete_threshold: float = 0.05
    importance_shield: float = 0.8
    access_reinforcement_days: float = 7.0
    exempt_manual: bool = True


@dataclass
class RuleCondition:
    """Tagged condition; `type` selects the variant."""

    type: str = "always"
    threshold: float = 0.0            # min_similarity
    min_shared: int = 1               # shared_tags
    window_minutes: int = 30          # temporal_proximity
    field: str = ""                   # body_field_ref / body_field_contains
    match_field: str = ""
    tag_prefix: str = ""              # tag_references_title

    VALID_TYPES = ("always", "min_similarity", "shared_tags", "same_agent",
                   "temporal_proximity", "newer_than", "body_field_ref",
                   "body_field_contains", "tag_references_title",
                   "negation_detected")

    def validate(self, rule_name: str) -> None:
        if self.type not in self.VALID_TYPES:
            raise ValidationError(
                f"Rule '{rule_name}' has unknown condition type '{self.type}'")
        if self.type == "min_similarity" and not (0.0 <= self.threshold <= 1.0):
            raise ValidationError(
                f"Rule '{rule_name}' min_similarity threshold must be in [0,1]")
        if self.type == "shared_tags" and self.min_shared <= 0:
            raise ValidationError(
                f"Rule '{rule_name}' min_shared must be > 0")
        if self.type == "temporal_proximity" and self.window_minutes <= 0:
            raise ValidationError(
                f"Rule '{rule_name}' window_minutes must be > 0")
        if self.type in ("body_field_ref", "body_field_contains") and \
                (not self.field or not self.match_field):
            raise ValidationError(
                f"Rule '{rule_name}' {self.type} needs field and match_field")
        if self.type == "tag_references_title" and not self.tag_prefix:
            raise ValidationError(
                f"Rule '{rule_name}' tag_prefix cannot be empty")

    def evaluate(self, frm: Node, to: Node, similarity: float) -> bool:
        t = self.type
        if t == "always":
            return True
        if t == "min_similarity":
            return similarity >= self.threshold
        if t == "shared_tags":
            return len(set(frm.tags) & set(to.tags)) >= self.min_shared
        if t == "same_agent":
            return frm.source.agent == to.source.agent
        if t == "temporal_proximity":
            return abs(frm.created_at - to.created_at) <= \
                self.window_minutes * 60
        if t == "newer_than":
            return frm.created_at > to.created_at
        if t == "body_field_ref":
            v = _body_field(frm, self.field)
            target = _resolve_match_field(to, self.match_field)
            return (isinstance(v, str) and target is not None
                    and v == target)
        if t == "body_field_contains":
            v = _body_field(frm, self.field)
            target = _resolve_match_field(to, self.match_field)
            return (isinstance(v, list) and target is not None
                    and target in [x for x in v if isinstance(x, str)])
        if t == "tag_references_title":
            return f"{self.tag_prefix}{to.title}" in frm.tags
        if t == "negation_detected":
            return has_negation_pattern(frm, to)
        return False

    @staticmethod
    def from_dict(d: Dict[str, Any]) -> "RuleCondition":
        return RuleCondition(
            type=d.get("type", "always"),
            threshold=float(d.get("threshold", 0.0)),
            min_shared=int(d.get("min_shared", 1)),
            window_minutes=int(d.get("window_minutes", 30)),
            field=d.get("field", ""),
            match_field=d.get("match_field", ""),
            tag_prefix=d.get("tag_prefix", ""),
        )


def _body_field(node: Node, fld: str) -> Any:
    try:
        body = json.loads(node.body)
    except (json.JSONDecodeError, TypeError):
        return None
    if not isinstance(body, dict):
        return None
    return body.get(fld)


def _resolve_match_field(node: Node, match_field: str) -> Optional[str]:
    if match_field == "title":
        return node.title
    if match_field == "id":
        return node.id
    v = _body_field(node, match_field)
    return v if isinstance(v, str) else None


@dataclass
class ConfigRule:
    name: str
    from_kind: str
    to_kind: str
    relation: str
    weight: float = 0.8
    weight_from_score: bool = False
    bidirectional: bool = False
    condition: RuleCondition = field(default_factory=RuleCondition)

    def validate(self) -> None:
        if not self.name:
            raise ValidationError("Rule name cannot be empty")
        try:
            validate_kind(self.from_kind)
            validate_kind(self.to_kind)
            validate_relation(self.relation)
        except ValidationError as e:
            raise ValidationError(f"Rule '{self.name}': {e}") from e
        if not (0.0 <= self.weight <= 1.0):
            raise ValidationError(
                f"Rule '{self.name}' weight must be between 0.0 and 1.0")
        self.condition.validate(self.name)

    def evaluate(self, node: Node, neighbor: Node, similarity: float):
        from .rules import ProposedEdge       # local import avoids cycle
        from ..types import EdgeProvenance
        out: List[ProposedEdge] = []
        if node.kind != self.from_kind or neighbor.kind != self.to_kind:
            return out
        if node.id == neighbor.id:
            return out
        if not self.condition.evaluate(node, neighbor, similarity):
            return out
        w = similarity if self.weight_from_score else self.weight
        prov = EdgeProvenance.auto_structural(self.name)
        out.append(ProposedEdge(from_id=node.id, to_id=neighbor.id,
                                relation=self.relation, weight=w,
                                provenance=prov))
        if self.bidirectional:
            out.append(ProposedEdge(from_id=neighbor.id, to_id=node.id,
                                    relation=self.relation, weight=w,
                                    provenance=prov))
        return out

    @staticmethod
    def from_dict(d: Dict[str, Any]) -> "ConfigRule":
        return ConfigRule(
            name=d.get("name", ""),
            from_kind=d.get("from_kind", ""),
            to_kind=d.get("to_kind", ""),
            relation=d.get("relation", ""),
            weight=float(d.get("weight", 0.8)),
            weight_from_score=bool(d.get("weight_from_score", False)),
            bidirectional=bool(d.get("bidirectional", False)),
            condition=RuleCondition.from_dict(d.get("condition", {})),
        )


@dataclass
class AutoLinkerConfig:
    interval_secs: float = 60.0
    similarity: SimilarityConfig = field(default_factory=SimilarityConfig)
    decay_every_n_cycles: int = 60
    dedup_every_n_cycles: int = 360
    max_nodes_per_cycle: int = 500
    max_edges_per_cycle: int = 2000
    max_edges_per_node: int = 50
    generic_content_threshold: int = 30
    run_on_startup: bool = True
    decay: DecayConfig = field(default_factory=DecayConfig)
    #: run full decay sweeps in a separate OS process (file-backed
    #: sqlite stores only): at 10M+ edges a sweep is minutes of
    #: CPU-bound host work whose GIL traffic convoys the serving
    #: event loop in-process; the worker gets fair OS scheduling (a
    #: spare core on real hosts). Inline fallback on worker failure
    #: and for :memory: stores.
    decay_in_subprocess: bool = True
    embedding_model: str = "BAAI/bge-small-en-v1.5"
    rules: List[ConfigRule] = field(default_factory=list)
    legacy_rules_enabled: Optional[bool] = None
    candidate_k: int = 100            # per-node ANN candidates (auto_linker.rs:221)

    def use_legacy_rules(self) -> bool:
        """Legacy structural rules auto-disable once config rules exist
        (config.rs:123-125)."""
        if self.legacy_rules_enabled is not None:
            return self.legacy_rules_enabled
        return len(self.rules) == 0

    def validate(self) -> None:
        self.similarity.validate()
        seen = set()
        for r in self.rules:
            r.validate()
            if r.name in seen:            # config.rs:154 duplicate gate
                raise ValidationError(f"Duplicate rule name: '{r.name}'")
            seen.add(r.name)
