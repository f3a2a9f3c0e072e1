"""Link rules: similarity, 6 structural rules, contradiction detection.

Parity: crates/cortex-core/src/linker/rules.rs —
  SimilarityLinkRule (:40-62), StructuralRule variants with default
  weights (:66-268): same_agent 0.3, temporal_proximity 30min/0.4,
  shared_tags >=2 base 0.5 (x(1 + 0.1 per extra), capped at 1.0 —
  rules.rs:181 multiplies the base),
  decision->event same-session led_to 0.6,
  observation->pattern sim>=0.7 instance_of 0.7,
  fact_supersedes Jaccard-title>=0.9 newer->older supersedes 0.9;
  Jaccard word similarity (:271-289);
  ContradictionDetector threshold 0.80 + asymmetric negation ->
  contradicts + Supersede suggestion (:314-380).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Tuple

from ..types import Edge, EdgeProvenance, Node
from ..vector.config import SimilarityConfig
from .config import has_negation_pattern


@dataclass
class ProposedEdge:
    from_id: str
    to_id: str
    relation: str
    weight: float
    provenance: EdgeProvenance

    def to_edge(self) -> Edge:
        return Edge.new(self.from_id, self.to_id, self.relation, self.weight,
                        self.provenance)


def jaccard_similarity(a: str, b: str) -> float:
    """Word-level Jaccard (rules.rs:271-289)."""
    wa = set(a.lower().split())
    wb = set(b.lower().split())
    return _jaccard_sets(wa, wb)


def _jaccard_sets(wa: set, wb: set) -> float:
    if not wa and not wb:
        return 1.0
    if not wa or not wb:
        return 0.0
    return len(wa & wb) / len(wa | wb)


class FeatureCache:
    """Per-cycle cache of per-node derived features. Rule evaluation
    runs per candidate PAIR (batch x k of them per cycle); tag sets,
    title word sets and negation scans are per-NODE, so caching them
    turns O(pairs) text processing into O(nodes)."""

    def __init__(self):
        self._tags: dict = {}
        self._words: dict = {}
        self._neg: dict = {}

    def tags(self, n: Node) -> set:
        v = self._tags.get(n.id)
        if v is None:
            v = set(n.tags)
            self._tags[n.id] = v
        return v

    def title_words(self, n: Node) -> set:
        v = self._words.get(n.id)
        if v is None:
            v = set(n.title.lower().split())
            self._words[n.id] = v
        return v

    def negation(self, n: Node) -> bool:
        v = self._neg.get(n.id)
        if v is None:
            from .config import NEGATION_WORDS
            text = f"{n.title} {n.body}".lower()
            v = any(w in text for w in NEGATION_WORDS)
            self._neg[n.id] = v
        return v


def similarity_rule(node: Node, neighbor: Node, score: float,
                    config: SimilarityConfig) -> Optional[ProposedEdge]:
    if score >= config.auto_link_threshold:
        return ProposedEdge(
            from_id=node.id, to_id=neighbor.id, relation="related_to",
            weight=score, provenance=EdgeProvenance.auto_similarity(score))
    return None


@dataclass
class StructuralRules:
    """The 6 legacy structural rules with reference defaults."""

    same_agent_weight: float = 0.3
    temporal_window_secs: float = 30 * 60
    temporal_weight: float = 0.4
    shared_tags_min: int = 2
    shared_tags_base: float = 0.5
    decision_event_weight: float = 0.6
    obs_pattern_min_sim: float = 0.7
    obs_pattern_weight: float = 0.7
    fact_supersedes_title_sim: float = 0.9
    fact_supersedes_weight: float = 0.9

    def evaluate_all(self, node: Node, other: Node, score: float,
                     cache: Optional[FeatureCache] = None
                     ) -> List[ProposedEdge]:
        out: List[ProposedEdge] = []
        if node.id == other.id:
            return out
        cache = cache or FeatureCache()

        if node.source.agent == other.source.agent:
            out.append(ProposedEdge(
                node.id, other.id, "related_to", self.same_agent_weight,
                EdgeProvenance.auto_structural("same_agent")))

        if abs(node.created_at - other.created_at) <= self.temporal_window_secs:
            out.append(ProposedEdge(
                node.id, other.id, "related_to", self.temporal_weight,
                EdgeProvenance.auto_structural("temporal_proximity")))

        shared = len(cache.tags(node) & cache.tags(other))
        if shared >= self.shared_tags_min:
            w = min(1.0, self.shared_tags_base
                    * (1.0 + (shared - self.shared_tags_min) * 0.1))
            out.append(ProposedEdge(
                node.id, other.id, "related_to", w,
                EdgeProvenance.auto_structural("shared_tags")))

        if (node.kind == "decision" and other.kind == "event"
                and node.source.session is not None
                and node.source.session == other.source.session
                and node.created_at < other.created_at):
            out.append(ProposedEdge(
                node.id, other.id, "led_to", self.decision_event_weight,
                EdgeProvenance.auto_structural("decision_to_event")))

        if (node.kind == "observation" and other.kind == "pattern"
                and score >= self.obs_pattern_min_sim):
            out.append(ProposedEdge(
                node.id, other.id, "instance_of", self.obs_pattern_weight,
                EdgeProvenance.auto_structural("observation_to_pattern")))

        if (node.kind == "fact" and other.kind == "fact"
                and node.created_at > other.created_at
                and _jaccard_sets(cache.title_words(node),
                                  cache.title_words(other))
                >= self.fact_supersedes_title_sim):
            out.append(ProposedEdge(
                node.id, other.id, "supersedes", self.fact_supersedes_weight,
                EdgeProvenance.auto_structural("fact_supersedes")))

        return out


@dataclass
class Contradiction:
    node_a: str
    node_b: str
    similarity: float
    reason: str
    keep: Optional[str] = None      # newer node (Supersede suggestion)
    retire: Optional[str] = None


class ContradictionDetector:
    def __init__(self, threshold: float = 0.80):
        self.threshold = threshold

    def check(self, a: Node, b: Node, similarity: float,
              cache: Optional[FeatureCache] = None
              ) -> Optional[Contradiction]:
        if similarity < self.threshold:
            return None
        if cache is not None:
            if cache.negation(a) == cache.negation(b):
                return None
        elif not has_negation_pattern(a, b):
            return None
        newer, older = (a, b) if a.created_at > b.created_at else (b, a)
        return Contradiction(
            node_a=a.id, node_b=b.id, similarity=similarity,
            reason="Negation pattern detected",
            keep=newer.id, retire=older.id)

    def to_edge(self, c: Contradiction) -> ProposedEdge:
        return ProposedEdge(
            c.node_a, c.node_b, "contradicts", c.similarity,
            EdgeProvenance.auto_contradiction(c.reason))
