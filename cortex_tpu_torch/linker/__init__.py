from .auto_linker import AutoLinker
from .config import (AutoLinkerConfig, ConfigRule, DecayConfig, RuleCondition,
                     has_negation_pattern)
from .decay import DecayEngine
from .dedup import DedupResult, DedupScanner, DuplicatePair
from .metrics import LinkerMetrics
from .rules import (Contradiction, ContradictionDetector, ProposedEdge,
                    StructuralRules, jaccard_similarity, similarity_rule)

__all__ = [
    "AutoLinker", "AutoLinkerConfig", "ConfigRule", "DecayConfig",
    "RuleCondition", "has_negation_pattern", "DecayEngine", "DedupResult",
    "DedupScanner", "DuplicatePair", "LinkerMetrics", "Contradiction",
    "ContradictionDetector", "ProposedEdge", "StructuralRules",
    "jaccard_similarity", "similarity_rule",
]
