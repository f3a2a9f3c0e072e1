from .model import (PromptContent, PromptInfo, PromptVersionInfo,
                    ResolvedPrompt)
from .resolver import PromptResolver
from .rollback import (ActiveDeploymentInfo, RollbackConfig, RollbackMonitor,
                       RollbackResult, RollbackStatus, RollbackTrigger,
                       compute_baseline_stats)
from .selection import (ContextSignals, context_fit, epsilon_greedy_pick,
                        observation_score, score_variant, update_edge_weight)

__all__ = [
    "PromptContent", "PromptInfo", "PromptVersionInfo", "ResolvedPrompt",
    "PromptResolver", "ActiveDeploymentInfo", "RollbackConfig",
    "RollbackMonitor", "RollbackResult", "RollbackStatus", "RollbackTrigger",
    "compute_baseline_stats", "ContextSignals", "context_fit",
    "epsilon_greedy_pick", "observation_score", "score_variant",
    "update_edge_weight",
]
