"""Query-time score decay with access-echo boost (host numpy).

Ported as it is from cortex_tpu/vector/scoring.py: the port imports
nothing of cortex_tpu.

Formula parity (crates/cortex-core/src/vector/scoring.rs:22-114):

    days_idle        = max(0, now - last_accessed_at) / 86400
    kind_rate        = by_kind.get(kind, daily_rate)
    temporal_factor  = max(exp(-kind_rate * min(days_idle, max_age_days)),
                           min_factor)
    echo_factor      = min(1 + access_count * echo_weight, echo_cap)
    final            = raw*(1-w) + raw*temporal*echo*w      (w = recency_bias)

The batch form is a pure vectorized op over candidate arrays, applied
on the search result batch.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Sequence

import numpy as np

from ..types import Node


@dataclass
class ScoreDecayConfig:
    enabled: bool = True
    daily_rate: float = 0.02
    max_age_days: float = 365.0
    min_factor: float = 0.1
    echo_weight: float = 0.05
    echo_cap: float = 2.0
    recency_weight: float = 0.15
    by_kind: Dict[str, float] = field(default_factory=lambda: {
        "event": 0.05,
        "observation": 0.04,
        "decision": 0.005,
        "pattern": 0.005,
        "fact": 0.01,
        "preference": 0.005,
    })


def decay_factors(cfg: ScoreDecayConfig, *, now: float,
                  last_accessed_at: np.ndarray, access_count: np.ndarray,
                  kind_rates: np.ndarray) -> np.ndarray:
    """temporal*echo multiplier per candidate, vectorized."""
    days_idle = np.maximum(now - last_accessed_at, 0.0) / 86_400.0
    eff = np.minimum(days_idle, cfg.max_age_days)
    temporal = np.maximum(np.exp(-kind_rates * eff), cfg.min_factor)
    echo = np.minimum(1.0 + access_count * cfg.echo_weight, cfg.echo_cap)
    return temporal * echo


def apply_score_decay_batch(cfg: ScoreDecayConfig, raw_scores: np.ndarray,
                            nodes: Sequence[Node], *, now: float,
                            recency_bias: float | None = None) -> np.ndarray:
    w = cfg.recency_weight if recency_bias is None else recency_bias
    if not cfg.enabled or w == 0.0 or len(nodes) == 0:
        return np.asarray(raw_scores, np.float32)
    last = np.array([n.last_accessed_at for n in nodes], np.float64)
    acc = np.array([n.access_count for n in nodes], np.float64)
    rates = np.array([cfg.by_kind.get(n.kind, cfg.daily_rate) for n in nodes],
                     np.float64)
    f = decay_factors(cfg, now=now, last_accessed_at=last, access_count=acc,
                      kind_rates=rates)
    raw = np.asarray(raw_scores, np.float64)
    return (raw * (1.0 - w) + raw * f * w).astype(np.float32)


def apply_score_decay(node: Node, raw_score: float, cfg: ScoreDecayConfig,
                      recency_bias: float | None = None,
                      *, now: float) -> float:
    return float(apply_score_decay_batch(
        cfg, np.array([raw_score]), [node], now=now,
        recency_bias=recency_bias)[0])
