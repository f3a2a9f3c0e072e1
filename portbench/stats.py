"""The arithmetic of rates and tails that the metric readers share."""

from __future__ import annotations

import numpy as np


def rate(ops: int, seconds: float) -> float:
    """Operations per second: all the work over all the time."""
    return ops / seconds


def percentile(values, weights, q: float) -> float:
    """The q-th percentile of `values`, each counted `weights` times (a
    call's latency once for every query in it)."""
    return float(np.percentile(np.repeat(np.asarray(values, np.float64),
                                         np.asarray(weights, np.int64)), q))


def mean(values) -> float:
    return float(np.mean(np.asarray(values, np.float64)))
