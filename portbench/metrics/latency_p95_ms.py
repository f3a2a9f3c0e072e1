"""95th percentile of the latency of every operation of the window."""

from portbench import stats


def read(run):
    return stats.percentile(run.latency_s, run.ops_per_call, 95) * 1e3
