"""Median latency of every operation of the window: its call's time on
the host clock, until the answers are on the host."""

from portbench import stats


def read(run):
    return stats.percentile(run.latency_s, run.ops_per_call, 50) * 1e3
