"""Mean host time from the async entry's return until its callable
yields the answers: the device wait, the copy and the host finish."""

from portbench import stats


def read(run):
    if run.finish_s is None:
        return None
    return stats.mean(run.finish_s) * 1e3
