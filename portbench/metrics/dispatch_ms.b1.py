"""Mean host time from the call of the async entry to its return:
index entry and dispatch."""

from portbench import stats


def read(run):
    if run.dispatch_s is None:
        return None
    return stats.mean(run.dispatch_s) * 1e3
