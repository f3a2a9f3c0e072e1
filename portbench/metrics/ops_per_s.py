"""Operations answered in the window over the window's seconds."""

from portbench import stats


def read(run):
    return stats.rate(run.ops, run.window_s)
