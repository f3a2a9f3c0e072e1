"""The configuration's least time for one hybrid call's device work
(its vector leg) over the device's busy time per call in the traced
sub-window, in percent."""


def read(run):
    t = run.trace
    if t is None or t.busy_s <= 0:
        return None
    return 100.0 * run.least_s / (t.busy_s / t.calls)
