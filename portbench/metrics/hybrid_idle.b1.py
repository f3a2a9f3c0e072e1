"""Share of the traced sub-window of hybrid calls in which nothing ran
on the device, in percent."""


def read(run):
    t = run.trace
    if t is None or t.busy_s <= 0:
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)
