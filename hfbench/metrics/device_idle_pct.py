"""Device: the share of the traced window in which no kernel or copy ran
on the card (one minus the union of their intervals in the profiler's
trace, over the window)."""


def read(run):
    if not run.ops:
        return None
    return 100 * (1 - run.busy_s / run.window_s)
