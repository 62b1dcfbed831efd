"""The device's idle share of the traced window of whole steps, in %: one minus the
union of the intervals in which a device operation ran (overlapping operations
counted once) over the window's length."""


def read(run):
    if run.trace is None or not run.trace.ops or run.trace.window_s <= 0:
        return None
    return 100.0 * (1.0 - run.trace.busy_s / run.trace.window_s)
