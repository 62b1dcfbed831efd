"""Device kernels a step: the kernels in the profiler's trace of the traced steps
over their number (copies and fills not counted)."""


def read(run):
    if run.trace is None or not run.trace.kernels():
        return None
    return len(run.trace.kernels()) / run.trace.steps
