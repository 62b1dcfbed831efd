"""The flash-attention forward kernels' share of their roofline, in %: the least
time a step's forward calls could take at the cell's shapes
(``harness.counts.flash_bound_s``: the larger of 4 * head_dim operations a visible
pair at 989 TFLOP/s and each byte read or written once at 3.35 TB/s, for each
call) over the device time of the kernels whose names match below, a step."""

from harness import counts, trace

MATCH = ("flash_fwd",)


def read(run):
    if run.trace is None:
        return None
    ms = trace.ms_per_step(run.trace, MATCH, ())
    if not ms:
        return None
    return 100.0 * counts.flash_bound_s(run.cfg, run.traffic, backward=False) * 1e3 / ms
