"""The whole step's share of the chip's 16-bit peak, in %: the step's model
operations (``harness.counts.step_flops``: 6 a parameter and token, and
attention's 12 * head_dim a visible pair at each attention layer; recomputed work
not counted) over the window's mean step time (its seconds over its steps), over
989 TFLOP/s."""

from harness import counts


def read(run):
    step = run.window_s / len(run.step_s)
    return 100.0 * counts.step_flops(run.cfg, run.traffic) / step / counts.PEAK_16BIT_FLOPS
