"""The flash-attention backward kernels' share of their roofline, in %: as
``flash_fwd_roofline`` with 10 * head_dim operations a visible pair, the
backward's bytes, and every kernel of the backward (its prep, its pass, its dq cast)
by the name pattern below."""

from harness import counts, trace

MATCH = ("flash_bwd",)


def read(run):
    if run.trace is None:
        return None
    ms = trace.ms_per_step(run.trace, MATCH, ())
    if not ms:
        return None
    return 100.0 * counts.flash_bound_s(run.cfg, run.traffic, backward=True) * 1e3 / ms
