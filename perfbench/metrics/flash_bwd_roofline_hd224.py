"""The flash-attention backward kernels' share of their roofline at head_dim 224, in %:
``flash_bwd_roofline``'s reading in a cell whose every attention call is at head_dim
224 (zamba2-7b's shared blocks, which run on the head_dim-256 kernels with tensor
maps of 224 columns): the bound at the cell's shapes (``harness.counts.flash_bound_s``
over the configuration's ``attention_calls``) over the device time a step of the
kernels whose names match below.  None where no attention call of the cell is at
head_dim 224, or no kernel matches."""

from harness import counts, spec, trace

MATCH = ("flash_bwd",)
HEAD_DIM = 224


def read(run):
    if run.trace is None:
        return None
    calls = spec.reference(run.cfg).attention_calls(run.cfg, run.traffic)
    if not calls or any(a["hd"] != HEAD_DIM for a in calls):
        return None
    ms = trace.ms_per_step(run.trace, MATCH, ())
    if not ms:
        return None
    return 100.0 * counts.flash_bound_s(run.cfg, run.traffic, backward=True) * 1e3 / ms
