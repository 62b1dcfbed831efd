"""The fused AdamW kernels' share of their roofline, in %: the least time a step's
optimizer could take on the chip, every byte it must move at 3.35 TB/s, over the
device time a step of the kernels whose lowercased name holds ``repro_adamw``.

The bytes a parameter: its gradient read twice (the global norm, then the update),
the parameter read and written once, and the two float32 moments each read and
written once (16 bytes).  The gradient's type is the parameter's, as the cell runs
one microbatch.  In ``train.qwen2_7b_l8.b2s4096`` that is 24 bytes over 2.409 G
parameters: 17.26 ms.  The parameters are those the configuration's reference module
counts (``params_run``).  None where no kernel matches (a program without the fused
kernels)."""

from harness import counts, reference, spec, trace

MATCH = ("repro_adamw",)


def bound_s(cfg: dict) -> float:
    elem = reference.DTYPES[cfg["param_dtype"]].itemsize
    return spec.reference(cfg).params_run(cfg) * (2 * elem + 2 * elem + 16) \
        / counts.PEAK_BYTES_PER_S


def read(run):
    if run.trace is None:
        return None
    ms = trace.ms_per_step(run.trace, MATCH, ())
    if not ms:
        return None
    return 100.0 * bound_s(run.cfg) * 1e3 / ms
