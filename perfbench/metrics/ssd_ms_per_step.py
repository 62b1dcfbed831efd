"""Device ms a step in the chunked SSD's kernels (``csrc/ssd.cu``, forward and
backward), from the profiler's trace: every kernel whose lowercased name holds
``repro_ssd``.  In ``train.zamba2_7b_l18.b2s4096`` they run at each of the 18 Mamba2
layers, three kernels forward and six backward a layer.  None where no kernel
matches: a program whose SSD is PyTorch's elementwise work and float32 products,
which ``elementwise_ms_per_step`` and ``matmul_ms_per_step`` read instead."""

from harness import trace

MATCH = ("repro_ssd",)


def read(run):
    if run.trace is None:
        return None
    return trace.ms_per_step(run.trace, MATCH, ())
