"""Device ms a step in the library's matrix products (cuBLAS, called from the
port's layers), from the profiler's trace; the name patterns are those of
``tools/profile_train_torch.py``'s ``KINDS`` for "matrix products"."""

from harness import trace

MATCH = ("gemm", "nvjet", "xmma", "cutlass", "cublas")
SKIP = ("flash_bwd", "flash_fwd", "rmsnorm")


def read(run):
    if run.trace is None:
        return None
    return trace.ms_per_step(run.trace, MATCH, SKIP)
