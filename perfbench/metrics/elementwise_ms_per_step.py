"""Device ms a step in PyTorch's elementwise and reduction kernels (AdamW's passes,
SwiGLU's, rope's, the loss's), from the profiler's trace.  The
name patterns are those of ``tools/profile_train_torch.py``'s ``KINDS`` for
"reductions" and "elementwise"; a kernel that a pattern of an earlier kind there
matches (the port's own kernels, the products, the embedding) is not counted."""

from harness import trace

MATCH = ("reduce", "norm_kernel", "elementwise", "vectorized", "unrolled", "pointwise",
         "copy", "fill", "cat", "index")
SKIP = ("flash_bwd", "flash_fwd", "rmsnorm", "gemm", "nvjet", "xmma", "cutlass",
        "cublas", "embedding")


def read(run):
    if run.trace is None:
        return None
    return trace.ms_per_step(run.trace, MATCH, SKIP)
