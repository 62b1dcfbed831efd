"""Device ms a step in PyTorch's elementwise and reduction kernels (the forward's
and backward's: SwiGLU's, rope's, the residual and gradient sums, the loss's), from
the profiler's trace.  In ``train.qwen2_7b_l8.b2s4096`` they are 32 % of a step's
device time, behind the cuBLAS products' 55 % and ahead of the fused AdamW's 6.7 % and
flash attention's 5.6 %.  AdamW's update is not among them: the port's fused
``repro_adamw`` kernels match no pattern here, and ``adamw_roofline`` reads their
time.  The name patterns are those of ``tools/profile_train_torch.py``'s ``KINDS``
for "reductions" and "elementwise"; a kernel that a pattern of an earlier kind there
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
