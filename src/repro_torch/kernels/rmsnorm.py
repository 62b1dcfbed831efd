"""Fused RMSNorm: wrapper around the CUDA kernel in ``csrc/rmsnorm.cu``.

A CUDA tensor launches the kernel or raises; a CPU tensor takes the plain
version.  Forward only: the backward kernel comes with the training path.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import rmsnorm_reference

#: kernel launches made by :func:`rmsnorm` in this process (CUDA tensors only)
launches = 0


def rmsnorm(x: torch.Tensor, w: torch.Tensor, *,
            eps: float = 1e-6) -> torch.Tensor:
    """x: (..., d); w: (d,).  Returns x's shape and dtype."""
    global launches
    if w.shape != x.shape[-1:]:
        raise ValueError(f"rmsnorm: w {tuple(w.shape)} does not match x "
                         f"{tuple(x.shape)}")
    if w.device != x.device:
        raise ValueError(f"rmsnorm: x on {x.device}, w on {w.device}")
    if not x.is_cuda:
        return rmsnorm_reference(x, w, eps)
    if torch.is_grad_enabled() and (x.requires_grad or w.requires_grad):
        raise RuntimeError("rmsnorm: the kernel is forward-only; call it "
                           "under torch.no_grad()")
    if x.dtype not in _build.DTYPE_CODES:
        raise TypeError(f"rmsnorm: unsupported dtype {x.dtype}")
    if w.dtype not in (x.dtype, torch.float32):
        raise TypeError(f"rmsnorm: w must be {x.dtype} or float32, "
                        f"got {w.dtype}")
    if not x.is_contiguous() or not w.is_contiguous():
        raise ValueError("rmsnorm: x and w must be contiguous")
    d = x.shape[-1]
    rows = x.numel() // d if d else 0
    y = torch.empty_like(x)
    if rows == 0:
        return y
    lib = _build.load()
    with _build.on_device(x.device):
        code = lib.repro_rmsnorm_fwd(
            x.data_ptr(), w.data_ptr(), y.data_ptr(), rows, d, float(eps),
            _build.DTYPE_CODES[x.dtype], _build.DTYPE_CODES[w.dtype],
            torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(code, "rmsnorm")
    launches += 1
    return y
