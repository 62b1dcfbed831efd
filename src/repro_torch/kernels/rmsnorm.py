"""Fused RMSNorm: wrapper around the CUDA kernel in ``csrc/rmsnorm.cu``.

A CUDA tensor launches the kernel or raises; a CPU tensor takes the plain
version.  Forward only: the backward kernel comes with the training path.

Decode calls this 57 times a step at (4, 3584), where the kernel runs for ~2 µs
and the host's launch path is the cost, so the CUDA path is kept short: the C
launcher is bound once and takes one argument block (a ``RmsnormCall`` kept per
thread, so threads never share one), the stream is read as a raw handle, the
device index goes to C (which switches devices only when it must), and only the
checks the kernel needs are made -- every input ever refused still raises.
"""

from __future__ import annotations

import ctypes
import threading

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import rmsnorm_reference

#: kernel launches made by :func:`rmsnorm` in this process (CUDA tensors only)
launches = 0

_fwd = None      # the library's repro_rmsnorm_fwd, bound at the first CUDA call
_stream = None   # device index -> raw handle of its current stream
_local = threading.local()   # .call: (this thread's RmsnormCall, its address)


def _bind() -> None:
    global _fwd, _stream
    _stream = torch._C._cuda_getCurrentRawStream   # the capture stream under graph capture
    _fwd = _build.load().repro_rmsnorm_fwd


def _thread_call():
    if _fwd is None:
        _bind()
    call = _build.RmsnormCall()
    _local.call = (call, ctypes.addressof(call))
    return _local.call


def rmsnorm(x: torch.Tensor, w: torch.Tensor, *,
            eps: float = 1e-6) -> torch.Tensor:
    """x: (..., d); w: (d,).  Returns x's shape and dtype."""
    global launches
    if not x.is_cuda:
        if w.shape != x.shape[-1:]:
            raise ValueError(f"rmsnorm: w {tuple(w.shape)} does not match x "
                             f"{tuple(x.shape)}")
        if w.device != x.device:
            raise ValueError(f"rmsnorm: x on {x.device}, w on {w.device}")
        return rmsnorm_reference(x, w, eps)
    if w.dim() != 1 or x.dim() == 0 or w.shape[0] != x.shape[-1]:
        raise ValueError(f"rmsnorm: w {tuple(w.shape)} does not match x "
                         f"{tuple(x.shape)}")
    dev = x.get_device()
    if not w.is_cuda or w.get_device() != dev:
        raise ValueError(f"rmsnorm: x on {x.device}, w on {w.device}")
    if torch.is_grad_enabled() and (x.requires_grad or w.requires_grad):
        raise RuntimeError("rmsnorm: the kernel is forward-only; call it "
                           "under torch.no_grad()")
    xcode = _build.DTYPE_CODES.get(x.dtype)
    if xcode is None:
        raise TypeError(f"rmsnorm: unsupported dtype {x.dtype}")
    wcode = _build.DTYPE_CODES.get(w.dtype)
    if wcode != xcode and wcode != 0:
        raise TypeError(f"rmsnorm: w must be {x.dtype} or float32, "
                        f"got {w.dtype}")
    if not (x.is_contiguous() and w.is_contiguous()):
        raise ValueError("rmsnorm: x and w must be contiguous")
    y = torch.empty_like(x)
    n = x.numel()
    if n == 0:
        return y
    try:
        call, addr = _local.call
    except AttributeError:
        call, addr = _thread_call()
    d = x.shape[-1]
    call.x, call.w, call.y = x.data_ptr(), w.data_ptr(), y.data_ptr()
    call.stream = _stream(dev)
    call.rows, call.d, call.eps = n // d, d, eps
    call.x_dtype, call.w_dtype, call.device = xcode, wcode, dev
    code = _fwd(addr)
    if code:
        _build.check(code, "rmsnorm")
    launches += 1
    return y
