"""Fused RMSNorm, forward and backward: wrappers around ``csrc/rmsnorm.cu`` and
``csrc/rmsnorm_bwd.cu``.

A CUDA tensor launches a kernel or raises; a CPU tensor takes the plain
version.  A call that needs gradients goes through :class:`RMSNorm`, a
``torch.autograd.Function`` that saves x and w (no rstd: the backward recomputes
it from x, as the reference differentiates the formula) and whose backward is the
backward kernel on the card and ``ref.rmsnorm_bwd_reference`` on the CPU.

Decode calls this 57 times a step at (4, 3584), where the kernel runs for ~2 µs
and the host's launch path is the cost, so the CUDA path without gradients is kept
short: the C launcher is bound once and takes one argument block (a
``RmsnormCall`` kept per thread, so threads never share one), the stream is read
as a raw handle, the device index goes to C (which switches devices only when it
must), and only the checks the kernel needs are made -- every input ever refused
still raises, with or without gradients.
"""

from __future__ import annotations

import ctypes
import threading

import torch
from torch.distributed.tensor import DTensor

from repro_torch.kernels import _build
from repro_torch.kernels.ref import rmsnorm_bwd_reference, rmsnorm_reference

#: kernel launches made in this process (CUDA tensors only): forward calls, and
#: backward calls (each one launch of the row kernel and one of the dw sum)
launches = 0
bwd_launches = 0

_fwd = None      # the library's repro_rmsnorm_fwd, bound at the first CUDA call
_stream = None   # device index -> raw handle of its current stream
_local = threading.local()   # .call: (this thread's RmsnormCall, its address)

#: backward: dw partials come from at most this many blocks (a fixed number, so the
#: order of the sum does not depend on the card)
BWD_BLOCKS = 256
_BWD_WARPS_PER_BLOCK = 8   # rows of width <= 1024 take a warp each, eight to a block


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
    """x: (..., d); w: (d,).  Returns x's shape and dtype.  Differentiable in x
    and w on either device."""
    if isinstance(x, DTensor) or isinstance(w, DTensor):
        raise TypeError("rmsnorm takes each rank's local tensors: call it on a "
                        "DTensor through local_map (models.layers.rms_norm)")
    if not x.is_cuda:
        if w.shape != x.shape[-1:]:
            raise ValueError(f"rmsnorm: w {tuple(w.shape)} does not match x "
                             f"{tuple(x.shape)}")
        if w.device != x.device:
            raise ValueError(f"rmsnorm: x on {x.device}, w on {w.device}")
        if torch.is_grad_enabled() and (x.requires_grad or w.requires_grad):
            return RMSNorm.apply(x, w, eps, -1, 0, 0)
        return rmsnorm_reference(x, w, eps)
    if w.dim() != 1 or x.dim() == 0 or w.shape[0] != x.shape[-1]:
        raise ValueError(f"rmsnorm: w {tuple(w.shape)} does not match x "
                         f"{tuple(x.shape)}")
    dev = x.get_device()
    if not w.is_cuda or w.get_device() != dev:
        raise ValueError(f"rmsnorm: x on {x.device}, w on {w.device}")
    xcode = _build.DTYPE_CODES.get(x.dtype)
    if xcode is None:
        raise TypeError(f"rmsnorm: unsupported dtype {x.dtype}")
    wcode = _build.DTYPE_CODES.get(w.dtype)
    if wcode != xcode and wcode != 0:
        raise TypeError(f"rmsnorm: w must be {x.dtype} or float32, "
                        f"got {w.dtype}")
    if not (x.is_contiguous() and w.is_contiguous()):
        raise ValueError("rmsnorm: x and w must be contiguous")
    if torch.is_grad_enabled() and (x.requires_grad or w.requires_grad):
        return RMSNorm.apply(x, w, eps, dev, xcode, wcode)
    return launch_forward(x, w, eps, dev, xcode, wcode)


def launch_forward(x, w, eps, dev, xcode, wcode):
    """Launch the forward kernel on checked CUDA tensors."""
    global launches
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


def bwd_workers(rows: int, d: int) -> int:
    """Rows of the backward's fp32 dw partials for an (rows, d) input: one per
    worker (a warp for d <= 1024, else a block) of at most ``BWD_BLOCKS`` blocks."""
    per_block = _BWD_WARPS_PER_BLOCK if d <= 1024 else 1
    return min(BWD_BLOCKS, -(-rows // per_block)) * per_block


def launch_backward(x, w, dy, eps, dev, xcode, wcode):
    """Launch the backward kernels on CUDA tensors: (dx, dw)."""
    global bwd_launches
    if dy.shape != x.shape:
        raise ValueError(f"rmsnorm backward: dy {tuple(dy.shape)} does not match x "
                         f"{tuple(x.shape)}")
    if not dy.is_cuda or dy.get_device() != dev:
        raise ValueError(f"rmsnorm backward: x on {x.device}, dy on {dy.device}")
    if dy.dtype != x.dtype or not dy.is_contiguous():
        dy = dy.to(x.dtype).contiguous()
    dx, dw = torch.empty_like(x), torch.empty_like(w)
    d = x.shape[-1]
    rows = x.numel() // d if d else 0
    if rows == 0:
        return dx, dw.zero_()
    if _fwd is None:
        _bind()
    workers = bwd_workers(rows, d)
    partial = torch.empty((workers, d), dtype=torch.float32, device=x.device)
    call = _build.RmsnormBwdCall(
        x=x.data_ptr(), w=w.data_ptr(), dy=dy.data_ptr(), dx=dx.data_ptr(),
        dw=dw.data_ptr(), partial=partial.data_ptr(), stream=_stream(dev),
        rows=rows, d=d, eps=eps, workers=workers, x_dtype=xcode, w_dtype=wcode,
        device=dev)
    code = _build.load().repro_rmsnorm_bwd(ctypes.addressof(call))
    if code:
        _build.check(code, "rmsnorm backward")
    bwd_launches += 1
    return dx, dw


class RMSNorm(torch.autograd.Function):
    """RMSNorm with its gradient.  ``dev`` < 0 marks the CPU (plain versions);
    otherwise the card's index and the element-type codes the checks found."""

    @staticmethod
    def forward(ctx, x, w, eps, dev, xcode, wcode):
        ctx.save_for_backward(x, w)
        ctx.args = (eps, dev, xcode, wcode)
        if dev < 0:
            return rmsnorm_reference(x, w, eps)
        return launch_forward(x, w, eps, dev, xcode, wcode)

    @staticmethod
    def backward(ctx, dy):
        x, w = ctx.saved_tensors
        eps, dev, xcode, wcode = ctx.args
        if dev < 0:
            dx, dw = rmsnorm_bwd_reference(x, w, dy, eps)
        else:
            dx, dw = launch_backward(x, w, dy, eps, dev, xcode, wcode)
        return dx, dw, None, None, None, None
