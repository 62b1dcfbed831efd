"""Fused attention, forward and backward: wrappers around ``csrc/flash_attention*.cu``.

A CUDA tensor launches a kernel or raises; a CPU tensor takes the plain
version.  A call that needs gradients goes through :class:`FlashAttention`, a
``torch.autograd.Function``: on the card its forward launches the forward kernel
with the per-row log-sum-exp ``lse`` written beside the output, and its backward
launches the backward kernels (``csrc/flash_attention_bwd_sm90.cu``: D, then one
pass for dk, dv and dq, at head_dim 256 one for dk and dv and one for dq; or
``csrc/flash_attention_bwd.cu``: D, then dk/dv, then dq); on the CPU both are the
plain versions of ``ref``.  A call without
gradients (serving) launches the forward kernel alone and writes no ``lse``.

Which kernel a CUDA call launches is the library's own rule (``variant``,
``bwd_variant``): 16-bit inputs take the TMA + wgmma kernels at head_dim 64, 80,
128 and 256, forward and backward, the mma.sync kernels at 16 and 32; float32 the
scalar kernels.  A head_dim compiled into neither direction raises.  A variant that cannot run (a tensor map that cannot be encoded, a refused
launch) raises; no other variant stands in for it.
"""

from __future__ import annotations

import ctypes

import torch
from torch.distributed.tensor import DTensor

from repro_torch.kernels import _build
from repro_torch.kernels.ref import (flash_attention_bwd_reference,
                                     flash_attention_lse_reference, mha_reference)

#: head_dims compiled in (``kHeadDims`` / ``kBwdHeadDims`` of ``csrc/flash_attention.cuh``)
HEAD_DIMS = (16, 32, 64, 80, 128, 256)
BWD_HEAD_DIMS = (16, 32, 64, 80, 128, 256)
#: the C interface's codes 0, 1, 2, forward and backward
VARIANTS = ("scalar", "mma_sync", "sm90_wgmma")
#: the wgmma backward pads its per-row scratch to a multiple of this many query rows
#: (``kSqPad`` of ``csrc/flash_attention.cuh``)
BWD_SQ_PAD = 128
#: the head_dim at which the wgmma backward computes dq in a pass of its own, with no
#: float32 accumulator (``kDqPassHeadDim`` of ``csrc/flash_attention.cuh``)
BWD_DQ_PASS_HEAD_DIM = 256

#: kernel launches in this process (CUDA tensors only): forward calls in all and by
#: the kernel that ran, and backward calls likewise (one a call, whatever auxiliary
#: kernels -- D, the dq accumulator's prep and cast -- it runs)
launches = 0
launches_by_variant = dict.fromkeys(VARIANTS, 0)
bwd_launches = 0
bwd_launches_by_variant = dict.fromkeys(VARIANTS, 0)

_fwd = None        # the library's repro_flash_attention_fwd, bound at first use
_stream = None     # device index -> raw handle of its current stream
_variant: dict[tuple[int, int], str] = {}   # (dtype code, hd) -> variant
_bwd_variant: dict[tuple[int, int], str] = {}   # the same for the backward


def _bind() -> None:
    global _fwd, _stream
    _stream = torch._C._cuda_getCurrentRawStream   # the capture stream under graph capture
    _fwd = _build.load().repro_flash_attention_fwd


def variant(dtype: torch.dtype, hd: int) -> str:
    """The kernel that a CUDA call with this element type and head_dim launches,
    as the library's dispatch decides it (builds the library at first use)."""
    key = (_build.DTYPE_CODES[dtype], hd)
    if key not in _variant:
        code = _build.load().repro_flash_attention_variant(hd, key[0])
        if code < 0:
            raise ValueError(f"flash_attention: no kernel for {dtype} at "
                             f"head_dim {hd}")
        _variant[key] = VARIANTS[code]
    return _variant[key]


def bwd_variant(dtype: torch.dtype, hd: int) -> str:
    """The backward kernels that a CUDA call of this type and head_dim launches."""
    key = (_build.DTYPE_CODES[dtype], hd)
    if key not in _bwd_variant:
        code = _build.load().repro_flash_attention_bwd_variant(hd, key[0])
        if code < 0:
            raise ValueError(f"flash_attention: no backward kernel for {dtype} at "
                             f"head_dim {hd}")
        _bwd_variant[key] = VARIANTS[code]
    return _bwd_variant[key]


def _check_layout(name: str, t: torch.Tensor) -> None:
    if t.stride(-1) != 1:
        raise ValueError(f"flash_attention: {name}'s head_dim stride must be 1")
    if t.element_size() == 2 and (
            t.data_ptr() % 16 or any(s % 8 for s in t.stride()[:-1])):
        raise ValueError(f"flash_attention: {name}'s rows must start on "
                         "16-byte boundaries")


def _layout_ok(t: torch.Tensor) -> bool:
    try:
        _check_layout("", t)
    except ValueError:
        return False
    return True


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0,
                    softcap: float = 0.0) -> torch.Tensor:
    """q: (B, Sq, H, hd); k, v: (B, Skv, KV, hd).  Returns (B, Sq, H, hd).

    Queries are aligned to the end of the keys (query i sits at position
    ``i + Skv - Sq``).  With a causal mask or a window, ``Sq <= Skv`` is required
    on either device: with more queries than keys the first rows would see no key
    at all (where the reference's kernel gives zeros and its oracle the mean of v).
    Without either mask the positions are never read, every row sees every key,
    and any ``Sq`` is taken (cross-attention to a shorter memory).
    Differentiable in q, k and v on either device.
    """
    if any(isinstance(t, DTensor) for t in (q, k, v)):
        raise TypeError("flash_attention takes each rank's local tensors: call it on a "
                        "DTensor through local_map (models.layers.mha)")
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError(f"flash_attention: bad shapes q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}, v {tuple(v.shape)}")
    B, Sq, H, hd = q.shape
    Skv, KV = k.shape[1], k.shape[2]
    if k.shape[0] != B or k.shape[3] != hd or KV == 0 or H % KV:
        raise ValueError(f"flash_attention: q {tuple(q.shape)} and k "
                         f"{tuple(k.shape)} do not fit (GQA needs H % KV == 0)")
    if Sq > Skv and (causal or window):
        raise ValueError(f"flash_attention: Sq ({Sq}) > Skv ({Skv}) with a causal "
                         "mask or a window leaves query rows without any key")
    if window < 0:
        raise ValueError("flash_attention: window must be >= 0")
    grad = torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                        or v.requires_grad)
    if not q.is_cuda:
        if not (q.device == k.device == v.device):
            raise ValueError("flash_attention: q, k, v on different devices")
        if grad:
            return FlashAttention.apply(q, k, v, causal, window, softcap)
        return mha_reference(q, k, v, causal=causal, window=window,
                             softcap=softcap)
    dev = q.get_device()
    if not (k.is_cuda and v.is_cuda and k.get_device() == dev == v.get_device()):
        raise ValueError("flash_attention: q, k, v on different devices")
    code = _build.DTYPE_CODES.get(q.dtype)
    if code is None or not (q.dtype == k.dtype == v.dtype):
        raise TypeError(f"flash_attention: unsupported dtypes {q.dtype}, "
                        f"{k.dtype}, {v.dtype}")
    if hd not in HEAD_DIMS:
        raise ValueError(f"flash_attention: head_dim {hd} is not compiled in "
                         f"(have {HEAD_DIMS})")
    for name, t in (("q", q), ("k", k), ("v", v)):
        _check_layout(name, t)
    if grad:
        return FlashAttention.apply(q, k, v, causal, window, softcap)
    return launch_forward(q, k, v, causal, window, softcap, with_lse=False)[0]


def launch_forward(q, k, v, causal, window, softcap, *, with_lse: bool):
    """Launch the forward kernel on checked CUDA tensors: (o, lse or None)."""
    global launches
    B, Sq, H, hd = q.shape
    o = torch.empty((B, Sq, H, hd), dtype=q.dtype, device=q.device)
    lse = (torch.empty((B, H, Sq), dtype=torch.float32, device=q.device)
           if with_lse else None)
    if o.numel() == 0:
        return o, lse
    if _fwd is None:
        _bind()
    code = _build.DTYPE_CODES[q.dtype]
    kind = _variant.get((code, hd)) or variant(q.dtype, hd)
    dev = q.get_device()
    err = _fwd(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
               lse.data_ptr() if with_lse else None,
               B, Sq, k.shape[1], H, k.shape[2], hd,
               *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
               *o.stride()[:3],
               int(bool(causal)), int(window), float(softcap), code, dev,
               _stream(dev))
    if err:
        _build.check(err, "flash_attention")
    launches += 1
    launches_by_variant[kind] += 1
    return o, lse


def _bwd_scratch(kind: str, q: torch.Tensor):
    """The backward's float32 scratch for q (B, Sq, H, hd): (delta, dq_acc).  The
    wgmma kernel takes D and lse * log2(e), each (B, H, Sq padded to BWD_SQ_PAD), and
    (but at head_dim 256, whose dq pass writes dq itself) a dq accumulator of as many
    floats as (B, H, padded Sq, hd), in the kernel's own block layout (its prep kernel
    writes them); the others take D as (B, H, Sq) and no accumulator."""
    B, Sq, H, hd = q.shape
    if kind != "sm90_wgmma":
        return torch.empty((B, H, Sq), dtype=torch.float32, device=q.device), None
    sq_pad = -(-Sq // BWD_SQ_PAD) * BWD_SQ_PAD
    delta = torch.empty((2, B, H, sq_pad), dtype=torch.float32, device=q.device)
    if hd == BWD_DQ_PASS_HEAD_DIM:
        return delta, None
    return delta, torch.empty((B, H, sq_pad, hd), dtype=torch.float32, device=q.device)


def launch_backward(q, k, v, o, lse, do, causal, window, softcap):
    """Launch the backward kernels on CUDA tensors: (dq, dk, dv).  q, k, v and o
    as the forward took and gave them, lse its (B, H, Sq) float32 output."""
    global bwd_launches
    B, Sq, H, _ = q.shape
    if o.shape != q.shape or do.shape != q.shape or o.dtype != q.dtype:
        raise ValueError(f"flash_attention backward: o {tuple(o.shape)} {o.dtype} or "
                         f"do {tuple(do.shape)} does not match q {tuple(q.shape)} {q.dtype}")
    if (lse.dtype != torch.float32 or tuple(lse.shape) != (B, H, Sq)
            or not lse.is_contiguous()):
        raise ValueError(f"flash_attention backward: lse must be a contiguous float32 "
                         f"({B}, {H}, {Sq}), got {lse.dtype} {tuple(lse.shape)}")
    dev = q.get_device()
    if not all(t.is_cuda and t.get_device() == dev for t in (k, v, o, lse, do)):
        raise ValueError("flash_attention backward: tensors on different devices")
    _check_layout("o", o)
    if do.dtype != q.dtype or not _layout_ok(do):
        do = do.to(q.dtype).contiguous()
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    if q.numel() == 0 or k.numel() == 0:
        return dq, dk.zero_(), dv.zero_()
    if _fwd is None:
        _bind()
    kind = bwd_variant(q.dtype, q.shape[3])
    delta, dq_acc = _bwd_scratch(kind, q)
    call = _build.FlashBwdCall(
        q=q.data_ptr(), k=k.data_ptr(), v=v.data_ptr(), o=o.data_ptr(),
        dout=do.data_ptr(), lse=lse.data_ptr(), delta=delta.data_ptr(),
        dq_acc=dq_acc.data_ptr() if dq_acc is not None else None, dq=dq.data_ptr(), dk=dk.data_ptr(), dv=dv.data_ptr(), stream=_stream(dev),
        B=q.shape[0], Sq=q.shape[1], Skv=k.shape[1], H=q.shape[2], KV=k.shape[2],
        hd=q.shape[3], causal=int(bool(causal)), window=int(window),
        softcap=float(softcap), dtype=_build.DTYPE_CODES[q.dtype], device=dev)
    for name, t in zip(_build.FLASH_BWD_TENSORS, (q, k, v, o, do, dq, dk, dv)):
        setattr(call, f"{name}_sb", t.stride(0))
        setattr(call, f"{name}_ss", t.stride(1))
        setattr(call, f"{name}_sh", t.stride(2))
    err = _build.load().repro_flash_attention_bwd(ctypes.addressof(call))
    if err:
        _build.check(err, "flash_attention backward")
    bwd_launches += 1
    bwd_launches_by_variant[kind] += 1
    return dq, dk, dv


class FlashAttention(torch.autograd.Function):
    """Attention with its gradient: the counterpart of the reference's
    ``_flash_diff`` / ``_flash_vjp_fwd`` / ``_flash_vjp_bwd``.  Saves q, k, v, the
    output and its per-row lse; the backward recomputes the probabilities from
    them (kernels on the card, ``ref`` on the CPU)."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, softcap):
        if q.is_cuda:
            o, lse = launch_forward(q, k, v, causal, window, softcap, with_lse=True)
        else:
            o = mha_reference(q, k, v, causal=causal, window=window, softcap=softcap)
            lse = flash_attention_lse_reference(q, k, causal=causal, window=window,
                                                softcap=softcap)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.mask = (causal, window, softcap)
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        causal, window, softcap = ctx.mask
        if q.is_cuda:
            dq, dk, dv = launch_backward(q, k, v, o, lse, do, causal, window, softcap)
        else:
            dq, dk, dv = flash_attention_bwd_reference(
                q, k, v, o, lse, do, causal=causal, window=window, softcap=softcap)
        return dq, dk, dv, None, None, None
