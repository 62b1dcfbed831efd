"""Fused attention forward: wrapper around ``csrc/flash_attention.cu``.

A CUDA tensor launches a kernel or raises; a CPU tensor takes the plain
version.  Forward only: the backward kernel comes with the training path.

Which kernel a CUDA call launches is the library's own rule (``variant``):
16-bit inputs at head_dim 64 and 128 take the TMA + wgmma kernel, the other
16-bit head_dims the mma.sync kernel, float32 the scalar kernel.  A variant
that cannot run (a tensor map that cannot be encoded, a refused launch) raises;
no other variant stands in for it.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import mha_reference

HEAD_DIMS = (16, 32, 64, 128, 256)
VARIANTS = ("scalar", "mma_sync", "sm90_wgmma")   # the C interface's codes 0, 1, 2

#: kernel launches made by :func:`flash_attention` in this process, in all and
#: by the kernel that ran
launches = 0
launches_by_variant = dict.fromkeys(VARIANTS, 0)

_fwd = None        # the library's repro_flash_attention_fwd, bound at first use
_stream = None     # device index -> raw handle of its current stream
_variant: dict[tuple[int, int], str] = {}   # (dtype code, hd) -> variant


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


def _check_layout(name: str, t: torch.Tensor) -> None:
    if t.stride(-1) != 1:
        raise ValueError(f"flash_attention: {name}'s head_dim stride must be 1")
    if t.element_size() == 2 and (
            t.data_ptr() % 16 or any(s % 8 for s in t.stride()[:-1])):
        raise ValueError(f"flash_attention: {name}'s rows must start on "
                         "16-byte boundaries")


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0,
                    softcap: float = 0.0) -> torch.Tensor:
    """q: (B, Sq, H, hd); k, v: (B, Skv, KV, hd).  Returns (B, Sq, H, hd).

    Queries are aligned to the end of the keys (query i sits at position
    ``i + Skv - Sq``).  ``Sq <= Skv`` is required on either device: with more
    queries than keys the first rows would see no key at all.
    """
    global launches
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError(f"flash_attention: bad shapes q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}, v {tuple(v.shape)}")
    B, Sq, H, hd = q.shape
    Skv, KV = k.shape[1], k.shape[2]
    if k.shape[0] != B or k.shape[3] != hd or KV == 0 or H % KV:
        raise ValueError(f"flash_attention: q {tuple(q.shape)} and k "
                         f"{tuple(k.shape)} do not fit (GQA needs H % KV == 0)")
    if Sq > Skv:
        raise ValueError(f"flash_attention: Sq ({Sq}) > Skv ({Skv}) leaves "
                         "query rows without any key")
    if window < 0:
        raise ValueError("flash_attention: window must be >= 0")
    if not q.is_cuda:
        if not (q.device == k.device == v.device):
            raise ValueError("flash_attention: q, k, v on different devices")
        return mha_reference(q, k, v, causal=causal, window=window,
                             softcap=softcap)
    dev = q.get_device()
    if not (k.is_cuda and v.is_cuda and k.get_device() == dev == v.get_device()):
        raise ValueError("flash_attention: q, k, v on different devices")
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        raise RuntimeError("flash_attention: the kernel is forward-only; "
                           "call it under torch.no_grad()")
    code = _build.DTYPE_CODES.get(q.dtype)
    if code is None or not (q.dtype == k.dtype == v.dtype):
        raise TypeError(f"flash_attention: unsupported dtypes {q.dtype}, "
                        f"{k.dtype}, {v.dtype}")
    if hd not in HEAD_DIMS:
        raise ValueError(f"flash_attention: head_dim {hd} is not compiled in "
                         f"(have {HEAD_DIMS})")
    for name, t in (("q", q), ("k", k), ("v", v)):
        _check_layout(name, t)
    o = torch.empty((B, Sq, H, hd), dtype=q.dtype, device=q.device)
    if o.numel() == 0:
        return o
    if _fwd is None:
        _bind()
    kind = _variant.get((code, hd)) or variant(q.dtype, hd)
    err = _fwd(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
               B, Sq, Skv, H, KV, hd,
               *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
               *o.stride()[:3],
               int(bool(causal)), int(window), float(softcap), code, dev,
               _stream(dev))
    if err:
        _build.check(err, "flash_attention")
    launches += 1
    launches_by_variant[kind] += 1
    return o
