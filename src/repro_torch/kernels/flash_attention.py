"""Fused attention forward: wrapper around ``csrc/flash_attention.cu``.

A CUDA tensor launches the kernel or raises; a CPU tensor takes the plain
version.  Forward only: the backward kernel comes with the training path.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import mha_reference

HEAD_DIMS = (16, 32, 64, 128, 256)

#: kernel launches made by :func:`flash_attention` in this process
launches = 0


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
    if not (q.device == k.device == v.device):
        raise ValueError("flash_attention: q, k, v on different devices")
    if not q.is_cuda:
        return mha_reference(q, k, v, causal=causal, window=window,
                             softcap=softcap)
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        raise RuntimeError("flash_attention: the kernel is forward-only; "
                           "call it under torch.no_grad()")
    if q.dtype not in _build.DTYPE_CODES or not (q.dtype == k.dtype == v.dtype):
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
    lib = _build.load()
    with _build.on_device(q.device):
        code = lib.repro_flash_attention_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            B, Sq, Skv, H, KV, hd,
            *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
            *o.stride()[:3],
            int(bool(causal)), int(window), float(softcap),
            _build.DTYPE_CODES[q.dtype], torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(code, "flash_attention")
    launches += 1
    return o
