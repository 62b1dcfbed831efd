"""Plain PyTorch versions of the two kernels (the unfused forms).

They materialize the full Sq x Skv score matrix and every intermediate; they
are what the kernels are held against, and what a CPU tensor gets.
"""

from __future__ import annotations

import math

import torch


def mha_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  causal: bool = True, window: int = 0,
                  softcap: float = 0.0) -> torch.Tensor:
    """q: (B, Sq, H, hd); k, v: (B, Skv, KV, hd), H % KV == 0 (GQA).

    Returns (B, Sq, H, hd).  Scores in fp32, softcap before the mask, queries
    offset by ``Skv - Sq``, mask fill -1e30.
    """
    B, Sq, H, hd = q.shape
    Skv, KV = k.shape[1], k.shape[2]
    G = H // KV
    qg = q.reshape(B, Sq, KV, G, hd)
    s = torch.einsum("bqhgk,bshk->bhgqs", qg, k).float()
    s = s / math.sqrt(hd)
    if softcap:
        s = torch.tanh(s / softcap) * softcap
    qpos = torch.arange(Sq, device=q.device)[:, None] + (Skv - Sq)
    kpos = torch.arange(Skv, device=q.device)[None, :]
    mask = torch.ones(Sq, Skv, dtype=torch.bool, device=q.device)
    if causal:
        mask &= qpos >= kpos
    if window:
        mask &= qpos - kpos < window
    s = torch.where(mask, s, torch.full((), -1e30, dtype=s.dtype,
                                        device=s.device))
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bhgqs,bshk->bqhgk", p.to(v.dtype), v)
    return o.reshape(B, Sq, H, hd)


def rmsnorm_reference(x: torch.Tensor, w: torch.Tensor,
                      eps: float = 1e-6) -> torch.Tensor:
    xf = x.float()
    var = xf.square().mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * w.float()).to(x.dtype)
