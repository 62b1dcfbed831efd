"""Plain PyTorch versions of the kernels (the unfused forms): the two forwards,
the attention forward's per-row log-sum-exp, and the two backwards.

They materialize the full Sq x Skv score matrix and every intermediate; they
are what the kernels are held against, and what a CPU tensor gets.
"""

from __future__ import annotations

import math

import torch


def _masked_scores(q: torch.Tensor, k: torch.Tensor, causal: bool, window: int,
                   softcap: float, scale: float | None = None):
    """Scaled (and capped) fp32 scores (B, KV, G, Sq, Skv), their visibility mask
    (Sq, Skv), and tanh of the capped scores (None without softcap).  The scale is
    1/sqrt(hd) unless ``scale`` is given."""
    B, Sq, H, hd = q.shape
    Skv, KV = k.shape[1], k.shape[2]
    qg = q.reshape(B, Sq, KV, H // KV, hd)
    s = torch.einsum("bqhgk,bshk->bhgqs", qg, k).float()
    s = s / math.sqrt(hd) if scale is None else s * scale
    th = None
    if softcap:
        th = torch.tanh(s / softcap)
        s = th * softcap
    qpos = torch.arange(Sq, device=q.device)[:, None] + (Skv - Sq)
    kpos = torch.arange(Skv, device=q.device)[None, :]
    mask = torch.ones(Sq, Skv, dtype=torch.bool, device=q.device)
    if causal:
        mask &= qpos >= kpos
    if window:
        mask &= qpos - kpos < window
    return s, mask, th


def mha_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  causal: bool = True, window: int = 0,
                  softcap: float = 0.0, scale: float | None = None) -> torch.Tensor:
    """q: (B, Sq, H, hd); k, v: (B, Skv, KV, hd), H % KV == 0 (GQA).

    Returns (B, Sq, H, hd).  Scores in fp32 at ``scale`` (1/sqrt(hd) by default),
    softcap before the mask, queries offset by ``Skv - Sq``, mask fill -1e30.
    """
    B, Sq, H, hd = q.shape
    s, mask, _ = _masked_scores(q, k, causal, window, softcap, scale)
    s = torch.where(mask, s, torch.full((), -1e30, dtype=s.dtype,
                                        device=s.device))
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bhgqs,bshk->bqhgk", p.to(v.dtype), v)
    return o.reshape(B, Sq, H, hd)


def flash_attention_lse_reference(q: torch.Tensor, k: torch.Tensor, *,
                                  causal: bool = True, window: int = 0,
                                  softcap: float = 0.0,
                                  scale: float | None = None) -> torch.Tensor:
    """Per query row, the log-sum-exp (natural log) of the masked, scaled (and
    capped) scores: (B, H, Sq) fp32, head ``h`` reading KV head ``h // G``."""
    B, Sq, H, _ = q.shape
    s, mask, _ = _masked_scores(q, k, causal, window, softcap, scale)
    s = torch.where(mask, s, torch.full((), -1e30, dtype=s.dtype,
                                        device=s.device))
    return torch.logsumexp(s, dim=-1).reshape(B, H, Sq)


def flash_attention_bwd_reference(q, k, v, o, lse, do, *, causal: bool = True,
                                  window: int = 0, softcap: float = 0.0,
                                  scale: float | None = None):
    """Gradients (dq, dk, dv) of attention from its inputs, output ``o``, per-row
    ``lse`` (B, H, Sq) and output gradient ``do``, in fp32, each returned in its
    input's dtype.  ``D = rowsum(do * o)``, ``p = exp(s - lse)`` where visible,
    ``ds = p * (dp - D)`` times ``1 - tanh^2`` when capped; dk and dv are summed
    over the G query heads of each KV head."""
    B, Sq, H, hd = q.shape
    Skv, KV = k.shape[1], k.shape[2]
    G = H // KV
    qf, kf, vf = q.float(), k.float(), v.float()
    qg = qf.reshape(B, Sq, KV, G, hd)
    dog = do.float().reshape(B, Sq, KV, G, hd)
    s, mask, th = _masked_scores(qf, kf, causal, window, softcap, scale)
    scale = 1.0 / math.sqrt(hd) if scale is None else scale
    p = torch.where(mask, torch.exp(s - lse.float().reshape(B, KV, G, Sq, 1)),
                    torch.zeros((), device=q.device))
    delta = (dog * o.float().reshape(B, Sq, KV, G, hd)).sum(-1)   # (B, Sq, KV, G)
    dv = torch.einsum("bhgqs,bqhgk->bshk", p, dog)
    dp = torch.einsum("bqhgk,bshk->bhgqs", dog, vf)
    ds = p * (dp - delta.permute(0, 2, 3, 1)[..., None])
    if th is not None:
        ds = ds * (1.0 - th * th)
    dq = torch.einsum("bhgqs,bshk->bqhgk", ds, kf).reshape(B, Sq, H, hd) * scale
    dk = torch.einsum("bhgqs,bqhgk->bshk", ds, qg) * scale
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def rmsnorm_reference(x: torch.Tensor, w: torch.Tensor,
                      eps: float = 1e-6) -> torch.Tensor:
    xf = x.float()
    var = xf.square().mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * w.float()).to(x.dtype)


def rmsnorm_bwd_reference(x: torch.Tensor, w: torch.Tensor, dy: torch.Tensor,
                          eps: float = 1e-6):
    """Gradients (dx, dw) of :func:`rmsnorm_reference`, fp32 arithmetic:
    ``r = rsqrt(mean(x^2) + eps)``, ``dx = r (w dy) - x r^3 mean(x w dy)``,
    ``dw = sum over rows of x r dy``; dx in x's dtype, dw in w's."""
    xf, wf, gf = x.float(), w.float(), dy.float()
    r = torch.rsqrt(xf.square().mean(dim=-1, keepdim=True) + eps)
    dx = r * (wf * gf) - xf * r.pow(3) * (xf * wf * gf).mean(dim=-1, keepdim=True)
    dw = (xf * r * gf).reshape(-1, x.shape[-1]).sum(dim=0)
    return dx.to(x.dtype), dw.to(w.dtype)
