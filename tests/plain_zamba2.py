"""A plain float32 Zamba2 (arXiv:2411.15242, as Zyphra/Zamba2-7B-Instruct publishes it),
for tests: its loss and, through autograd, its gradients.  TF32 off; it imports
nothing of the port, the JAX package or the benchmark.

``sizes`` is a dict: ``d`` (hidden), ``layers``, ``hybrid`` (the hybrid layer ids),
``blocks`` (shared blocks), ``heads``, ``kv_heads``, ``head_dim``, ``ffn``,
``adapter``, ``expand``, ``ssm_head_dim``, ``state``, ``groups``, ``conv``, ``eps``
and ``theta``.  Parameters are named as the port names its own (``blocks.i.mamba.*``,
``blocks.i.use.*`` at a hybrid layer, ``mem.b.attn.*`` / ``mem.b.ffn.*``,
``embed.tok``, ``final_norm``).

Every layer is ``x + mamba(norm(x + t))``; ``t`` is zero but at a hybrid layer,
where it is a shared block's output (blocks taken in turn by use) through the use's
linear: on concat(x, e0), RMSNorm, attention with rope over the whole head, causal,
scale (head_dim / 2) ** -0.5, into d; RMSNorm; GeGLU with exact GELU and the use's
adapter on the gate and up products.  Mamba2: z, x, B, C (groups), dt; a causal
depthwise convolution with bias over x, B and C, SiLU; dt = softplus(dt + dt_bias);
the SSD's quadratic form y = (L o C B^T)(dt x) + D x, L[t, s] = exp(sum_{s<r<=t} A
dt_r), A = -exp(A_log), head h reading group h // (heads / groups); the gated
RMSNorm norm(y * silu(z)) over each group's slice; the out projection.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F


def rms_norm(x, w, eps):
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) * w


def ssd(x, dt, A, Bm, Cm, D, rows=128):
    """x (B,S,nh,P), dt (B,S,nh), A (nh,), Bm and Cm (B,S,G,N), D (nh,): the
    quadratic form, per group, in blocks of ``rows`` query rows."""
    Bsz, S, nh, P = x.shape
    G = Bm.shape[2]
    per = nh // G
    cs = torch.cumsum((A * dt).double(), dim=1)                # (B,S,nh)
    out = torch.empty_like(x)
    for g in range(G):
        h = slice(g * per, (g + 1) * per)
        u = dt[:, :, h, None] * x[:, :, h]
        for lo in range(0, S, rows):
            hi = min(lo + rows, S)
            rel = (cs[:, :hi, h] - cs[:, lo:lo + 1, h]).float()
            t = torch.arange(lo, hi)[:, None]
            s = torch.arange(hi)[None, :]
            seen = (s <= t)[None, :, :, None]
            diff = rel[:, lo:hi, None, :] - rel[:, None, :, :]     # (B,R,hi,per)
            L = torch.where(seen, torch.exp(torch.where(seen, diff, 0.0)), 0.0)
            cb = Cm[:, lo:hi, g] @ Bm[:, :hi, g].transpose(1, 2)  # (B,R,hi)
            out[:, lo:hi, h] = torch.einsum("btsh,bshp->bthp", L * cb[..., None], u[:, :hi])
    return out + D[:, None] * x


def mamba(P, p, z_, x, t):
    d, eps = z_["d"], z_["eps"]
    e = z_["expand"] * d
    G, N, Pd = z_["groups"], z_["state"], z_["ssm_head_dim"]
    nh = e // Pd
    Bsz, S, _ = x.shape
    h = rms_norm(x if t is None else x + t, P[p + "ln"], eps)
    z = h @ P[p + "w_z"]
    xbc = torch.cat([h @ P[p + "w_x"], h @ P[p + "w_B"], h @ P[p + "w_C"]], dim=-1)
    W = P[p + "conv_w"].shape[0]
    xbc = F.conv1d(xbc.transpose(1, 2), P[p + "conv_w"].t()[:, None, :], P[p + "conv_b"],
                   padding=W - 1, groups=xbc.shape[-1])[..., :S].transpose(1, 2)
    xs, Bm, Cm = F.silu(xbc).split([e, G * N, G * N], dim=-1)
    dt = F.softplus(h @ P[p + "w_dt"] + P[p + "dt_bias"])
    y = ssd(xs.reshape(Bsz, S, nh, Pd), dt, -torch.exp(P[p + "A_log"]),
            Bm.reshape(Bsz, S, G, N), Cm.reshape(Bsz, S, G, N), P[p + "D"])
    y = (y.reshape(Bsz, S, e) * F.silu(z)).reshape(Bsz, S, G, e // G)
    y = (y * torch.rsqrt(y.square().mean(-1, keepdim=True) + eps)).reshape(Bsz, S, e)
    return x + (y * P[p + "gn"]) @ P[p + "w_out"]


def rope(x, theta):
    """Half-split rotary embedding over the whole head; x (B,S,H,hd)."""
    S, hd = x.shape[1], x.shape[-1]
    half = hd // 2
    freqs = torch.exp(-torch.arange(half, dtype=torch.float64) * (math.log(theta) / half))
    ang = torch.arange(S, dtype=torch.float64)[:, None] * freqs
    cos, sin = torch.cos(ang).float()[:, None], torch.sin(ang).float()[:, None]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def shared_block(P, b, u, z_, x, e0):
    d, eps, H, KV, hd = z_["d"], z_["eps"], z_["heads"], z_["kv_heads"], z_["head_dim"]
    Bsz, S, _ = x.shape
    h = rms_norm(torch.cat([x, e0], dim=-1), P[b + "attn.ln"], eps)
    q = rope((h @ P[b + "attn.wq"].reshape(2 * d, H * hd)).reshape(Bsz, S, H, hd), z_["theta"])
    k = rope((h @ P[b + "attn.wk"].reshape(2 * d, KV * hd)).reshape(Bsz, S, KV, hd),
             z_["theta"])
    v = (h @ P[b + "attn.wv"].reshape(2 * d, KV * hd)).reshape(Bsz, S, KV, hd)
    k = k.repeat_interleave(H // KV, dim=2)
    v = v.repeat_interleave(H // KV, dim=2)
    s = torch.einsum("bqhk,bshk->bhqs", q, k) * (hd / 2) ** -0.5
    s = s.masked_fill(~torch.ones(S, S, dtype=torch.bool).tril(), float("-inf"))
    o = torch.einsum("bhqs,bshk->bqhk", torch.softmax(s, -1), v).reshape(Bsz, S, H * hd)
    h = rms_norm(o @ P[b + "attn.wo"].reshape(H * hd, d), P[b + "ffn.ln"], eps)
    lo = h @ P[u + "a_in"]
    gate = h @ P[b + "ffn.w_gate"] + lo @ P[u + "a_gate"]
    up = h @ P[b + "ffn.w_up"] + lo @ P[u + "a_up"]
    return ((F.gelu(gate) * up) @ P[b + "ffn.w_down"]) @ P[u + "linear"]


def loss(P: dict, z_: dict, tokens: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean next-token cross-entropy of the model with the tied head."""
    saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        x = P["embed.tok"][tokens.long()]
        e0, use = x, 0
        for i in range(z_["layers"]):
            t = None
            if i in z_["hybrid"]:
                t = shared_block(P, f"mem.{use % z_['blocks']}.", f"blocks.{i}.use.", z_, x, e0)
                use += 1
            x = mamba(P, f"blocks.{i}.mamba.", z_, x, t)
        logits = rms_norm(x, P["final_norm"], z_["eps"]) @ P["embed.tok"].t()
        return F.cross_entropy(logits.reshape(-1, logits.shape[-1]), labels.reshape(-1).long())
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved
