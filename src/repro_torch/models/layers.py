"""Layer primitives of the dense decoder LM (plain functions on tensors).

Counterpart of ``repro.models.layers`` for the block kind ``"attn"`` with a
dense FFN.  Parameters are declared as :class:`ParamDef` trees with the
reference's names, shapes and init rule; :func:`materialize` turns a def-tree
into ``nn.Parameter``s on an explicit device.  The reference's ``shard(...)``
annotations have no counterpart on one card and are dropped until the parallel
layer is ported.

Where the kernels sit: on a CUDA tensor :func:`rms_norm` (``gemma_style=False``)
goes through ``kernels.ops.rmsnorm``, and :func:`mha` called WITHOUT explicit
positions goes through ``kernels.ops.flash_attention``; both launch the
hand-written kernel or raise.  :func:`mha` WITH explicit positions (the decode
path, whose mask differs per batch row) is plain tensor code on either device:
that is a routing decision, not a fallback.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Mapping

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.kernels import ops

NEG_INF = -1e30


# ---------------------------------------------------------------------------
# Parameter definitions
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class ParamDef:
    shape: tuple[int, ...]
    scale: float | None = None       # None => 1/sqrt(fan_in) (first dim)
    init: str = "normal"             # normal | zeros | ones


def _map_defs(fn, defs):
    if isinstance(defs, ParamDef):
        return fn(defs)
    return {k: _map_defs(fn, v) for k, v in defs.items()}


def flatten_defs(defs, prefix: str = "") -> list[tuple[str, ParamDef]]:
    """``(dotted path, def)`` pairs in insertion order."""
    if isinstance(defs, ParamDef):
        return [(prefix, defs)]
    out = []
    for k, v in defs.items():
        out += flatten_defs(v, f"{prefix}.{k}" if prefix else k)
    return out


def stack_defs(defs, n: int) -> Any:
    """Prefix every def with a stacked layer dim (the reference's layout of
    ``pos{p}``; used by ``convert`` and ``n_params``)."""
    return _map_defs(lambda d: ParamDef((n, *d.shape), d.scale, d.init), defs)


def materialize(defs, dtype: torch.dtype, device) -> Any:
    """Allocate a def-tree as ``nn.ParameterDict``s of uninitialized
    parameters; :func:`init_params` fills them."""
    if isinstance(defs, ParamDef):
        return nn.Parameter(torch.empty(defs.shape, dtype=dtype,
                                        device=device))
    return nn.ParameterDict({k: materialize(v, dtype, device)
                             for k, v in defs.items()})


@torch.no_grad()
def init_params(params, defs, generator: torch.Generator) -> None:
    """Fill parameters in place: normal * scale (drawn in fp32 on the
    generator's device, one parameter at a time), zeros or ones."""
    for path, d in flatten_defs(defs):
        p = params
        for k in path.split(".") if path else ():
            p = p[k]
        if d.init == "zeros":
            p.zero_()
        elif d.init == "ones":
            p.fill_(1.0)
        else:
            scale = d.scale if d.scale is not None else \
                1.0 / math.sqrt(max(d.shape[0], 1))
            noise = torch.randn(d.shape, generator=generator,
                                device=generator.device, dtype=torch.float32)
            p.copy_(noise.mul_(scale))


# ---------------------------------------------------------------------------
# Norms / rotary / activations
# ---------------------------------------------------------------------------


def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-6,
             *, gemma_style: bool = False) -> torch.Tensor:
    if not gemma_style:
        # CUDA: the hand-written kernel (or an error); CPU: its plain version
        return ops.rmsnorm(x.contiguous(), w, eps=eps)
    # y * (1 + w): no config passes this today, so it stays plain tensor code
    # on either device until a config turns it on and the kernel grows it.
    xf = x.float()
    var = xf.square().mean(dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps) * (1.0 + w.float())
    return y.to(x.dtype)


def rope_tables(positions: torch.Tensor, hd: int, theta: float):
    """cos and sin of the rotary angles, (..., S, 1, hd/2) in fp32 (at theta
    1e6 a 16-bit angle would be wrong by whole radians)."""
    half = hd // 2
    freqs = torch.exp(-torch.arange(0, half, dtype=torch.float32,
                                    device=positions.device)
                      * (math.log(theta) / half))
    ang = positions[..., :, None].float() * freqs       # (..., S, half)
    return torch.cos(ang)[..., :, None, :], torch.sin(ang)[..., :, None, :]


def _rotate(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor
            ) -> torch.Tensor:
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float
         ) -> torch.Tensor:
    """Rotary embedding, half-split.  x: (..., S, H, hd); positions: (..., S).
    Angles in fp32, result cast back to x's dtype."""
    return _rotate(x, *rope_tables(positions, x.shape[-1], theta))


def _act(kind: str, x: torch.Tensor) -> torch.Tensor:
    if kind == "swiglu":
        return F.silu(x)
    return F.gelu(x, approximate="tanh")     # geglu and gelu


# ---------------------------------------------------------------------------
# Attention (GQA, rope, qk-norm, optional window)
# ---------------------------------------------------------------------------


def attn_defs(cfg) -> dict:
    H, KV, hd, d = cfg.n_heads, cfg.n_kv_heads, cfg.hd, cfg.d_model
    defs = {
        "ln": ParamDef((d,), init="ones"),
        "wq": ParamDef((d, H, hd)),
        "wk": ParamDef((d, KV, hd)),
        "wv": ParamDef((d, KV, hd)),
        "wo": ParamDef((H, hd, d)),
    }
    if cfg.qkv_bias:
        defs["bq"] = ParamDef((H, hd), init="zeros")
        defs["bk"] = ParamDef((KV, hd), init="zeros")
        defs["bv"] = ParamDef((KV, hd), init="zeros")
    if cfg.qk_norm:
        defs["q_norm"] = ParamDef((hd,), init="ones")
        defs["k_norm"] = ParamDef((hd,), init="ones")
    return defs


def _proj_in(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """(B,S,d) x (d,N,hd) -> (B,S,N,hd) as one matrix product."""
    d, N, hd = w.shape
    return (x @ w.reshape(d, N * hd)).reshape(*x.shape[:-1], N, hd)


def _proj_out(o: torch.Tensor, wo: torch.Tensor) -> torch.Tensor:
    """(B,S,H,hd) x (H,hd,d) -> (B,S,d)."""
    H, hd, d = wo.shape
    return o.reshape(*o.shape[:-2], H * hd) @ wo.reshape(H * hd, d)


def _qkv(p: Mapping[str, torch.Tensor], cfg, x: torch.Tensor,
         positions: torch.Tensor):
    """Project + rope.  Returns q:(B,S,KV,G,hd) grouped, k,v:(B,S,KV,hd).

    q's heads are flattened KV-major, so head ``h`` reads KV head ``h // G``.
    """
    H, KV, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    q = _proj_in(x, p["wq"])
    k = _proj_in(x, p["wk"])
    v = _proj_in(x, p["wv"])
    if cfg.qkv_bias:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    if cfg.qk_norm:
        q = rms_norm(q, p["q_norm"], cfg.norm_eps)
        k = rms_norm(k, p["k_norm"], cfg.norm_eps)
    cos, sin = rope_tables(positions, hd, cfg.rope_theta)  # one table for q, k
    q, k = _rotate(q, cos, sin), _rotate(k, cos, sin)
    G = H // KV
    q = q.reshape(*q.shape[:2], KV, G, hd)
    return q, k, v


def _mha_plain(q, k, v, *, causal, q_positions, kv_positions, window,
               q_chunk, softcap):
    """Grouped-query attention in plain tensor code, chunked over queries:
    fp32 scores, -1e30 fill, softmax, probabilities cast to q's dtype."""
    B, Sq, KV, G, hd = q.shape
    scale = 1.0 / math.sqrt(hd)
    fill = torch.full((), NEG_INF, dtype=torch.float32, device=q.device)
    outs = []
    for lo in range(0, Sq, q_chunk):
        qs = q[:, lo:lo + q_chunk]
        qp = q_positions[:, lo:lo + q_chunk]
        s = torch.einsum("bqhgk,bshk->bhgqs", qs, k).float() * scale
        if softcap:
            s = torch.tanh(s / softcap) * softcap
        if causal:
            mask = qp[:, :, None] >= kv_positions[:, None, :]
        else:
            mask = torch.ones((B, qs.shape[1], k.shape[1]), dtype=torch.bool,
                              device=q.device)
        if window:
            mask = mask & (qp[:, :, None] - kv_positions[:, None, :] < window)
        s = torch.where(mask[:, None, None], s, fill)
        o = torch.einsum("bhgqs,bshk->bqhgk",
                         torch.softmax(s, dim=-1).to(q.dtype), v)
        outs.append(o.reshape(B, qs.shape[1], KV * G, hd))
    return outs[0] if len(outs) == 1 else torch.cat(outs, dim=1)


def mha(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, causal: bool,
        q_positions: torch.Tensor | None = None,
        kv_positions: torch.Tensor | None = None,
        window: int = 0, q_chunk: int = 1024,
        softcap: float = 0.0) -> torch.Tensor:
    """Grouped-query attention.

    q: (B, Sq, KV, G, hd);  k, v: (B, Skv, KV, hd).  Returns (B, Sq, KV*G, hd).
    Masks: causal by position, optional sliding ``window``.

    Routing: without explicit positions (queries aligned to the end of the
    keys, ``Sq <= Skv``) this is exactly the fused kernel's contract and the
    call goes to ``kernels.ops.flash_attention`` -- on a CUDA tensor the
    hand-written kernel or an error, on a CPU tensor its plain version.  With
    explicit positions the mask may differ per batch row, which the kernel
    cannot express, and the plain chunked form below is used on any device.
    """
    B, Sq, KV, G, hd = q.shape
    Skv = k.shape[1]
    if q_positions is None and kv_positions is None:
        return ops.flash_attention(q.reshape(B, Sq, KV * G, hd), k, v,
                                   causal=causal, window=window,
                                   softcap=softcap)
    dev = q.device
    if q_positions is None:
        q_positions = (torch.arange(Sq, device=dev) + (Skv - Sq)
                       )[None].expand(B, Sq)
    if kv_positions is None:
        kv_positions = torch.arange(Skv, device=dev)[None].expand(B, Skv)
    return _mha_plain(q, k, v, causal=causal, q_positions=q_positions,
                      kv_positions=kv_positions, window=window,
                      q_chunk=max(1, min(q_chunk, Sq)), softcap=softcap)


def attn_block(p, cfg, x: torch.Tensor, positions: torch.Tensor, *,
               window: int = 0, causal: bool | None = None) -> torch.Tensor:
    """Pre-norm self-attention residual block (no FFN)."""
    h = rms_norm(x, p["ln"], cfg.norm_eps)
    q, k, v = _qkv(p, cfg, h, positions)
    o = mha(q, k, v, causal=cfg.causal if causal is None else causal,
            window=window, q_chunk=cfg.attn_q_chunk)
    return x + _proj_out(o, p["wo"])


def attn_decode(p, cfg, x: torch.Tensor, cache_k: torch.Tensor,
                cache_v: torch.Tensor, pos: torch.Tensor, *, window: int = 0):
    """One-token decode: write the cache at ``pos`` IN PLACE, attend to it.

    x: (B, 1, d); cache_k/v: (B, S, KV, hd); pos: (B,) integer, each
    ``pos < S`` unless ``window`` (then the cache is a ring buffer of the last
    S tokens).  An out-of-range ``pos`` is the caller's error: it is not
    clamped as the reference's ``dynamic_update_slice`` would, and not checked
    here (that would cost a device synchronisation per layer).
    Returns (out (B,1,d), cache_k, cache_v) -- the same cache tensors.

    Attention over the cache is the plain form of :func:`mha` with explicit
    positions (see its docstring): row ``b`` masks by its own ``pos[b]``.
    """
    B, S = cache_k.shape[0], cache_k.shape[1]
    h = rms_norm(x, p["ln"], cfg.norm_eps)
    q, k, v = _qkv(p, cfg, h, pos[:, None])
    wpos = pos % S if window else pos   # ring buffer for windowed attention
    rows = torch.arange(B, device=x.device)
    cache_k[rows, wpos] = k[:, 0]
    cache_v[rows, wpos] = v[:, 0]
    kv_pos = torch.arange(S, device=x.device)[None].expand(B, S)
    if window:
        # ring buffer: slot stores token (pos - ((wpos - slot) mod S));
        # never-written slots have kv_pos < 0 -> pushed out of the window.
        kv_pos = pos[:, None] - ((wpos[:, None] - kv_pos) % S)
        kv_pos = torch.where(kv_pos >= 0, kv_pos,
                             torch.full_like(kv_pos, -(1 << 30)))
    # else: slots beyond pos are future/unwritten -> masked by the causal rule
    o = mha(q, cache_k, cache_v, causal=True, q_positions=pos[:, None],
            kv_positions=kv_pos, window=window, q_chunk=1)
    return x + _proj_out(o, p["wo"]), cache_k, cache_v


# ---------------------------------------------------------------------------
# Dense FFN
# ---------------------------------------------------------------------------


def ffn_defs(cfg, d_ff: int | None = None) -> dict:
    d, f = cfg.d_model, d_ff or cfg.d_ff
    defs = {"ln": ParamDef((d,), init="ones"),
            "w_up": ParamDef((d, f)),
            "w_down": ParamDef((f, d))}
    if cfg.ffn_kind in ("swiglu", "geglu"):
        defs["w_gate"] = ParamDef((d, f))
    return defs


def ffn_block(p, cfg, x: torch.Tensor) -> torch.Tensor:
    h = rms_norm(x, p["ln"], cfg.norm_eps)
    up = h @ p["w_up"]
    if "w_gate" in p:
        up = up * _act(cfg.ffn_kind, h @ p["w_gate"])
    else:
        up = _act(cfg.ffn_kind, up)
    return x + up @ p["w_down"]


# ---------------------------------------------------------------------------
# Embedding / unembedding
# ---------------------------------------------------------------------------


def embed_defs(cfg) -> dict:
    return {"tok": ParamDef((cfg.vocab, cfg.d_model), scale=0.02)}


def embed(p, cfg, tokens: torch.Tensor) -> torch.Tensor:
    x = F.embedding(tokens, p["tok"]).to(cfg.torch_dtype)
    if cfg.scale_embed:
        x = x * math.sqrt(cfg.d_model)
    return x


def logits_chunked(x: torch.Tensor, emb: torch.Tensor, cfg,
                   chunk: int = 512) -> torch.Tensor:
    """(B,S,d) @ (V,d)^T with the tied unembedding in x's dtype; full logits,
    so call it on few positions when V is large."""
    logits = x @ emb.to(x.dtype).t()
    if cfg.logit_softcap:
        logits = torch.tanh(logits / cfg.logit_softcap) * cfg.logit_softcap
    return logits
