"""Layer primitives of the LM (plain functions on tensors).

Counterpart of ``repro.models.layers``: self-attention (``"attn"`` blocks, the
encoder, zamba2's shared block), the dense FFN, the mixture-of-experts FFN,
cross-attention to a memory (``"cross_attn"`` blocks) and the recurrent blocks
(Mamba2, mLSTM, sLSTM).  Parameters are
declared as :class:`ParamDef` trees with the reference's names, shapes and init
rule; :func:`materialize` turns a def-tree into ``nn.Parameter``s on an
explicit device.  The reference's ``shard(...)`` annotations sit at the same
sites (``parallel.axes.shard``): no-ops on one device, redistributions of the
DTensor activations when a mesh is active (``use_rules``).

Where the kernels sit: on a CUDA tensor :func:`rms_norm` (``gemma_style=False``)
goes through ``kernels.ops.rmsnorm``, and :func:`mha` called WITHOUT explicit
positions goes through ``kernels.ops.flash_attention``; both launch the
hand-written kernel or raise.  On DTensors (a step on a mesh) both calls go
through ``local_map``: the kernel runs on each rank's shard (RMSNorm with the
normalised dim whole, attention with batch and heads sharded and head_dim
whole), and a CUDA shard reaches the kernel as any CUDA tensor does.
:func:`mha` WITH explicit positions (the decode
path, whose mask differs per batch row) is plain tensor code on either device:
that is a routing decision, not a fallback.  Cross-attention calls :func:`mha`
without positions, so it runs on the kernel at prefill and decode alike.  The
MoE dispatch (routing, sort, capacity, gather, scatter-add) and the expert
products are plain tensor code and cuBLAS, and so are the recurrences (the
chunkwise SSD and mLSTM forms, and the sequential steps as Python loops over
time): none of it is a Pallas kernel in the reference either.
"""

from __future__ import annotations

import contextlib
import functools
import math
from dataclasses import dataclass
from typing import Any, Mapping, NamedTuple

import torch
import torch.nn.functional as F
from torch import nn

from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
from torch.distributed.tensor.experimental import local_map
from torch.utils.checkpoint import checkpoint

from repro_torch.kernels import ops
from repro_torch.obs import NULL_HANDLE
from repro_torch.parallel.axes import AxisRules, active_rules, shard

NEG_INF = -1e30
Axes = tuple[str | None, ...]


# ---------------------------------------------------------------------------
# Parameter definitions
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class ParamDef:
    shape: tuple[int, ...]
    axes: Axes                       # logical axis names (parallel.axes)
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
    return _map_defs(lambda d: ParamDef((n, *d.shape), ("layers", *d.axes),
                                        d.scale, d.init), defs)


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
        if isinstance(x, DTensor):
            return _rmsnorm_local(x, w, eps)
        return ops.rmsnorm(x.contiguous(), w, eps=eps)
    # y * (1 + w): no config passes this today, so it stays plain tensor code
    # on either device until a config turns it on and the kernel grows it.
    xf = x.float()
    var = xf.square().mean(dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps) * (1.0 + w.float())
    return y.to(x.dtype)


def _rmsnorm_local(x: DTensor, w: torch.Tensor, eps: float) -> DTensor:
    """:func:`rms_norm` on each rank's shard of x: rows sharded as x is, the
    normalised last dim whole (a shard of it, or a pending sum, is gathered
    first).  w's gradient is a partial sum over every mesh dim that splits the
    rows."""
    xp = tuple(Replicate() if p.is_partial() or (p.is_shard() and p.dim == x.ndim - 1)
               else p for p in x.placements)
    wp = (Replicate(),) * len(xp)
    wg = tuple(Partial() if p.is_shard() else Replicate() for p in xp)
    fn = local_map(lambda a, b: ops.rmsnorm(a.contiguous(), b, eps=eps),
                   out_placements=list(xp), in_placements=(xp, wp),
                   in_grad_placements=(xp, wg), redistribute_inputs=True)
    return fn(x, w)


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


def _act(kind: str, x: torch.Tensor, approximate: str = "tanh") -> torch.Tensor:
    if kind == "swiglu":
        return F.silu(x)
    return F.gelu(x, approximate=approximate)     # geglu and gelu


# ---------------------------------------------------------------------------
# Attention (GQA, rope, qk-norm, optional window)
# ---------------------------------------------------------------------------


def attn_defs(cfg) -> dict:
    H, KV, hd, d = cfg.n_heads, cfg.n_kv_heads, cfg.hd, cfg.d_model
    defs = {
        "ln": ParamDef((d,), ("embed",), init="ones"),
        "wq": ParamDef((d, H, hd), ("fsdp", "heads", "head_dim")),
        "wk": ParamDef((d, KV, hd), ("fsdp", "kv_heads", "head_dim")),
        "wv": ParamDef((d, KV, hd), ("fsdp", "kv_heads", "head_dim")),
        "wo": ParamDef((H, hd, d), ("heads", "head_dim", "fsdp")),
    }
    if cfg.qkv_bias:
        defs["bq"] = ParamDef((H, hd), ("heads", "head_dim"), init="zeros")
        defs["bk"] = ParamDef((KV, hd), ("kv_heads", "head_dim"), init="zeros")
        defs["bv"] = ParamDef((KV, hd), ("kv_heads", "head_dim"), init="zeros")
    if cfg.qk_norm:
        defs["q_norm"] = ParamDef((hd,), ("head_dim",), init="ones")
        defs["k_norm"] = ParamDef((hd,), ("head_dim",), init="ones")
    return defs


def _unsplit(y: torch.Tensor, dim: int, n: int) -> torch.Tensor:
    """``y`` before its dim ``dim`` is unflattened into ``n`` leading parts: on a
    mesh, the mesh dims that split it into shards that do not divide ``n`` are
    gathered first, since DTensor cannot unflatten such a split.  DTensor makes
    one when a product's weight is replicated on a mesh dim (splitting the
    product's columns there costs nothing), as kv heads are under the
    divisibility fallback.  A split into one part is gathered too (free on the
    mesh dims of one rank, the only ones that divide it): the split would land
    on the trailing part, which a later flatten could not take."""
    if not isinstance(y, DTensor):
        return y
    split = [p.is_shard(dim) for p in y.placements]
    if not any(split) or n > 1 and n % math.prod(
            m for m, s in zip(y.device_mesh.shape, split) if s) == 0:
        return y
    return y.redistribute(y.device_mesh, [Replicate() if p.is_shard(dim) else p
                                          for p in y.placements])


class _UnsplitGrad(torch.autograd.Function):
    """The identity on a tensor just flattened from ``n`` leading parts at dim
    ``dim``, whose gradient goes through :func:`_unsplit` before autograd
    unflattens it back."""

    @staticmethod
    def forward(ctx, y, dim: int, n: int):
        ctx.dim, ctx.n = dim, n
        return y.view_as(y)

    @staticmethod
    def backward(ctx, g):
        return _unsplit(g, ctx.dim, ctx.n), None, None


def _flattened(y: torch.Tensor, dim: int, n: int) -> torch.Tensor:
    """``y``, just flattened at ``dim`` from ``n`` leading parts, made safe to
    differentiate on a mesh (:class:`_UnsplitGrad`)."""
    return _UnsplitGrad.apply(y, dim, n) if isinstance(y, DTensor) else y


def _split_last(t: torch.Tensor, n: int, size: int) -> torch.Tensor:
    """``t``'s last dim unflattened into ``(n, size)``, safe on a mesh."""
    return _unsplit(t, t.ndim - 1, n).reshape(*t.shape[:-1], n, size)


def _merge_last(t: torch.Tensor) -> torch.Tensor:
    """``t``'s last two dims ``(n, size)`` flattened, safe to differentiate on a
    mesh."""
    n, size = t.shape[-2:]
    return _flattened(t.reshape(*t.shape[:-2], n * size), t.ndim - 2, n)


def _proj_in(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """(B,S,d) x (d,N,hd) -> (B,S,N,hd) as one matrix product."""
    d, N, hd = w.shape
    y = _unsplit(x @ _flattened(w.reshape(d, N * hd), 1, N), x.ndim - 1, N)
    return y.reshape(*x.shape[:-1], N, hd)


def _proj_out(o: torch.Tensor, wo: torch.Tensor) -> torch.Tensor:
    """(B,S,H,hd) x (H,hd,d) -> (B,S,d)."""
    H, hd, d = wo.shape
    return _merge_last(o) @ _flattened(wo.reshape(H * hd, d), 0, H)


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
    q = shard(q, "batch", "seq", "heads", "head_dim")
    k = shard(k, "batch", "seq", "kv_heads", "head_dim")
    v = shard(v, "batch", "seq", "kv_heads", "head_dim")
    G = H // KV
    q = _unsplit(q, 2, KV).reshape(*q.shape[:2], KV, G, hd)
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
    keys; ``Sq <= Skv`` when a mask is on, any ``Sq`` without one) this is
    exactly the fused kernel's contract and the call goes to
    ``kernels.ops.flash_attention`` -- on a CUDA tensor the hand-written kernel
    or an error, on a CPU tensor its plain version.  With
    explicit positions the mask may differ per batch row, which the kernel
    cannot express, and the plain chunked form below is used on any device.
    """
    B, Sq, KV, G, hd = q.shape
    Skv = k.shape[1]
    if q_positions is None and kv_positions is None:
        q = _flattened(q.reshape(B, Sq, KV * G, hd), 2, KV)
        if isinstance(q, DTensor):
            return _flash_local(q, k, v, causal=causal, window=window,
                                softcap=softcap)
        return ops.flash_attention(q, k, v, causal=causal, window=window,
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


def _flash_local(q: DTensor, k: DTensor, v: DTensor, **mask) -> DTensor:
    """The attention kernel on each rank's shard: batch and heads sharded as the
    active rules put them (``"batch"``, ``"heads"`` / ``"kv_heads"``), sequence
    and head_dim whole.  Where the rules shard q's heads but not k's (kv heads
    that do not divide the model axis), k and v are first repeated to q's head
    count, as the reference's ``mha`` repeats them before it shards."""
    mesh, rules = active_rules() or (q.device_mesh, AxisRules())
    qp = rules.placements(("batch", None, "heads", None), q.shape, mesh)
    kp = rules.placements(("batch", None, "kv_heads", None), k.shape, mesh)
    if kp != qp:
        B, Skv, KV, hd = k.shape
        G = q.shape[2] // KV
        k, v = (t[:, :, :, None].expand(B, Skv, KV, G, hd).reshape(B, Skv, KV * G, hd)
                for t in (k, v))
        kp = rules.placements(("batch", None, "heads", None), k.shape, mesh)
    fn = local_map(lambda a, b, c: ops.flash_attention(a, b, c, **mask),
                   out_placements=list(qp), in_placements=(qp, kp, kp),
                   in_grad_placements=(qp, kp, kp), redistribute_inputs=True)
    return fn(q, k, v)


def attn_block(p, cfg, x: torch.Tensor, positions: torch.Tensor, *,
               window: int = 0, causal: bool | None = None) -> torch.Tensor:
    """Pre-norm self-attention residual block (no FFN)."""
    h = rms_norm(x, p["ln"], cfg.norm_eps)
    q, k, v = _qkv(p, cfg, h, positions)
    o = mha(q, k, v, causal=cfg.causal if causal is None else causal,
            window=window, q_chunk=cfg.attn_q_chunk)
    return x + shard(_proj_out(o, p["wo"]), "batch", "seq", "embed")


def _as_dtensor(t: torch.Tensor, mesh) -> DTensor:
    """``t`` on ``mesh``: a plain tensor (one every rank holds whole) replicated."""
    if isinstance(t, DTensor):
        return t
    return DTensor.from_local(t, mesh, [Replicate()] * mesh.ndim, run_check=False)


def _cache_write(cache: torch.Tensor, slot: torch.Tensor, new: torch.Tensor) -> None:
    """``cache[b, slot[b]] = new[b]`` for every row ``b``, in place.  On a mesh the
    cache may be split along its length (split-KV decode), where DTensor has no
    in-place indexed write: each rank writes its own shard, the rows whose slot
    lies in its part of the length (the others write back what they hold)."""
    if isinstance(cache, DTensor):
        mesh, pl = cache.device_mesh, cache.placements
        # new (B, KV, hd) and slot (B,) split as the cache's rows, heads and head_dim
        like_new = [Shard(p.dim - (p.dim > 1)) if p.is_shard() and p.dim != 1
                    else Replicate() for p in pl]
        like_slot = [Shard(0) if p.is_shard(0) else Replicate() for p in pl]
        new = _as_dtensor(new, mesh).redistribute(mesh, like_new).to_local()
        slot = _as_dtensor(slot, mesh).redistribute(mesh, like_slot).to_local()
        # this rank's part of the length, as DTensor chunks it over each mesh dim
        lo, size = 0, cache.shape[1]
        for m, p in enumerate(pl):
            if p.is_shard(1):
                chunk = -(-size // mesh.size(m))
                start = min(chunk * mesh.get_local_rank(m), size)
                lo, size = lo + start, min(chunk, size - start)
        at = slot - lo
        mine = (at >= 0) & (at < size)
        at = at.clamp(0, size - 1)
        local = cache.to_local()
        rows = torch.arange(local.shape[0], device=local.device)
        local[rows, at] = torch.where(mine[:, None, None], new, local[rows, at])
        return
    cache[torch.arange(cache.shape[0], device=slot.device), slot] = new


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
    _cache_write(cache_k, wpos, k[:, 0])
    _cache_write(cache_v, wpos, v[:, 0])
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
    defs = {"ln": ParamDef((d,), ("embed",), init="ones"),
            "w_up": ParamDef((d, f), ("fsdp", "mlp")),
            "w_down": ParamDef((f, d), ("mlp", "fsdp"))}
    if cfg.ffn_kind in ("swiglu", "geglu"):
        defs["w_gate"] = ParamDef((d, f), ("fsdp", "mlp"))
    return defs


def ffn_block(p, cfg, x: torch.Tensor) -> torch.Tensor:
    h = rms_norm(x, p["ln"], cfg.norm_eps)
    up = h @ p["w_up"]
    if "w_gate" in p:
        up = up * _act(cfg.ffn_kind, h @ p["w_gate"])
    else:
        up = _act(cfg.ffn_kind, up)
    up = shard(up, "batch", "seq", "mlp")
    return x + shard(up @ p["w_down"], "batch", "seq", "embed")


# ---------------------------------------------------------------------------
# Mixture of experts (capacity-gather dispatch, static shapes)
# ---------------------------------------------------------------------------


def moe_defs(cfg) -> dict:
    d, f, E = cfg.d_model, cfg.d_ff, cfg.n_experts
    return {"ln": ParamDef((d,), ("embed",), init="ones"),
            "router": ParamDef((d, E), ("fsdp", "experts")),
            "w_gate": ParamDef((E, d, f), ("experts", "expert_in", "expert_mlp")),
            "w_up": ParamDef((E, d, f), ("experts", "expert_in", "expert_mlp")),
            "w_down": ParamDef((E, f, d), ("experts", "expert_mlp", "expert_in"))}


class MoERoute(NamedTuple):
    """The dispatch plan of :func:`moe_block`: the number of token groups and
    the per-group capacity, then per group (G, tg*K) and sorted by expert id
    (stable, so the pairs of one expert keep token order) each (token, k)
    pair's expert, token, slot in the group's (E*C + 1)-row buffer (``E*C`` is
    the drop bin) and renormalised gate."""
    groups: int
    capacity: int
    expert: torch.Tensor
    token: torch.Tensor
    slot: torch.Tensor
    gate: torch.Tensor


def moe_route(p, cfg, h: torch.Tensor) -> MoERoute:
    """Route normed tokens h (B, S, d) by the reference's steps, one for one:
    fp32 router logits, softmax, top-k, gates renormalised and cast to h's
    dtype, the group count falling back to 1 when it does not divide the
    tokens, ``C = min(max(int(K*tg*cf/E), 1), tg)``, a stable sort by expert,
    each pair's rank in its expert's queue, pairs ranked ``>= C`` to the drop
    bin."""
    B, S, d = h.shape
    E, K = cfg.n_experts, cfg.top_k
    t = B * S
    G = max(cfg.moe_groups, 1)
    if t % G:
        G = 1
    tg = t // G
    C = min(max(int(K * tg * cfg.moe_capacity_factor / E), 1), tg)
    logits = (h.reshape(G, tg, d) @ p["router"]).float()
    plan = _group_local(_moe_plan, 4, logits, E=E, K=K, C=C, dtype=h.dtype)
    return MoERoute(G, C, *plan)


def _moe_plan(logits: torch.Tensor, *, E: int, K: int, C: int, dtype):
    """:func:`moe_route`'s plan from the router logits (G, tg, E), group by
    group: (expert, token, slot, gate), each (G, tg*K) sorted by expert."""
    G, tg, _ = logits.shape
    probs = torch.softmax(logits, dim=-1)
    gate, idx = torch.topk(probs, K, dim=-1)                 # (G, tg, K)
    gate = (gate / gate.sum(-1, keepdim=True)).to(dtype)
    flat_e = idx.reshape(G, tg * K)
    order = torch.argsort(flat_e, dim=1, stable=True)
    se = flat_e.gather(1, order)
    stok = torch.arange(tg, device=logits.device).repeat_interleave(K)[order]
    sg = gate.reshape(G, tg * K).gather(1, order)
    first = torch.searchsorted(
        se, torch.arange(E, device=logits.device, dtype=se.dtype).expand(G, E).contiguous())
    rank = torch.arange(tg * K, device=logits.device)[None] - first.gather(1, se)
    slot = torch.where(rank < C, se * C + rank, torch.full_like(se, E * C))
    return se, stok, slot, sg


def _group_local(fn, n_out: int, *args, **kw):
    """``fn(*args, **kw)`` for tensors whose leading dim is the MoE's token
    groups, which no step mixes.  On DTensors it runs on each rank's groups
    (``local_map``: the groups sharded as the first argument has them, every
    other dim whole), since the routing's sort, search and scatter have no
    sharding rules of their own."""
    if not isinstance(args[0], DTensor):
        return fn(*args, **kw)
    gp = [p if p.is_shard(0) else Replicate() for p in args[0].placements]
    ins = tuple(gp if isinstance(a, torch.Tensor) else None for a in args)
    outs = tuple([gp] * n_out) if n_out > 1 else gp
    return local_map(functools.partial(fn, **kw), out_placements=outs,
                     in_placements=ins, in_grad_placements=ins,
                     redistribute_inputs=True)(*args)


def _moe_dispatch(ht: torch.Tensor, stok: torch.Tensor, slot: torch.Tensor, *,
                  n_slots: int) -> torch.Tensor:
    """Gather each group's tokens (G, tg, d) into its (n_slots, d) expert
    slots; the drop bin's row is discarded."""
    G, _, d = ht.shape
    rows = torch.arange(G, device=ht.device)[:, None]
    buf = ht.new_zeros((G, n_slots + 1, d))
    buf[rows, slot] = ht[rows, stok]
    return buf[:, :-1]


def _moe_combine(yg: torch.Tensor, stok: torch.Tensor, slot: torch.Tensor,
                 sg: torch.Tensor, *, tg: int) -> torch.Tensor:
    """Each group's expert outputs (G, n_slots, d) back to its tokens (G, tg, d),
    weighted by the gates; the drop bin adds nothing."""
    G, _, d = yg.shape
    rows = torch.arange(G, device=yg.device)[:, None]
    yg = torch.cat([yg, yg.new_zeros((G, 1, d))], dim=1)
    contrib = yg[rows, slot] * sg[..., None]
    out = yg.new_zeros((G * tg, d)).index_add(
        0, (rows * tg + stok).reshape(-1), contrib.reshape(-1, d))
    return out.reshape(G, tg, d)


def moe_block(p, cfg, x: torch.Tensor) -> torch.Tensor:
    """Top-k MoE with group-local capacity dispatch, the reference's semantics:
    pairs past an expert's capacity ``C`` in their group go to the drop bin and
    add nothing.  Every expert runs all its ``G*C`` slots (empty ones on zeros),
    as three batched products over the experts."""
    B, S, d = x.shape
    E = cfg.n_experts
    h = rms_norm(x, p["ln"], cfg.norm_eps)
    G, C, _, stok, slot, sg = moe_route(p, cfg, h)
    tg = B * S // G
    # one group is whole on every rank: its size-1 dim split over a mesh dim of one
    # rank could not be viewed away
    groups = "batch" if G > 1 else None
    ht = shard(h.reshape(G, tg, d), groups, None, "embed")
    buf = _group_local(_moe_dispatch, 1, ht, stok, slot, n_slots=E * C)
    xe = buf.reshape(G, E, C, d).transpose(0, 1).reshape(E, G * C, d)
    xe = shard(xe, "experts", "batch", "embed")
    a = _act(cfg.ffn_kind, torch.bmm(xe, p["w_gate"]))
    ye = torch.bmm(torch.bmm(xe, p["w_up"]) * a, p["w_down"])      # (E, G*C, d)
    ye = shard(ye, "experts", "batch", "embed")
    yg = _unsplit(ye, 1, G).reshape(E, G, C, d).transpose(0, 1).reshape(G, E * C, d)
    yg = shard(yg, groups, None, "embed")
    out = _group_local(_moe_combine, 1, yg, stok, slot, sg, tg=tg)
    return x + shard(out.reshape(B, S, d), "batch", "seq", "embed")


# ---------------------------------------------------------------------------
# Chunked time scan (recurrent blocks)
#
# Differentiating an S-step loop keeps every step's inputs for the backward.
# Running chunks of ``chunk`` steps, each recomputed in the backward
# (``torch.utils.checkpoint``), keeps only the carries at chunk edges, as the
# reference remats each chunk of its ``lax.scan``.
# ---------------------------------------------------------------------------

TIME_SCAN_CHUNK = 256


def _scan(step, carry, xs: tuple, lo: int, hi: int):
    """Steps ``lo..hi-1`` of ``step(carry, inputs) -> (carry, y)``: the final
    carry and the ys stacked on a leading time dim."""
    ys = []
    for t in range(lo, hi):
        carry, y = step(carry, tuple(x[t] for x in xs))
        ys.append(y)
    return carry, torch.stack(ys)


def chunked_time_scan(step, carry, xs: tuple):
    """``lax.scan(step, carry, xs)`` as a Python loop over time; ``xs`` is a
    tuple of time-major tensors.  With gradients on, S > chunk and S a multiple
    of it (chunk = :data:`TIME_SCAN_CHUNK`, read at call time), each chunk is
    recomputed in the backward (non-reentrant ``torch.utils.checkpoint``);
    otherwise it is one plain loop."""
    chunk = TIME_SCAN_CHUNK
    S = xs[0].shape[0]
    if S <= chunk or S % chunk or not torch.is_grad_enabled():
        return _scan(step, carry, xs, 0, S)
    ys = []
    for lo in range(0, S, chunk):
        carry, y = checkpoint(_scan, step, carry, xs, lo, lo + chunk,
                              use_reentrant=False)
        ys.append(y)
    return carry, torch.cat(ys)


def _softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus``: log(1 + e^x) with no threshold (``F.softplus``
    returns x itself above 20, which float64 can tell apart)."""
    return torch.logaddexp(x, torch.zeros((), dtype=x.dtype, device=x.device))


# ---------------------------------------------------------------------------
# Mamba2 block (SSD recurrence)
# ---------------------------------------------------------------------------


def conv_channels(cfg) -> int:
    """The Mamba2 convolution's channels: x alone, or x, B and C of every group."""
    e = cfg.ssm_expand * cfg.d_model
    return e + 2 * cfg.ssm_groups * cfg.ssm_state if cfg.ssm_conv_xbc else e


def mamba_defs(cfg) -> dict:
    d = cfg.d_model
    e = cfg.ssm_expand * d
    nh = e // cfg.ssm_head_dim
    N, W, G = cfg.ssm_state, cfg.ssm_conv_width, cfg.ssm_groups
    defs = {"ln": ParamDef((d,), ("embed",), init="ones"),
            "w_z": ParamDef((d, e), ("fsdp", "mlp")),
            "w_x": ParamDef((d, e), ("fsdp", "mlp")),
            "w_B": ParamDef((d, G * N), ("fsdp", "state")),
            "w_C": ParamDef((d, G * N), ("fsdp", "state")),
            "w_dt": ParamDef((d, nh), ("fsdp", "heads")),
            "conv_w": ParamDef((W, conv_channels(cfg)), ("conv", "mlp"), scale=0.5)}
    if cfg.ssm_conv_bias:
        defs["conv_b"] = ParamDef((conv_channels(cfg),), ("mlp",), init="zeros")
    return {**defs,
            "A_log": ParamDef((nh,), ("heads",), init="zeros"),
            "D": ParamDef((nh,), ("heads",), init="ones"),
            "dt_bias": ParamDef((nh,), ("heads",), init="zeros"),
            "gn": ParamDef((e,), ("mlp",), init="ones"),
            "w_out": ParamDef((e, d), ("mlp", "fsdp"))}


def _mamba_scan_seq(x, B_in, C_in, dt, A_log, D, hd, *, h0=None):
    """Sequential SSD recurrence (the decode path, and prefill at lengths the
    chunkwise form does not take):

    h_t = exp(A dt_t) h_{t-1} + dt_t x_t B_t^T ;  y_t = h_t C_t + D x_t

    x (B,S,nh,hd), B_in/C_in (B,S,N), dt (B,S,nh).  The state is fp32; each
    y_t is cast to x's dtype.  Returns (y (B,S,nh,hd), h_final (B,nh,hd,N)).
    """
    Bb, S, nh, _ = x.shape
    N = B_in.shape[-1]
    A = -torch.exp(A_log.float())                          # (nh,) negative

    def step(h, inp):
        xt, Bt, Ct, dtt = inp                # (B,nh,hd), (B,N), (B,N), (B,nh)
        decay = torch.exp(A[None] * dtt)                   # (B,nh)
        dx = (dtt[..., None] * xt).float()                 # (B,nh,hd)
        h = h * decay[..., None, None] + dx[..., None] * Bt[:, None, None, :]
        y = torch.einsum("bhdn,bn->bhd", h, Ct.float())
        return h, y.to(x.dtype)

    if h0 is None:
        h0 = torch.zeros((Bb, nh, hd, N), dtype=torch.float32, device=x.device)
    xs = tuple(t.movedim(1, 0) for t in (x, B_in, C_in, dt))
    h_fin, ys = chunked_time_scan(step, h0, xs)
    return ys.movedim(0, 1) + D[None, None, :, None] * x, h_fin


def _local_rows_and_heads(fn, tensors, dims, out_dims):
    """``fn(*tensors)`` on each rank's shard, for a computation independent per
    batch row and per head (the recurrences' scans).  ``dims`` gives each input's
    (batch dim, head dim), ``None`` where it has none (it may run past the tensors
    given), and ``out_dims`` each output's; the batch and heads are split as the
    active rules split them in ``tensors[0]``, every other dim whole.  An input
    whole on a mesh dim that splits the work (``B`` over heads, ``A`` over batch
    rows) takes a partial-sum gradient there.  Run as DTensor ops, the scans'
    products flatten a batch dim and a head dim together, which DTensor cannot do
    where both are split (it raises in torch 2.11)."""
    first = tensors[0]
    mesh, rules = active_rules() or (first.device_mesh, AxisRules())
    axes = [None] * first.ndim
    axes[dims[0][0]], axes[dims[0][1]] = "batch", "heads"
    split = [None if not p.is_shard() else "batch" if p.dim == dims[0][0] else "heads"
             for p in rules.placements(axes, first.shape, mesh)]

    def placed(bd, hd):
        return tuple(Shard(bd) if k == "batch" and bd is not None else
                     Shard(hd) if k == "heads" and hd is not None else Replicate()
                     for k in split)

    ins = [placed(*d) for _, d in zip(tensors, dims)]
    grads = [tuple(Partial() if k and not p.is_shard() else p for k, p in zip(split, pl))
             for pl in ins]
    tensors = [_as_dtensor(t, mesh) for t in tensors]
    return local_map(fn, out_placements=tuple(placed(*d) for d in out_dims),
                     in_placements=tuple(ins), in_grad_placements=tuple(grads),
                     redistribute_inputs=True)(*tensors)


MAMBA_CHUNK = 128

#: Where the model's own spans (``model.ssd``, ``model.shared_block``) and counters
#: (``model.ssd.<form>``) go: ``(span, inc)`` as a caller installs them for a block
#: with :func:`recording` (the train step: its ``Obs`` through ``runtime.spans``).
#: Outside such a block nothing is recorded.
_recorder: tuple | None = None


@contextlib.contextmanager
def recording(span, inc):
    """Send the model's spans to ``span(name, **attrs)`` (a context manager) and its
    counters to ``inc(name)`` for the block."""
    global _recorder
    saved, _recorder = _recorder, (span, inc)
    try:
        yield
    finally:
        _recorder = saved


def model_span(name: str, **attrs):
    """A span of the model's own code: ``NULL_HANDLE`` outside :func:`recording`."""
    return NULL_HANDLE if _recorder is None else _recorder[0](name, **attrs)


def _count_ssd(form: str) -> None:
    """One SSD call (``mamba_block``'s prefill and decode alike): the chunkwise form
    once a layer, the sequential form once a group of B and C."""
    if _recorder is not None:
        _recorder[1](f"model.ssd.{form}")


def _mamba_scan(x, B_in, C_in, dt, A_log, D, hd, *, h0=None,
                chunk: int = MAMBA_CHUNK):
    """Chunkwise-parallel SSD (the Mamba2 paper's algorithm), the reference's
    ``_mamba_scan``; sequential when ``S % chunk`` or ``S <= chunk``:

      y_intra[t] = sum_{s<=t} exp(logP_t - logP_s) (C_t.B_s) u_s
      y_cross[t] = exp(logP_t) C_t . h_in
      h_out      = exp(logP_c) h_in + sum_t exp(logP_c - logP_t) u_t (x) B_t

    Every decay ratio is the exp of a non-positive number.  Only the chunk
    boundary states run in order (one small update a chunk); the products of
    all chunks with their incoming states are then taken at once.  With
    gradients on, the chunkwise form keeps only its inputs for the backward and
    recomputes the rest there (non-reentrant ``torch.utils.checkpoint``): its
    (B, n, c, c, heads) float32 decay ratios would otherwise stay alive, several
    of them, for every layer.  On CUDA tensors the chunkwise form is the
    hand-written kernels (``ops.ssd_chunked``, which also save only the inputs),
    one group or several; the plain forms here are the CPU's.

    B_in and C_in are (B,S,N), or (B,S,G,N) for G groups: head h reads group
    ``h // (nh / G)``.  Grouped, the chunkwise form is :func:`_ssd_chunked_groups`
    (all groups at once, the chunk states passed by one product); the sequential
    form runs each group's heads as a scan of their own.
    """
    if isinstance(x, DTensor):
        args = (x, B_in, C_in, dt, A_log, D) + ((h0,) if h0 is not None else ())
        return _local_rows_and_heads(
            lambda *a: _mamba_scan(*a[:6], hd, h0=a[6] if len(a) > 6 else None,
                                   chunk=chunk),
            args, ((0, 2), (0, None), (0, None), (0, 2), (None, 0), (None, 0), (0, 1)),
            ((0, 2), (0, 1)))
    S = x.shape[1]
    if B_in.ndim == 4 and not (S % chunk or S <= chunk):
        _count_ssd("chunked")
        if x.is_cuda:
            return ops.ssd_chunked(x, B_in, C_in, dt, A_log, D, h0, chunk)
        if torch.is_grad_enabled():
            return checkpoint(_ssd_chunked_groups, x, B_in, C_in, dt, A_log, D, hd, h0,
                              chunk, use_reentrant=False)
        return _ssd_chunked_groups(x, B_in, C_in, dt, A_log, D, hd, h0, chunk)
    if B_in.ndim == 4:
        G = B_in.shape[2]
        per = x.shape[2] // G
        parts = [_mamba_scan(x[:, :, h], B_in[:, :, g], C_in[:, :, g], dt[:, :, h],
                             A_log[h], D[h], hd, h0=None if h0 is None else h0[:, h],
                             chunk=chunk)
                 for g, h in ((g, slice(g * per, (g + 1) * per)) for g in range(G))]
        return (torch.cat([y for y, _ in parts], dim=2),
                torch.cat([hf for _, hf in parts], dim=1))
    if S % chunk or S <= chunk:
        _count_ssd("sequential")
        return _mamba_scan_seq(x, B_in, C_in, dt, A_log, D, hd, h0=h0)
    _count_ssd("chunked")
    if x.is_cuda:
        return ops.ssd_chunked(x, B_in[:, :, None], C_in[:, :, None], dt, A_log, D, h0, chunk)
    if torch.is_grad_enabled():
        return checkpoint(_ssd_chunked, x, B_in, C_in, dt, A_log, D, hd, h0, chunk,
                          use_reentrant=False)
    return _ssd_chunked(x, B_in, C_in, dt, A_log, D, hd, h0, chunk)


def _ssd_chunked(x, B_in, C_in, dt, A_log, D, hd, h0, chunk):
    """:func:`_mamba_scan`'s chunkwise form, S a multiple of ``chunk``."""
    Bb, S, nh, _ = x.shape
    N = B_in.shape[-1]
    A = -torch.exp(A_log.float())                          # (nh,)
    n = S // chunk

    def reshape_c(t):
        return t.reshape(Bb, n, chunk, *t.shape[2:])

    xc = reshape_c(x)
    Bc = reshape_c(B_in).float()
    Cc = reshape_c(C_in).float()
    dtc = reshape_c(dt).float()
    u = dtc[..., None] * xc.float()                        # (B,n,c,nh,hd)
    logP = torch.cumsum(A * dtc, dim=2)                    # (B,n,c,nh), <= 0
    logPc = logP[:, :, -1]                                 # (B,n,nh)

    # intra-chunk: (C_t.B_s) * exp(logP_t - logP_s), masked s <= t
    cb = torch.einsum("bntk,bnsk->bnts", Cc, Bc)           # (B,n,c,c)
    ratio = logP[:, :, :, None, :] - logP[:, :, None, :, :]   # (B,n,t,s,nh)
    mask = torch.ones((chunk, chunk), dtype=torch.bool, device=x.device).tril()
    ratio = torch.where(mask[None, None, :, :, None], ratio,
                        torch.full((), NEG_INF, dtype=ratio.dtype, device=x.device))
    y_intra = torch.einsum("bntsh,bnshd->bnthd", cb[..., None] * torch.exp(ratio), u)
    del ratio

    # chunk-boundary states, in order over the n chunks
    contrib = torch.einsum("bnthd,bntk->bnhdk",
                           torch.exp(logPc[:, :, None] - logP)[..., None] * u, Bc)
    h = h0 if h0 is not None else torch.zeros((Bb, nh, hd, N), dtype=torch.float32,
                                              device=x.device)
    decay = torch.exp(logPc)                               # (B,n,nh)
    h_in = []
    for i in range(n):
        h_in.append(h)
        h = h * decay[:, i, :, None, None] + contrib[:, i]
    y_cross = torch.einsum("bntk,bnhdk->bnthd", Cc, torch.stack(h_in, dim=1)) \
        * torch.exp(logP)[..., None]
    y = (y_intra + y_cross).reshape(Bb, S, nh, hd).to(x.dtype)
    return y + D[None, None, :, None] * x, h


def _ssd_chunked_groups(x, B_in, C_in, dt, A_log, D, hd, h0, chunk):
    """:func:`_ssd_chunked` for B and C in G groups (B_in, C_in (B,S,G,N); head h
    reads group h // (nh / G)), every group in one pass, S a multiple of ``chunk``.
    The chunk-boundary states are passed by one product instead of a loop over the
    chunks: with L_i the running sum of the chunks' total log decays (float64, so
    that near chunks keep their digits), the state leaving chunk i is
    ``sum_{j<=i} exp(L_i - L_j) contrib_j + exp(L_i) h0``."""
    Bb, S, nh, _ = x.shape
    G, N = B_in.shape[2], B_in.shape[3]
    per, n = nh // G, S // chunk
    A = -torch.exp(A_log.float()).reshape(G, per)

    def reshape_c(t, *tail):
        return t.reshape(Bb, n, chunk, *tail)

    u = reshape_c(dt, G, per).float()[..., None] * reshape_c(x, G, per, hd).float()
    Bc = reshape_c(B_in, G, N).float()
    Cc = reshape_c(C_in, G, N).float()
    logP = torch.cumsum(A * reshape_c(dt, G, per).float(), dim=2)   # (B,n,c,G,per)
    logPc = logP[:, :, -1]                                           # (B,n,G,per)

    # intra-chunk: (C_t.B_s) * exp(logP_t - logP_s), masked s <= t
    cb = torch.einsum("btgk,bsgk->btsg", Cc.flatten(0, 1), Bc.flatten(0, 1))
    ratio = logP[:, :, :, None] - logP[:, :, None]                   # (B,n,t,s,G,per)
    mask = torch.ones((chunk, chunk), dtype=torch.bool, device=x.device).tril()
    ratio = torch.where(mask[None, None, :, :, None, None], ratio,
                        torch.full((), NEG_INF, dtype=ratio.dtype, device=x.device))
    weights = cb.reshape(Bb, n, chunk, chunk, G)[..., None] * torch.exp(ratio)
    y_intra = torch.einsum("bntsgh,bnsghp->bntghp", weights, u)
    del ratio, weights

    # each chunk's own contribution to the state, then the states passed on
    contrib = torch.einsum("bntghp,bntgk->bnghpk",
                           torch.exp(logPc[:, :, None] - logP)[..., None] * u, Bc)
    Lc = torch.cumsum(logPc.double(), dim=1)                         # (B,n,G,per)
    seg = Lc[:, :, None] - Lc[:, None]                               # (B,i,j,G,per)
    after = torch.ones((n, n), dtype=torch.bool, device=x.device).tril()[None, :, :, None, None]
    carry = torch.where(after, torch.exp(torch.where(after, seg, 0.0)), 0.0).float()
    h_out = torch.einsum("bijgh,bjghpk->bighpk", carry, contrib)     # leaving chunk i
    if h0 is not None:
        h_out = h_out + torch.exp(Lc).float()[..., None, None] * h0.reshape(Bb, 1, G, per, hd, N)
        first = h0.reshape(Bb, 1, G, per, hd, N)
    else:
        first = torch.zeros_like(h_out[:, :1])
    h_in = torch.cat([first, h_out[:, :-1]], dim=1)
    y_cross = torch.einsum("bntgk,bnghpk->bntghp", Cc, h_in) * torch.exp(logP)[..., None]
    y = (y_intra + y_cross).reshape(Bb, S, nh, hd).to(x.dtype)
    return y + D[None, None, :, None] * x, h_out[:, -1].reshape(Bb, nh, hd, N)


def _group_rms_norm(y: torch.Tensor, w: torch.Tensor, groups: int,
                    eps: float) -> torch.Tensor:
    """RMSNorm over each of ``groups`` equal slices of the last dim, each with its
    own slice of the gains ``w`` (the published Mamba2's gated norm); one group is
    :func:`rms_norm`."""
    if groups == 1:
        return rms_norm(y, w, eps)
    return torch.cat([rms_norm(part.contiguous(), wg, eps) for part, wg in
                      zip(y.chunk(groups, dim=-1), w.chunk(groups))], dim=-1)


def mamba_block(p, cfg, x: torch.Tensor, *, state=None, conv_state=None,
                add: torch.Tensor | None = None):
    """Mamba2 residual block: prefill over the whole sequence (chunkwise SSD),
    or, with ``state`` (B,nh,hd,N) fp32 and ``conv_state`` (B,W-1,channels), one
    decode step.  Returns (out, final SSM state, the last W-1 conv inputs).

    ``add`` (a shared block's output, zamba2-7b) joins the block's input only:
    ``x + mamba(norm(x + add))``.  With ``cfg.ssm_conv_xbc`` the convolution runs
    over x, B and C together (with ``conv_b`` when ``cfg.ssm_conv_bias``), and B and
    C come in ``cfg.ssm_groups`` groups, the gated norm taken per group."""
    Bb, S, d = x.shape
    e = cfg.ssm_expand * d
    hd = cfg.ssm_head_dim
    nh = e // hd
    W = cfg.ssm_conv_width
    G, N = cfg.ssm_groups, cfg.ssm_state
    h = rms_norm(x if add is None else x + add, p["ln"], cfg.norm_eps)
    z = h @ p["w_z"]
    xin = shard(h @ p["w_x"], "batch", "seq", "mlp")
    if cfg.ssm_conv_xbc:
        xin = torch.cat([xin, h @ p["w_B"], h @ p["w_C"]], dim=-1)
    ch = xin.shape[-1]
    # causal depthwise conv
    if conv_state is not None:                             # decode: (B, W-1, ch)
        window = torch.cat([conv_state, xin], dim=1)       # (B, W, ch)
        new_conv = window[:, 1:]
        xc = torch.einsum("bwe,we->be", window, p["conv_w"])[:, None]
    else:
        win = torch.cat([xin.new_zeros((Bb, W - 1, ch)), xin], dim=1)
        xc = sum(win[:, i:i + S] * p["conv_w"][i] for i in range(W))
        new_conv = win[:, S:]                              # the last W-1 inputs
    if "conv_b" in p:
        xc = xc + p["conv_b"]
    xc = F.silu(xc)
    if cfg.ssm_conv_xbc:
        xc, B_in, C_in = xc.split([e, G * N, G * N], dim=-1)
    else:
        B_in = h @ p["w_B"]
        C_in = h @ p["w_C"]
    if G > 1:
        B_in = B_in.reshape(*B_in.shape[:2], G, N)
        C_in = C_in.reshape(*C_in.shape[:2], G, N)
    dt = _softplus(h @ p["w_dt"] + p["dt_bias"])
    with model_span("model.ssd", S=xc.shape[1]):
        y, h_fin = _mamba_scan(_split_last(xc, nh, hd), B_in, C_in, dt,
                               p["A_log"], p["D"], hd, h0=state)
    y = _merge_last(y) * F.silu(z)
    y = _group_rms_norm(y, p["gn"], G, cfg.norm_eps)
    return x + shard(y @ p["w_out"], "batch", "seq", "embed"), h_fin, new_conv


# ---------------------------------------------------------------------------
# Shared attention + MLP block (zamba2-7b), used at several layers
# ---------------------------------------------------------------------------


def shared_block_defs(cfg) -> dict:
    """One shared block: attention over concat(h, embedding) (2 * d_model wide,
    no biases) into d_model, and a GeGLU MLP on d_model."""
    H, KV, hd, d, w = cfg.n_heads, cfg.n_kv_heads, cfg.hd, cfg.d_model, 2 * cfg.d_model
    return {"attn": {"ln": ParamDef((w,), ("mlp",), init="ones"),
                     "wq": ParamDef((w, H, hd), ("fsdp", "heads", "head_dim")),
                     "wk": ParamDef((w, KV, hd), ("fsdp", "kv_heads", "head_dim")),
                     "wv": ParamDef((w, KV, hd), ("fsdp", "kv_heads", "head_dim")),
                     "wo": ParamDef((H, hd, d), ("heads", "head_dim", "fsdp"))},
            "ffn": ffn_defs(cfg)}


def shared_use_defs(cfg) -> dict:
    """What each use of a shared block holds of its own: the rank-r adapter on the
    MLP's gate and up products (``a_in`` d x r, then ``a_gate`` and ``a_up`` r x
    d_ff) and the d x d ``linear`` that maps the block's output."""
    d, f, r = cfg.d_model, cfg.d_ff, cfg.adapter_rank
    return {"a_in": ParamDef((d, r), ("fsdp", None)),
            "a_gate": ParamDef((r, f), (None, "mlp")),
            "a_up": ParamDef((r, f), (None, "mlp")),
            "linear": ParamDef((d, d), ("fsdp", "embed"))}


def shared_block(a, f, use, cfg, x: torch.Tensor, e0: torch.Tensor,
                 positions: torch.Tensor) -> torch.Tensor:
    """A shared block's output at one use, before the layer's Mamba2 (no residual
    inside it): h = norm(concat(x, e0)); attention (rope, causal, the softmax
    scale ``cfg.softmax_scale``) into d_model; norm; the GeGLU MLP with the
    use's adapter added to its gate and up products; the use's linear.  ``a`` and
    ``f`` are the block's attention and MLP parameters, ``use`` the use's own."""
    h = rms_norm(torch.cat([x, e0], dim=-1), a["ln"], cfg.norm_eps)
    q, k, v = _proj_in(h, a["wq"]), _proj_in(h, a["wk"]), _proj_in(h, a["wv"])
    cos, sin = rope_tables(positions, cfg.hd, cfg.rope_theta)
    q, k = _rotate(q, cos, sin), _rotate(k, cos, sin)
    o = ops.flash_attention(q, k, v, causal=True, scale=cfg.softmax_scale)
    h = rms_norm(_proj_out(o, a["wo"]), f["ln"], cfg.norm_eps)
    lo = h @ use["a_in"]
    gate = h @ f["w_gate"] + lo @ use["a_gate"]
    up = h @ f["w_up"] + lo @ use["a_up"]
    y = (_act("geglu", gate, cfg.gelu_approximate) * up) @ f["w_down"]
    return y @ use["linear"]


# ---------------------------------------------------------------------------
# xLSTM blocks
# ---------------------------------------------------------------------------


def mlstm_defs(cfg) -> dict:
    d = cfg.d_model
    e = 2 * d
    H = cfg.n_heads
    return {"ln": ParamDef((d,), ("embed",), init="ones"),
            "w_up": ParamDef((d, e), ("fsdp", "mlp")),      # pre up-projection
            "wq": ParamDef((e, e), ("mlp", "mlp")),
            "wk": ParamDef((e, e), ("mlp", "mlp")),
            "wv": ParamDef((e, e), ("mlp", "mlp")),
            "w_i": ParamDef((e, H), ("mlp", "heads")),
            "w_f": ParamDef((e, H), ("mlp", "heads")),
            "w_o": ParamDef((e, e), ("mlp", "mlp")),
            "w_down": ParamDef((e, d), ("mlp", "fsdp"))}


def _mlstm_chunkwise(q, k, v, it, ft, state, *, chunk: int):
    """Chunkwise-parallel mLSTM (stabilised linear attention), the reference's
    ``_mlstm_chunkwise``.  With F_t = cumsum(log f) the stabiliser is
    m_t = F_t + max(M_in, cummax_s(i_s - F_s)), so the intra-chunk part is a
    masked product A_ts = (q_t.k_s) e^{F_t-F_s+i_s-m_t} (every exponent <= 0)
    and the carried state adds e^{F_t + M_in - m_t} (C_in q_t).

    q, k, v: (B,S,H,hd) (k scaled by 1/sqrt(hd)); it, ft: (B,S,H) fp32 raw
    gates; state = (C, n, m).  Returns (y (B,S,H,hd) fp32, new state).
    """
    Bb, S, H, hd = q.shape
    n = S // chunk
    qc = q.reshape(Bb, n, chunk, H, hd).float()
    kc = k.reshape(Bb, n, chunk, H, hd).float()
    vc = v.reshape(Bb, n, chunk, H, hd).float()
    ic = it.reshape(Bb, n, chunk, H)
    F_ = torch.cumsum(-_softplus(-ft).reshape(Bb, n, chunk, H), dim=2)
    Gmax = torch.cummax(ic - F_, dim=2).values             # cummax(i_s - F_s)
    tri = torch.ones((chunk, chunk), dtype=torch.bool, device=q.device).tril()
    fill = torch.full((), NEG_INF, dtype=torch.float32, device=q.device)
    C, nv, M = state                          # (B,H,hd,hd), (B,H,hd), (B,H)
    ys = []
    for c in range(n):
        qt, kt, vt = qc[:, c], kc[:, c], vc[:, c]
        i_t, F_t, Gm = ic[:, c], F_[:, c], Gmax[:, c]
        m = F_t + torch.maximum(M[:, None], Gm)            # (B,c,H)
        ratio = F_t[:, :, None] - F_t[:, None, :] + i_t[:, None, :] - m[:, :, None]
        ratio = torch.where(tri[None, :, :, None], ratio, fill)   # (B,t,s,H)
        A = torch.einsum("bthd,bshd->bhts", qt, kt) * torch.exp(ratio).movedim(3, 1)
        num_intra = torch.einsum("bhts,bshd->bthd", A, vt)
        den_intra = A.sum(dim=3).movedim(1, 2)             # (B,t,H)
        w_in = torch.exp(F_t + M[:, None] - m)             # (B,c,H)
        num_cross = torch.einsum("bhkv,bthk->bthv", C, qt) * w_in[..., None]
        den_cross = torch.einsum("bhk,bthk->bth", nv, qt) * w_in
        den = torch.abs(den_intra + den_cross)
        ys.append((num_intra + num_cross) / torch.clamp(den, min=1.0)[..., None])
        m_out = m[:, -1]                                   # (B,H)
        Fc = F_t[:, -1]
        wS = torch.exp(Fc + M - m_out)
        wk = torch.exp(Fc[:, None] - F_t + i_t - m_out[:, None])   # (B,c,H)
        C = C * wS[..., None, None] + torch.einsum("bshk,bshv->bhkv",
                                                   kt * wk[..., None], vt)
        nv = nv * wS[..., None] + torch.einsum("bshk,bsh->bhk", kt, wk)
        M = m_out
    return torch.stack(ys, dim=1).reshape(Bb, S, H, hd), (C, nv, M)


MLSTM_CHUNK = 64


def mlstm_block(p, cfg, x: torch.Tensor, *, state=None):
    """mLSTM: matrix-memory recurrent block (xLSTM).  Chunkwise when
    ``S % MLSTM_CHUNK == 0 and S > MLSTM_CHUNK``, the sequential step otherwise
    (decode always).  ``state`` = (C (B,H,hd,hd), n (B,H,hd), m (B,H)), fp32.
    Returns (out, new state)."""
    Bb, S, d = x.shape
    H = cfg.n_heads
    e = p["w_up"].shape[1]
    hd = e // H
    h = rms_norm(x, p["ln"], cfg.norm_eps)
    u = F.silu(h @ p["w_up"])
    q = _split_last(u @ p["wq"], H, hd)
    k = _split_last(u @ p["wk"], H, hd) / math.sqrt(hd)
    v = _split_last(u @ p["wv"], H, hd)
    it = (u @ p["w_i"]).float()
    ft = (u @ p["w_f"]).float()
    if state is None:
        f32 = dict(dtype=torch.float32, device=x.device)
        state = (torch.zeros((Bb, H, hd, hd), **f32), torch.zeros((Bb, H, hd), **f32),
                 torch.full((Bb, H), NEG_INF, **f32))
    scan = functools.partial(_mlstm_scan, dtype=x.dtype)
    if isinstance(q, DTensor):
        ys, *state = _local_rows_and_heads(scan, (q, k, v, it, ft, *state),
                                           ((0, 2),) * 5 + ((0, 1),) * 3,
                                           ((0, 2),) + ((0, 1),) * 3)
    else:
        ys, *state = scan(q, k, v, it, ft, *state)
    y = _merge_last(ys) * F.silu(u @ p["w_o"])
    return x + y @ p["w_down"], tuple(state)


def _mlstm_scan(q, k, v, it, ft, C, n, m, *, dtype):
    """The mLSTM's recurrence over (B,S,H,...) inputs from state ``(C, n, m)``:
    chunkwise when ``S % MLSTM_CHUNK == 0 and S > MLSTM_CHUNK``, the sequential
    step otherwise.  Returns (y (B,S,H,hd) in ``dtype``, C, n, m)."""
    S = q.shape[1]

    def step(carry, inp):
        C, n, m = carry                       # (B,H,hd,hd), (B,H,hd), (B,H)
        qt, kt, vt, i_t, f_t = inp
        logf = -_softplus(-f_t)                            # log sigmoid(f)
        m_new = torch.maximum(logf + m, i_t)
        fg = torch.exp(logf + m - m_new)[..., None]
        ig = torch.exp(i_t - m_new)[..., None]
        C = C * fg[..., None] + ig[..., None] * \
            (kt[..., :, None] * vt[..., None, :]).float()
        n = n * fg + ig * kt.float()
        num = torch.einsum("bhkv,bhk->bhv", C, qt.float())
        den = torch.abs(torch.einsum("bhk,bhk->bh", n, qt.float()))
        y = num / torch.clamp(den, min=1.0)[..., None]
        return (C, n, m_new), y.to(dtype)

    if S % MLSTM_CHUNK == 0 and S > MLSTM_CHUNK:
        ys, state = _mlstm_chunkwise(q, k, v, it, ft, (C, n, m), chunk=MLSTM_CHUNK)
        return (ys.to(dtype), *state)
    xs = tuple(t.movedim(1, 0) for t in (q, k, v, it, ft))
    state, ys = chunked_time_scan(step, (C, n, m), xs)
    return (ys.movedim(0, 1), *state)


def slstm_defs(cfg) -> dict:
    d = cfg.d_model
    H = cfg.n_heads
    hd = d // H
    f = int(4 * d / 3 / 64) * 64 or 64
    return {"ln": ParamDef((d,), ("embed",), init="ones"),
            "w_zifo": ParamDef((d, 4 * d), ("fsdp", "mlp")),
            "r_zifo": ParamDef((H, hd, 4 * hd), ("heads", "head_dim", None),
                               scale=0.1),
            "gn": ParamDef((d,), ("embed",), init="ones"),
            "w_up": ParamDef((d, 2 * f), ("fsdp", "mlp")),
            "w_down": ParamDef((f, d), ("mlp", "fsdp"))}


def slstm_block(p, cfg, x: torch.Tensor, *, state=None):
    """sLSTM: scalar-memory recurrent block with a block-diagonal recurrence and
    exponential gating, then a gated up/down MLP (xLSTM).  Always sequential.
    ``state`` = (c, n (B,H,hd) fp32, h (B,H,hd) in x's dtype, m (B,H) fp32).
    Returns (out, new state)."""
    Bb, S, d = x.shape
    H = cfg.n_heads
    hd = d // H
    h = rms_norm(x, p["ln"], cfg.norm_eps)
    zifo = h @ p["w_zifo"]                                 # (B,S,4d)

    def step(carry, inp):
        c, n, hprev, m = carry
        (g_in,) = inp
        g = _split_last(g_in, H, 4 * hd) + torch.einsum("bhk,hkf->bhf", hprev,
                                                          p["r_zifo"])
        zt, it, ft, ot = torch.chunk(g.float(), 4, dim=-1)
        it, ft = it.mean(-1), ft.mean(-1)                  # scalar gates per head
        logf = -_softplus(-ft)
        m_new = torch.maximum(logf + m, it)
        fg = torch.exp(logf + m - m_new)[..., None]
        ig = torch.exp(it - m_new)[..., None]
        c = c * fg + ig * torch.tanh(zt)
        n = n * fg + ig
        hn = (torch.sigmoid(ot) * c / torch.clamp(n, min=1.0)).to(x.dtype)
        return (c, n, hn, m_new), hn

    if state is None:
        f32 = dict(dtype=torch.float32, device=x.device)
        state = (torch.zeros((Bb, H, hd), **f32), torch.zeros((Bb, H, hd), **f32),
                 torch.zeros((Bb, H, hd), dtype=x.dtype, device=x.device),
                 torch.full((Bb, H), NEG_INF, **f32))
    state, ys = chunked_time_scan(step, state, (zifo.movedim(1, 0),))
    y = rms_norm(_merge_last(ys.movedim(0, 1)), p["gn"], cfg.norm_eps)
    up, gate = torch.chunk(y @ p["w_up"], 2, dim=-1)
    return x + (up * F.gelu(gate, approximate="tanh")) @ p["w_down"], state


# ---------------------------------------------------------------------------
# Cross-attention (VLM image layers, whisper decoder)
# ---------------------------------------------------------------------------


def cross_attn_defs(cfg) -> dict:
    H, KV, hd, d = cfg.n_heads, cfg.n_kv_heads, cfg.hd, cfg.d_model
    return {"ln": ParamDef((d,), ("embed",), init="ones"),
            "wq": ParamDef((d, H, hd), ("fsdp", "heads", "head_dim")),
            "wk": ParamDef((d, KV, hd), ("fsdp", "kv_heads", "head_dim")),
            "wv": ParamDef((d, KV, hd), ("fsdp", "kv_heads", "head_dim")),
            "wo": ParamDef((H, hd, d), ("heads", "head_dim", "fsdp")),
            "gate": ParamDef((1,), (None,), init="zeros")}  # llama-vision's tanh gate


def cross_attn_block(p, cfg, x: torch.Tensor, memory: torch.Tensor) -> torch.Tensor:
    """Attend from x (B, S, d) to a memory (B, M, d): no rope, no mask, k and v
    projected from the memory as it is; the output scaled by ``tanh(gate)``.
    Attention is :func:`mha` without positions (the kernel on the card), where
    ``S > M`` is allowed because nothing is masked."""
    B, S, d = x.shape
    KV, hd, H = cfg.n_kv_heads, cfg.hd, cfg.n_heads
    h = rms_norm(x, p["ln"], cfg.norm_eps)
    q = _unsplit(_proj_in(h, p["wq"]), 2, KV).reshape(B, S, KV, H // KV, hd)
    k = _proj_in(memory, p["wk"])
    v = _proj_in(memory, p["wv"])
    o = mha(q, k, v, causal=False, q_chunk=cfg.attn_q_chunk)
    return x + torch.tanh(p["gate"].to(x.dtype)) * _proj_out(o, p["wo"])


# ---------------------------------------------------------------------------
# Embedding / unembedding
# ---------------------------------------------------------------------------


def embed_defs(cfg) -> dict:
    return {"tok": ParamDef((cfg.vocab, cfg.d_model), ("vocab", "embed"),
                            scale=0.02)}


def embed(p, cfg, tokens: torch.Tensor) -> torch.Tensor:
    x = F.embedding(tokens, p["tok"]).to(cfg.torch_dtype)
    if cfg.scale_embed:
        x = x * math.sqrt(cfg.d_model)
    return shard(x, "batch", "seq", "embed")


def logits_chunked(x: torch.Tensor, emb: torch.Tensor, cfg,
                   chunk: int = 512) -> torch.Tensor:
    """(B,S,d) @ (V,d)^T with the tied unembedding in x's dtype; full logits,
    so call it on few positions when V is large."""
    logits = x @ emb.to(x.dtype).t()
    if cfg.logit_softcap:
        logits = torch.tanh(logits / cfg.logit_softcap) * cfg.logit_softcap
    return shard(logits, "batch", "seq", "vocab")


def _xent_chunk(xs: torch.Tensor, emb: torch.Tensor, ls: torch.Tensor,
                softcap: float):
    """Summed masked cross-entropy and label count of one sequence chunk."""
    lg = xs @ emb.to(xs.dtype).t()
    if softcap:
        lg = torch.tanh(lg / softcap) * softcap
    lg = shard(lg, "batch", "seq", "vocab").float()
    # kept (B, cs, 1): on a vocab-sharded DTensor the gathered pick stays a
    # masked partial sum until it meets lse, and DTensor resolves it only in the
    # gather's own shape
    lse = torch.logsumexp(lg, dim=-1, keepdim=True)
    pick = lg.gather(-1, ls.clamp(min=0).long()[..., None])
    mask = (ls >= 0).float()
    return ((lse - pick)[..., 0] * mask).sum(), mask.sum()


def xent_loss(x: torch.Tensor, emb: torch.Tensor, labels: torch.Tensor, cfg,
              chunk: int = 256) -> torch.Tensor:
    """Chunked cross-entropy: never materializes (B,S,V) at once.

    x: (B,S,d) final hidden; emb: (V,d) tied unembedding; labels: (B,S).
    Label -100 entries are masked out; the mean is over the unmasked labels,
    fp32.  With gradients each chunk is recomputed in the backward
    (``torch.utils.checkpoint``), so no chunk's (B, cs, V) fp32 logits outlive
    its own forward and backward.
    """
    B, S, d = x.shape
    cs = min(chunk, S)
    while S % cs:
        cs -= 1
    remat = torch.is_grad_enabled() and (x.requires_grad or emb.requires_grad)
    tot = torch.zeros((), dtype=torch.float32, device=x.device)
    cnt = torch.zeros((), dtype=torch.float32, device=x.device)
    for i in range(S // cs):     # cs chosen so that there are few chunks
        args = (x[:, i * cs:(i + 1) * cs], emb, labels[:, i * cs:(i + 1) * cs],
                cfg.logit_softcap)
        a, b = (checkpoint(_xent_chunk, *args, use_reentrant=False) if remat
                else _xent_chunk(*args))
        tot, cnt = tot + a, cnt + b
    return tot / torch.clamp(cnt, min=1.0)
