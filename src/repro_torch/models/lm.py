"""Composable LM covering the ten architectures: training and serving.

One :class:`LM` consumes an :class:`repro_torch.models.config.ArchConfig` and
provides ``init / encode / forward / loss / prefill / init_cache /
unstack_cache / serving_cache / decode_step``.  It is an ``nn.Module`` holding an
``nn.ModuleList`` of blocks; block ``i`` is cycle ``c`` and pattern position
``p`` of the reference's stacked layout, ``i = c * cycle_len + p``.  The layer
functions live in :mod:`repro_torch.models.layers`.

Block kinds (``cfg.block_pattern``): ``"attn"`` (self-attention + FFN, or +
MoE when ``cfg.n_experts``); ``"cross_attn"`` (self-attention + cross-attention
to a memory + FFN: llama-3.2-vision's image layers, whisper's decoder), with
whisper's encoder; ``"mamba"`` (Mamba2); ``"mlstm"`` / ``"slstm"`` (xLSTM);
``"shared_attn"`` (zamba2: one attention + FFN weight set, ``LM.shared``, reused
at every occurrence behind a per-occurrence ``in_proj``, causal over a sliding
window whose decode cache is a ring buffer).  The memory is the encoded
``audio_embed`` (whisper) or the ``vision_embed`` as given (llama-vision); a
model without cross-attention ignores both.

``forward`` and ``loss`` run with gradients: the RMSNorm and attention kernels
sit on the path through their ``autograd.Function``s (kernels/), and ``remat``
recomputes each block in the backward through ``torch.utils.checkpoint``.
"""

from __future__ import annotations

import functools
import math

import torch
from torch import nn
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from repro_torch.models import layers as L
from repro_torch.models.config import ArchConfig


class Block(nn.Module):
    """Parameters of one layer: a ``ParameterDict`` per group of its block
    definition (``attn`` and ``ffn`` or ``moe``; ``cross`` too for
    ``"cross_attn"``; ``mamba``, ``mlstm`` or ``slstm``), or the parameter
    itself for a bare one (``"shared_attn"``'s ``in_proj``)."""

    def __init__(self, defs: dict, dtype: torch.dtype, device):
        super().__init__()
        for group, group_defs in defs.items():
            setattr(self, group, L.materialize(group_defs, dtype, device))


def _tree_map(fn, *trees):
    """``fn`` over the tensors of dicts / tuples of one structure (a cache)."""
    if isinstance(trees[0], dict):
        return {k: _tree_map(fn, *(t[k] for t in trees)) for k in trees[0]}
    if isinstance(trees[0], tuple):
        return tuple(_tree_map(fn, *parts) for parts in zip(*trees))
    return fn(*trees)


#: matrix products without batch dims: what ``remat="selective"`` keeps, as the
#: reference's ``dots_with_no_batch_dims_saveable`` policy does
_SAVED_PRODUCTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)
REMAT = ("none", "selective", "full")


def _save_products(ctx, op, *args, **kwargs):
    return (CheckpointPolicy.MUST_SAVE if op in _SAVED_PRODUCTS
            else CheckpointPolicy.PREFER_RECOMPUTE)


class LM(nn.Module):
    """``LM(cfg, device=...)`` allocates the parameters (uninitialized) in
    ``cfg.torch_dtype`` on ``device``; :meth:`init` fills them from a
    ``torch.Generator``, ``convert.load_jax_params`` from the reference's
    parameter tree."""

    def __init__(self, cfg: ArchConfig, *, device="cuda",
                 dtype: torch.dtype | None = None):
        super().__init__()
        self.cfg = cfg
        dtype = dtype or cfg.torch_dtype
        self.embed = L.materialize(L.embed_defs(cfg), dtype, device)
        self.final_norm = L.materialize(
            L.ParamDef((cfg.d_model,), ("embed",), init="ones"), dtype, device)
        self.blocks = nn.ModuleList(
            Block(self.block_defs(cfg.block_kind(i)), dtype, device)
            for i in range(cfg.n_layers))
        if "shared_attn" in cfg.pattern:
            self.shared = Block(self.attn_ffn_defs(), dtype, device)
        if cfg.encoder_layers:
            self.encoder = nn.ModuleList(
                Block(self.attn_ffn_defs(), dtype, device)
                for _ in range(cfg.encoder_layers))
            self.enc_norm = L.materialize(
                L.ParamDef((cfg.d_model,), ("embed",), init="ones"), dtype, device)

    # ------------------------------------------------------------------
    # Parameters
    # ------------------------------------------------------------------

    def block_defs(self, kind: str) -> dict:
        cfg = self.cfg
        if kind == "attn":
            return {"attn": L.attn_defs(cfg),
                    **({"moe": L.moe_defs(cfg)} if cfg.n_experts
                       else {"ffn": L.ffn_defs(cfg)})}
        if kind == "cross_attn":
            return {"attn": L.attn_defs(cfg), "cross": L.cross_attn_defs(cfg),
                    "ffn": L.ffn_defs(cfg)}
        if kind == "mamba":
            return {"mamba": L.mamba_defs(cfg)}
        if kind == "mlstm":
            return {"mlstm": L.mlstm_defs(cfg)}
        if kind == "slstm":
            return {"slstm": L.slstm_defs(cfg)}
        if kind == "shared_attn":
            return {"in_proj": L.ParamDef((cfg.d_model, cfg.d_model),
                                          ("fsdp", "embed"), scale=0.02)}
        raise ValueError(f"unknown block kind {kind!r}")

    def attn_ffn_defs(self) -> dict:
        """Self-attention + FFN: one encoder layer (whisper), and zamba2's shared
        block (held once)."""
        return {"attn": L.attn_defs(self.cfg), "ffn": L.ffn_defs(self.cfg)}

    def param_defs(self) -> dict:
        """The reference's parameter tree: ``pos{p}`` stacked over cycles,
        ``shared`` once, and ``encoder`` stacked over its layers."""
        cfg = self.cfg
        defs: dict = {
            "embed": L.embed_defs(cfg),
            "final_norm": L.ParamDef((cfg.d_model,), ("embed",), init="ones"),
        }
        for p, kind in enumerate(cfg.pattern):
            defs[f"pos{p}"] = L.stack_defs(self.block_defs(kind),
                                           cfg.n_cycles)
        if "shared_attn" in cfg.pattern:
            defs["shared"] = self.attn_ffn_defs()
        if cfg.encoder_layers:
            defs["encoder"] = L.stack_defs(self.attn_ffn_defs(),
                                           cfg.encoder_layers)
            defs["enc_norm"] = L.ParamDef((cfg.d_model,), ("embed",), init="ones")
        return defs

    def init(self, generator: torch.Generator) -> "LM":
        """Random init by the reference's rule (normal / sqrt(fan_in), embed
        0.02, norms ones, biases and gates zeros), parameter by parameter on the
        generator's device."""
        cfg = self.cfg
        L.init_params(self.embed, L.embed_defs(cfg), generator)
        layers = [(blk, self.block_defs(cfg.block_kind(i)))
                  for i, blk in enumerate(self.blocks)]
        if "shared_attn" in cfg.pattern:
            layers.append((self.shared, self.attn_ffn_defs()))
        if cfg.encoder_layers:
            layers += [(lyr, self.attn_ffn_defs()) for lyr in self.encoder]
        with torch.no_grad():
            self.final_norm.fill_(1.0)
            if cfg.encoder_layers:
                self.enc_norm.fill_(1.0)
        for blk, defs in layers:
            for group, group_defs in defs.items():
                L.init_params(getattr(blk, group), group_defs, generator)
        return self

    def n_params(self) -> int:
        return sum(math.prod(d.shape)
                   for _, d in L.flatten_defs(self.param_defs()))

    def abstract_params(self) -> dict:
        """:meth:`param_defs` as meta tensors in the parameters' dtype: shapes
        without storage (for sharding plans and dry runs)."""
        dtype = self.embed["tok"].dtype
        return L._map_defs(lambda d: torch.empty(d.shape, dtype=dtype, device="meta"),
                           self.param_defs())

    def param_axes(self) -> dict:
        """The logical-axis tree of :meth:`param_defs` (``pos{p}`` leaves lead
        with ``"layers"``)."""
        return L._map_defs(lambda d: d.axes, self.param_defs())

    # ------------------------------------------------------------------
    # Encoder / memory (whisper's audio frames, llama-vision's patches)
    # ------------------------------------------------------------------

    def encode(self, audio_embed: torch.Tensor) -> torch.Tensor:
        """Whisper's encoder over precomputed frame embeddings (B, F, d):
        non-causal self-attention with rope over the frame positions and an
        FFN per layer, then ``enc_norm``."""
        cfg = self.cfg
        x = audio_embed
        B, F = x.shape[:2]
        pos = torch.arange(F, device=x.device)[None].expand(B, F)
        for lyr in self.encoder:
            x = L.attn_block(lyr.attn, cfg, x, pos, causal=False)
            x = L.ffn_block(lyr.ffn, cfg, x)
        return L.rms_norm(x, self.enc_norm, cfg.norm_eps)

    def _memory(self, audio_embed, vision_embed):
        """What cross-attention attends to; None for a model without it."""
        if self.cfg.encoder_layers:
            if audio_embed is None:
                raise ValueError(f"{self.cfg.name} needs audio_embed")
            return self.encode(audio_embed)
        if self.cfg.cross_attn_every:
            if vision_embed is None:
                raise ValueError(f"{self.cfg.name} needs vision_embed")
            return vision_embed
        return None

    @staticmethod
    def _ffn(blk: Block, cfg: ArchConfig, x: torch.Tensor) -> torch.Tensor:
        if hasattr(blk, "moe"):
            return L.moe_block(blk.moe, cfg, x)
        return L.ffn_block(blk.ffn, cfg, x)

    # ------------------------------------------------------------------
    # Forward (prefill)
    # ------------------------------------------------------------------

    def _block(self, kind: str, blk: Block, x: torch.Tensor,
               positions: torch.Tensor, memory: torch.Tensor | None):
        """One layer over the whole sequence: (new x, its cache entry).  The
        entry is the layer's k and v (for ``"shared_attn"`` before the ring
        layout), the Mamba2 ``ssm`` state and ``conv`` inputs, or an xLSTM
        ``state`` tuple."""
        cfg = self.cfg
        if kind == "mamba":
            x, ssm, conv = L.mamba_block(blk.mamba, cfg, x)
            return x, {"ssm": ssm, "conv": conv}
        if kind in ("mlstm", "slstm"):
            block = L.mlstm_block if kind == "mlstm" else L.slstm_block
            x, state = block(getattr(blk, kind), cfg, x)
            return x, {"state": state}
        if kind == "shared_attn":
            h = x @ blk.in_proj
            attn = self.shared.attn
            q, k, v = L._qkv(attn, cfg, L.rms_norm(h, attn["ln"], cfg.norm_eps), positions)
            # implicit positions and a window: the fused attention kernel on the card
            o = L.mha(q, k, v, causal=True, window=cfg.attn_window,
                      q_chunk=cfg.attn_q_chunk)
            o = L.shard(L._proj_out(o, attn["wo"]), "batch", "seq", "embed")
            h = L.ffn_block(self.shared.ffn, cfg, h + o)
            return x + h, {"k": k, "v": v}
        h = L.rms_norm(x, blk.attn["ln"], cfg.norm_eps)
        q, k, v = L._qkv(blk.attn, cfg, h, positions)
        # implicit positions: the fused attention kernel on the card
        o = L.mha(q, k, v, causal=cfg.causal, q_chunk=cfg.attn_q_chunk)
        x = x + L.shard(L._proj_out(o, blk.attn["wo"]), "batch", "seq", "embed")
        if hasattr(blk, "cross"):
            x = L.cross_attn_block(blk.cross, cfg, x, memory)
        return self._ffn(blk, cfg, x), {"k": k, "v": v}

    def _ring(self, t: torch.Tensor) -> torch.Tensor:
        """A shared attention's prefill k or v (B,S,KV,hd) in the reference's
        ring-buffer layout of W = ``attn_window`` slots: the last W tokens, or
        zero-padded to W.  Token ``p`` sits at slot ``p % W`` only when S <= W
        or S % W == 0, where ``attn_decode`` expects it; the reference's
        ``forward`` gives this layout all the same, and so does the port."""
        S = t.shape[1]
        W = self.cfg.attn_window or S
        if S >= W:
            return t[:, -W:]
        return torch.cat([t, t.new_zeros((t.shape[0], W - S, *t.shape[2:]))], dim=1)

    def forward(self, tokens: torch.Tensor, *,
                audio_embed: torch.Tensor | None = None,
                vision_embed: torch.Tensor | None = None,
                remat: str = "none", return_cache: bool = False):
        """Full-sequence forward.  Returns the final hidden (B,S,d), and the
        decode cache when ``return_cache`` (prefill path): a tuple over pattern
        positions of each layer's entry (:meth:`_block`; a shared attention's k
        and v in the ring layout, :meth:`_ring`), every tensor stacked over
        cycles, e.g. k as ``(n_cycles, B, S, KV, hd)``.

        ``audio_embed`` (B, F, d) feeds whisper's encoder and ``vision_embed``
        (B, M, d) llama-vision's cross-attention, in the model's dtype and on its
        device; a model without cross-attention ignores them.

        ``remat`` (with gradients only): ``"none"`` keeps every activation for
        the backward; ``"full"`` keeps each block's input and recomputes the
        block; ``"selective"`` also keeps the outputs of its matrix products.
        The encoder is not recomputed, as in the reference."""
        if remat not in REMAT:
            raise ValueError(f"remat must be one of {REMAT}, got {remat!r}")
        cfg = self.cfg
        B, S = tokens.shape
        x = L.embed(self.embed, cfg, tokens)
        positions = torch.arange(S, device=tokens.device)[None].expand(B, S)
        memory = self._memory(audio_embed, vision_embed)
        per_pos: list[list[dict]] = [[] for _ in cfg.pattern]
        recompute = remat != "none" and torch.is_grad_enabled()
        kw = {"use_reentrant": False}
        if remat == "selective":
            kw["context_fn"] = functools.partial(create_selective_checkpoint_contexts,
                                                 _save_products)
        for i, blk in enumerate(self.blocks):
            kind = cfg.block_kind(i)
            args = (kind, blk, x, positions, memory)
            x, entry = checkpoint(self._block, *args, **kw) if recompute \
                else self._block(*args)
            if return_cache:
                if kind == "shared_attn":
                    entry = {name: self._ring(t) for name, t in entry.items()}
                per_pos[i % cfg.cycle_len].append(entry)
        x = L.rms_norm(x, self.final_norm, cfg.norm_eps)
        if return_cache:
            caches = tuple(_tree_map(lambda *ts: torch.stack(ts), *entries)
                           for entries in per_pos)
            return x, caches
        return x

    # ------------------------------------------------------------------
    # Training / serving entry points
    # ------------------------------------------------------------------

    def loss(self, tokens: torch.Tensor, labels: torch.Tensor, *,
             remat: str = "none", **mods) -> torch.Tensor:
        """Mean next-token cross-entropy (fp32) over the labels that are not
        -100, with the tied unembedding; ``mods``: ``audio_embed`` /
        ``vision_embed`` as :meth:`forward` takes them."""
        x = self.forward(tokens, remat=remat, **mods)
        return L.xent_loss(x, self.embed["tok"], labels, self.cfg)

    @torch.no_grad()
    def prefill(self, tokens: torch.Tensor, **mods):
        """Serving prefill: returns (last-token logits, stacked cache)."""
        x, cache = self.forward(tokens, return_cache=True, **mods)
        logits = L.logits_chunked(x[:, -1:], self.embed["tok"], self.cfg)
        return logits[:, 0], cache

    def _cache_entry(self, kind: str, batch: int, max_len: int, device):
        cfg = self.cfg

        def zeros(shape, dtype=cfg.torch_dtype, fill=0.0):
            return torch.full(shape, fill, dtype=dtype, device=device)

        f32, H = torch.float32, cfg.n_heads
        if kind in ("attn", "cross_attn", "shared_attn"):
            S = min(cfg.attn_window or max_len, max_len) if kind == "shared_attn" \
                else max_len
            kvs = (batch, S, cfg.n_kv_heads, cfg.hd)
            return {"k": zeros(kvs), "v": zeros(kvs)}
        if kind == "mamba":
            e = cfg.ssm_expand * cfg.d_model
            return {"ssm": zeros((batch, e // cfg.ssm_head_dim, cfg.ssm_head_dim,
                                  cfg.ssm_state), f32),
                    "conv": zeros((batch, cfg.ssm_conv_width - 1, e))}
        if kind == "mlstm":
            hd = 2 * cfg.d_model // H
            return {"state": (zeros((batch, H, hd, hd), f32), zeros((batch, H, hd), f32),
                              zeros((batch, H), f32, L.NEG_INF))}
        if kind == "slstm":
            hd = cfg.d_model // H
            return {"state": (zeros((batch, H, hd), f32), zeros((batch, H, hd), f32),
                              zeros((batch, H, hd)), zeros((batch, H), f32, L.NEG_INF))}
        raise ValueError(f"unknown block kind {kind!r}")

    def init_cache(self, batch: int, max_len: int, *, device="cuda"):
        """Zeroed flat per-layer decode cache, one entry a layer: ``{"k","v"}`` of
        ``(batch, max_len, KV, hd)`` for self-attention (a ring of
        ``min(attn_window, max_len)`` slots for ``"shared_attn"``); ``{"ssm"
        (batch, nh, hd, N) fp32, "conv" (batch, W-1, e)}`` for Mamba2;
        ``{"state": (C, n, m)}`` for mLSTM and ``{"state": (c, n, h, m)}`` for
        sLSTM, fp32 but h, with the stabilisers m at -1e30."""
        return tuple(self._cache_entry(self.cfg.block_kind(i), batch,
                                       max_len, device)
                     for i in range(self.cfg.n_layers))

    def cache_axes(self) -> tuple:
        """Logical-axis tree matching :meth:`init_cache` (for sharding)."""
        cfg = self.cfg
        kv = ("batch", "kv_seq", "kv_heads", "head_dim")

        def entry(kind):
            if kind in ("attn", "cross_attn", "shared_attn"):
                return {"k": kv, "v": kv}
            if kind == "mamba":
                return {"ssm": ("batch", "heads", "head_dim", "state"),
                        "conv": ("batch", "conv", "mlp")}
            if kind == "mlstm":
                return {"state": (("batch", "heads", "head_dim", "head_dim"),
                                  ("batch", "heads", "head_dim"),
                                  ("batch", "heads"))}
            if kind == "slstm":
                h3 = ("batch", "heads", "head_dim")
                return {"state": (h3, h3, h3, ("batch", "heads"))}
            raise ValueError(f"unknown block kind {kind!r}")

        return tuple(entry(cfg.block_kind(i)) for i in range(cfg.n_layers))

    def unstack_cache(self, stacked):
        """Convert a prefill cache (stacked per pattern position) into the
        flat per-layer decode layout (layer ``i = c * cycle_len + p``)."""
        cfg = self.cfg
        flat = []
        for i in range(cfg.n_layers):
            c, p = divmod(i, cfg.cycle_len)
            flat.append(_tree_map(lambda t: t[c], stacked[p]))
        return tuple(flat)

    def serving_cache(self, stacked, filled: int, max_len: int):
        """The flat decode cache of ``max_len`` positions that continues a
        prefill of ``filled`` tokens, by the reference's rule
        (``examples/serve.py``): a leaf of the prefill's shape (a recurrent
        state, the conv inputs, a ring the prompt filled) is taken whole; a
        sequence leaf takes the prefill's first ``filled`` positions, which
        must fit in both (raises otherwise)."""
        flat = self.unstack_cache(stacked)
        first = flat[0]
        while not isinstance(first, torch.Tensor):
            first = next(iter(first.values())) if isinstance(first, dict) else first[0]
        cache = self.init_cache(first.shape[0], max_len, device=first.device)

        def put(dst, src):
            if dst.shape == src.shape:
                dst.copy_(src)
            elif filled <= min(dst.shape[1], src.shape[1]):
                dst[:, :filled] = src[:, :filled]
            else:
                raise ValueError(f"serving_cache: {filled} prefill positions do not "
                                 f"fit a cache leaf of {tuple(dst.shape)} from "
                                 f"{tuple(src.shape)}")
            return dst

        return tuple(_tree_map(put, dst, src) for dst, src in zip(cache, flat))

    @torch.no_grad()
    def decode_step(self, cache, tokens: torch.Tensor, pos: torch.Tensor, *,
                    audio_embed: torch.Tensor | None = None,
                    vision_embed: torch.Tensor | None = None):
        """One decode step: tokens (B,1), pos (B,).  Returns (logits, cache).

        ``cache`` is the flat per-layer tuple and is written IN PLACE (k and v
        at ``pos``, or at ``pos % slots`` in a shared attention's ring; the
        recurrent states and conv inputs whole), which takes the place of
        donating the cache to a jitted step; the returned cache is the same
        object.  ``pos < max_len`` is the caller's contract.  The memory is
        recomputed every step, as the reference does: whisper runs its encoder
        again each step.
        """
        cfg = self.cfg
        x = L.embed(self.embed, cfg, tokens)
        memory = self._memory(audio_embed, vision_embed)
        for i, (blk, cc) in enumerate(zip(self.blocks, cache)):
            kind = cfg.block_kind(i)
            if kind == "mamba":
                x, ssm, conv = L.mamba_block(blk.mamba, cfg, x, state=cc["ssm"],
                                             conv_state=cc["conv"])
                cc["ssm"].copy_(ssm)
                cc["conv"].copy_(conv)
            elif kind in ("mlstm", "slstm"):
                block = L.mlstm_block if kind == "mlstm" else L.slstm_block
                x, state = block(getattr(blk, kind), cfg, x, state=cc["state"])
                for dst, src in zip(cc["state"], state):
                    dst.copy_(src)
            elif kind == "shared_attn":
                h, _, _ = L.attn_decode(self.shared.attn, cfg, x @ blk.in_proj,
                                        cc["k"], cc["v"], pos, window=cfg.attn_window)
                x = x + L.ffn_block(self.shared.ffn, cfg, h)
            else:
                x, _, _ = L.attn_decode(blk.attn, cfg, x, cc["k"], cc["v"], pos)
                if hasattr(blk, "cross"):
                    x = L.cross_attn_block(blk.cross, cfg, x, memory)
                x = self._ffn(blk, cfg, x)
        x = L.rms_norm(x, self.final_norm, cfg.norm_eps)
        logits = L.logits_chunked(x, self.embed["tok"], cfg)
        return logits[:, 0], cache
