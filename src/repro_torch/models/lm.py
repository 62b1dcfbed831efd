"""Composable LM: the attention family of block kinds, training and serving.

One :class:`LM` consumes an :class:`repro_torch.models.config.ArchConfig` and
provides ``init / encode / forward / loss / prefill / init_cache /
unstack_cache / decode_step``.  It is an ``nn.Module`` holding an
``nn.ModuleList`` of blocks; block ``i`` is cycle ``c`` and pattern position
``p`` of the reference's stacked layout, ``i = c * cycle_len + p``.  The layer
functions live in :mod:`repro_torch.models.layers`.

Block kinds ported: ``"attn"`` (self-attention + FFN, or + MoE when
``cfg.n_experts``) and ``"cross_attn"`` (self-attention + cross-attention to a
memory + FFN: llama-3.2-vision's image layers, whisper's decoder), with
whisper's encoder.  The memory is the encoded ``audio_embed`` (whisper) or the
``vision_embed`` as given (llama-vision); a model without cross-attention
ignores both.

``forward`` and ``loss`` run with gradients: the RMSNorm and attention kernels
sit on the path through their ``autograd.Function``s (kernels/), and ``remat``
recomputes each block in the backward through ``torch.utils.checkpoint``.

Still to be ported, and refused with ``NotImplementedError`` until then: the
recurrent block kinds (mamba, mlstm, slstm) and zamba2's shared attention.
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
    ``"cross_attn"``)."""

    def __init__(self, defs: dict, dtype: torch.dtype, device):
        super().__init__()
        for group, group_defs in defs.items():
            setattr(self, group, L.materialize(group_defs, dtype, device))


UNPORTED_KINDS = ("mamba", "mlstm", "slstm", "shared_attn")


def _refuse_unported(cfg: ArchConfig) -> None:
    other = sorted({k for k in cfg.pattern if k in UNPORTED_KINDS})
    if other:
        raise NotImplementedError(
            f"{cfg.name}: block kinds {other} are not ported yet (the slice that "
            "ports the recurrent kinds and shared attention)")


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
        _refuse_unported(cfg)
        self.cfg = cfg
        dtype = dtype or cfg.torch_dtype
        self.embed = L.materialize(L.embed_defs(cfg), dtype, device)
        self.final_norm = L.materialize(
            L.ParamDef((cfg.d_model,), init="ones"), dtype, device)
        self.blocks = nn.ModuleList(
            Block(self.block_defs(cfg.block_kind(i)), dtype, device)
            for i in range(cfg.n_layers))
        if cfg.encoder_layers:
            self.encoder = nn.ModuleList(
                Block(self.encoder_defs(), dtype, device)
                for _ in range(cfg.encoder_layers))
            self.enc_norm = L.materialize(
                L.ParamDef((cfg.d_model,), init="ones"), dtype, device)

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
        raise NotImplementedError(f"block kind {kind!r} is not ported yet")

    def encoder_defs(self) -> dict:
        """One encoder layer (whisper): non-causal self-attention + FFN."""
        return {"attn": L.attn_defs(self.cfg), "ffn": L.ffn_defs(self.cfg)}

    def param_defs(self) -> dict:
        """The reference's parameter tree: ``pos{p}`` stacked over cycles, and
        ``encoder`` stacked over its layers."""
        cfg = self.cfg
        defs: dict = {
            "embed": L.embed_defs(cfg),
            "final_norm": L.ParamDef((cfg.d_model,), init="ones"),
        }
        for p, kind in enumerate(cfg.pattern):
            defs[f"pos{p}"] = L.stack_defs(self.block_defs(kind),
                                           cfg.n_cycles)
        if cfg.encoder_layers:
            defs["encoder"] = L.stack_defs(self.encoder_defs(),
                                           cfg.encoder_layers)
            defs["enc_norm"] = L.ParamDef((cfg.d_model,), init="ones")
        return defs

    def init(self, generator: torch.Generator) -> "LM":
        """Random init by the reference's rule (normal / sqrt(fan_in), embed
        0.02, norms ones, biases and gates zeros), parameter by parameter on the
        generator's device."""
        cfg = self.cfg
        L.init_params(self.embed, L.embed_defs(cfg), generator)
        layers = [(blk, self.block_defs(cfg.block_kind(i)))
                  for i, blk in enumerate(self.blocks)]
        if cfg.encoder_layers:
            layers += [(lyr, self.encoder_defs()) for lyr in self.encoder]
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

    def _block(self, blk: Block, x: torch.Tensor, positions: torch.Tensor,
               memory: torch.Tensor | None):
        """One ``"attn"`` or ``"cross_attn"`` layer: (new x, its k, its v)."""
        cfg = self.cfg
        h = L.rms_norm(x, blk.attn["ln"], cfg.norm_eps)
        q, k, v = L._qkv(blk.attn, cfg, h, positions)
        # implicit positions: the fused attention kernel on the card
        o = L.mha(q, k, v, causal=cfg.causal, q_chunk=cfg.attn_q_chunk)
        x = x + L._proj_out(o, blk.attn["wo"])
        if hasattr(blk, "cross"):
            x = L.cross_attn_block(blk.cross, cfg, x, memory)
        return self._ffn(blk, cfg, x), k, v

    def forward(self, tokens: torch.Tensor, *,
                audio_embed: torch.Tensor | None = None,
                vision_embed: torch.Tensor | None = None,
                remat: str = "none", return_cache: bool = False):
        """Full-sequence forward.  Returns the final hidden (B,S,d), and the
        decode cache when ``return_cache`` (prefill path): a tuple over
        pattern positions of ``{"k","v"}``, each stacked over cycles as
        ``(n_cycles, B, S, KV, hd)``.

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
            if recompute:
                x, k, v = checkpoint(self._block, blk, x, positions, memory, **kw)
            else:
                x, k, v = self._block(blk, x, positions, memory)
            if return_cache:
                per_pos[i % cfg.cycle_len].append({"k": k, "v": v})
        x = L.rms_norm(x, self.final_norm, cfg.norm_eps)
        if return_cache:
            caches = tuple(
                {name: torch.stack([e[name] for e in entries])
                 for name in ("k", "v")} for entries in per_pos)
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
        if kind not in ("attn", "cross_attn"):
            raise NotImplementedError(f"cache of block kind {kind!r} is not "
                                      "ported yet")
        kvs = (batch, max_len, cfg.n_kv_heads, cfg.hd)
        return {"k": torch.zeros(kvs, dtype=cfg.torch_dtype, device=device),
                "v": torch.zeros(kvs, dtype=cfg.torch_dtype, device=device)}

    def init_cache(self, batch: int, max_len: int, *, device="cuda"):
        """Zeroed flat per-layer decode cache: a tuple of ``{"k","v"}`` of
        ``(batch, max_len, KV, hd)`` (the self-attention's, for both kinds)."""
        return tuple(self._cache_entry(self.cfg.block_kind(i), batch,
                                       max_len, device)
                     for i in range(self.cfg.n_layers))

    def unstack_cache(self, stacked):
        """Convert a prefill cache (stacked per pattern position) into the
        flat per-layer decode layout (layer ``i = c * cycle_len + p``)."""
        cfg = self.cfg
        flat = []
        for i in range(cfg.n_layers):
            c, p = divmod(i, cfg.cycle_len)
            flat.append({name: t[c] for name, t in stacked[p].items()})
        return tuple(flat)

    @torch.no_grad()
    def decode_step(self, cache, tokens: torch.Tensor, pos: torch.Tensor, *,
                    audio_embed: torch.Tensor | None = None,
                    vision_embed: torch.Tensor | None = None):
        """One decode step: tokens (B,1), pos (B,).  Returns (logits, cache).

        ``cache`` is the flat per-layer tuple and is written IN PLACE at
        ``pos`` (this takes the place of donating the cache to a jitted step);
        the returned cache is the same object.  ``pos < max_len`` is the
        caller's contract.  The memory is recomputed every step, as the
        reference does: whisper runs its encoder again each step.
        """
        cfg = self.cfg
        x = L.embed(self.embed, cfg, tokens)
        memory = self._memory(audio_embed, vision_embed)
        for blk, cc in zip(self.blocks, cache):
            x, _, _ = L.attn_decode(blk.attn, cfg, x, cc["k"], cc["v"], pos)
            if hasattr(blk, "cross"):
                x = L.cross_attn_block(blk.cross, cfg, x, memory)
            x = self._ffn(blk, cfg, x)
        x = L.rms_norm(x, self.final_norm, cfg.norm_eps)
        logits = L.logits_chunked(x, self.embed["tok"], cfg)
        return logits[:, 0], cache
