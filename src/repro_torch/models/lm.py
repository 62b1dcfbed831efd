"""Composable LM, serving part: dense decoder blocks (``"attn"`` + FFN).

One :class:`LM` consumes an :class:`repro_torch.models.config.ArchConfig` and
provides ``init / forward / prefill / init_cache / unstack_cache /
decode_step``.  It is an ``nn.Module`` holding an ``nn.ModuleList`` of blocks;
block ``i`` is cycle ``c`` and pattern position ``p`` of the reference's stacked
layout, ``i = c * cycle_len + p``.  The layer functions live in
:mod:`repro_torch.models.layers`.

Still to be ported, and refused with ``NotImplementedError`` until then: the
training entry points (``loss``), mixture-of-experts FFNs, the other block
kinds (cross_attn, mamba, mlstm, slstm, shared_attn) and the encoder.
"""

from __future__ import annotations

import math

import torch
from torch import nn

from repro_torch.models import layers as L
from repro_torch.models.config import ArchConfig


class Block(nn.Module):
    """Parameters of one ``"attn"`` layer: ``attn`` and ``ffn`` groups."""

    def __init__(self, cfg: ArchConfig, dtype: torch.dtype, device):
        super().__init__()
        self.attn = L.materialize(L.attn_defs(cfg), dtype, device)
        self.ffn = L.materialize(L.ffn_defs(cfg), dtype, device)


def _refuse_unported(cfg: ArchConfig) -> None:
    other = sorted({k for k in cfg.pattern if k != "attn"})
    if other:
        raise NotImplementedError(
            f"{cfg.name}: block kinds {other} are not ported yet (the slice "
            "after training ports MoE, Mamba2, mLSTM/sLSTM, cross and shared "
            "attention)")
    if cfg.n_experts > 0:
        raise NotImplementedError(
            f"{cfg.name}: mixture-of-experts FFNs are not ported yet (the "
            "slice that ports the remaining block kinds)")
    if cfg.encoder_layers > 0 or cfg.cross_attn_every > 0:
        raise NotImplementedError(
            f"{cfg.name}: encoder and cross-attention are not ported yet "
            "(the slice that ports the remaining block kinds)")


class LM(nn.Module):
    """Dense decoder LM.  ``LM(cfg, device=...)`` allocates the parameters
    (uninitialized) in ``cfg.torch_dtype`` on ``device``; :meth:`init` fills
    them from a ``torch.Generator``, ``convert.load_jax_params`` from the
    reference's parameter tree."""

    def __init__(self, cfg: ArchConfig, *, device="cuda",
                 dtype: torch.dtype | None = None):
        super().__init__()
        _refuse_unported(cfg)
        self.cfg = cfg
        dtype = dtype or cfg.torch_dtype
        self.embed = L.materialize(L.embed_defs(cfg), dtype, device)
        self.final_norm = L.materialize(
            L.ParamDef((cfg.d_model,), init="ones"), dtype, device)
        self.blocks = nn.ModuleList(Block(cfg, dtype, device)
                                    for _ in range(cfg.n_layers))

    # ------------------------------------------------------------------
    # Parameters
    # ------------------------------------------------------------------

    def block_defs(self, kind: str = "attn") -> dict:
        if kind != "attn":
            raise NotImplementedError(f"block kind {kind!r} is not ported yet")
        return {"attn": L.attn_defs(self.cfg), "ffn": L.ffn_defs(self.cfg)}

    def param_defs(self) -> dict:
        """The reference's parameter tree: ``pos{p}`` stacked over cycles."""
        cfg = self.cfg
        defs: dict = {
            "embed": L.embed_defs(cfg),
            "final_norm": L.ParamDef((cfg.d_model,), init="ones"),
        }
        for p, kind in enumerate(cfg.pattern):
            defs[f"pos{p}"] = L.stack_defs(self.block_defs(kind),
                                           cfg.n_cycles)
        return defs

    def init(self, generator: torch.Generator) -> "LM":
        """Random init by the reference's rule (normal / sqrt(fan_in), embed
        0.02, norms ones, biases zeros), parameter by parameter on the
        generator's device."""
        L.init_params(self.embed, L.embed_defs(self.cfg), generator)
        with torch.no_grad():
            self.final_norm.fill_(1.0)
        for blk in self.blocks:
            L.init_params(blk.attn, L.attn_defs(self.cfg), generator)
            L.init_params(blk.ffn, L.ffn_defs(self.cfg), generator)
        return self

    def n_params(self) -> int:
        return sum(math.prod(d.shape)
                   for _, d in L.flatten_defs(self.param_defs()))

    # ------------------------------------------------------------------
    # Forward (prefill)
    # ------------------------------------------------------------------

    def forward(self, tokens: torch.Tensor, *, return_cache: bool = False):
        """Full-sequence forward.  Returns the final hidden (B,S,d), and the
        decode cache when ``return_cache`` (prefill path): a tuple over
        pattern positions of ``{"k","v"}``, each stacked over cycles as
        ``(n_cycles, B, S, KV, hd)``."""
        cfg = self.cfg
        B, S = tokens.shape
        x = L.embed(self.embed, cfg, tokens)
        positions = torch.arange(S, device=tokens.device)[None].expand(B, S)
        per_pos: list[list[dict]] = [[] for _ in cfg.pattern]
        for i, blk in enumerate(self.blocks):
            h = L.rms_norm(x, blk.attn["ln"], cfg.norm_eps)
            q, k, v = L._qkv(blk.attn, cfg, h, positions)
            # implicit positions: the fused attention kernel on the card
            o = L.mha(q, k, v, causal=cfg.causal, q_chunk=cfg.attn_q_chunk)
            x = x + L._proj_out(o, blk.attn["wo"])
            if return_cache:
                per_pos[i % cfg.cycle_len].append({"k": k, "v": v})
            x = L.ffn_block(blk.ffn, cfg, x)
        x = L.rms_norm(x, self.final_norm, cfg.norm_eps)
        if return_cache:
            caches = tuple(
                {name: torch.stack([e[name] for e in entries])
                 for name in ("k", "v")} for entries in per_pos)
            return x, caches
        return x

    # ------------------------------------------------------------------
    # Serving entry points
    # ------------------------------------------------------------------

    @torch.no_grad()
    def prefill(self, tokens: torch.Tensor):
        """Serving prefill: returns (last-token logits, stacked cache)."""
        x, cache = self.forward(tokens, return_cache=True)
        logits = L.logits_chunked(x[:, -1:], self.embed["tok"], self.cfg)
        return logits[:, 0], cache

    def _cache_entry(self, kind: str, batch: int, max_len: int, device):
        cfg = self.cfg
        if kind != "attn":
            raise NotImplementedError(f"cache of block kind {kind!r} is not "
                                      "ported yet")
        kvs = (batch, max_len, cfg.n_kv_heads, cfg.hd)
        return {"k": torch.zeros(kvs, dtype=cfg.torch_dtype, device=device),
                "v": torch.zeros(kvs, dtype=cfg.torch_dtype, device=device)}

    def init_cache(self, batch: int, max_len: int, *, device="cuda"):
        """Zeroed flat per-layer decode cache: a tuple of ``{"k","v"}`` of
        ``(batch, max_len, KV, hd)``."""
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
    def decode_step(self, cache, tokens: torch.Tensor, pos: torch.Tensor):
        """One decode step: tokens (B,1), pos (B,).  Returns (logits, cache).

        ``cache`` is the flat per-layer tuple and is written IN PLACE at
        ``pos`` (this takes the place of donating the cache to a jitted step);
        the returned cache is the same object.  ``pos < max_len`` is the
        caller's contract.
        """
        cfg = self.cfg
        x = L.embed(self.embed, cfg, tokens)
        for blk, cc in zip(self.blocks, cache):
            x, _, _ = L.attn_decode(blk.attn, cfg, x, cc["k"], cc["v"], pos)
            x = L.ffn_block(blk.ffn, cfg, x)
        x = L.rms_norm(x, self.final_norm, cfg.norm_eps)
        logits = L.logits_chunked(x, self.embed["tok"], cfg)
        return logits[:, 0], cache
