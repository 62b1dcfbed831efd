"""Architecture configs and input-shape specs for the assigned model pool.

:class:`ArchConfig` is the single config type all 10 assigned architectures
instantiate (repro_torch/configs/<id>.py).  It drives

  * the PyTorch model definition (repro_torch.models.lm),
  * the input specs of one cell (:meth:`input_specs`).

The planner bridge ``to_model_desc`` of the reference is left out until the
planner itself is ported.
"""

from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Literal

import torch

BlockKind = Literal["attn", "mamba", "mlstm", "slstm", "shared_attn"]

_TORCH_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
                 "float16": torch.float16, "float64": torch.float64}


@dataclass(frozen=True)
class ShapeSpec:
    """One assigned input shape (arch x shape = one dry-run cell)."""

    name: str
    seq_len: int
    global_batch: int
    kind: Literal["train", "prefill", "decode"]


# The four LM shapes from the assignment.
TRAIN_4K = ShapeSpec("train_4k", 4096, 256, "train")
PREFILL_32K = ShapeSpec("prefill_32k", 32768, 32, "prefill")
DECODE_32K = ShapeSpec("decode_32k", 32768, 128, "decode")
LONG_500K = ShapeSpec("long_500k", 524288, 1, "decode")
ALL_SHAPES: tuple[ShapeSpec, ...] = (TRAIN_4K, PREFILL_32K, DECODE_32K,
                                     LONG_500K)
SHAPES_BY_NAME = {s.name: s for s in ALL_SHAPES}


@dataclass(frozen=True)
class ArchConfig:
    name: str
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int | None = None

    # attention details
    qkv_bias: bool = False            # qwen2
    qk_norm: bool = False             # qwen3
    rope_theta: float = 10000.0
    causal: bool = True

    # ffn details
    ffn_kind: Literal["swiglu", "geglu", "gelu"] = "swiglu"

    # MoE
    n_experts: int = 0
    top_k: int = 0
    moe_capacity_factor: float = 1.25
    # group-local dispatch: token groups aligned to the data shards (the
    # launcher sets this to the mesh's dp extent; 1 = single-group/CPU)
    moe_groups: int = 1

    # hybrid / recurrent
    block_pattern: tuple[BlockKind, ...] = ()   # cycle; empty => all "attn"
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_head_dim: int = 64
    ssm_conv_width: int = 4

    # enc-dec (whisper): encoder depth; frontend is a stub — inputs are
    # precomputed frame embeddings of length ``audio_seq``.
    encoder_layers: int = 0
    audio_seq: int = 1500

    # VLM: cross-attention to precomputed image patch embeddings every
    # ``cross_attn_every`` layers; ``vision_seq`` patch tokens at d_model.
    cross_attn_every: int = 0
    vision_seq: int = 1601

    # misc
    tie_embeddings: bool = True
    norm_eps: float = 1e-6
    logit_softcap: float = 0.0        # gemma-style final-logit softcap
    scale_embed: bool = False         # gemma multiplies embed by sqrt(d)
    attn_q_chunk: int = 2048          # flash-style query chunk (memory bound)
    dtype: str = "bfloat16"
    # which archs can run long_500k (sub-quadratic path)
    subquadratic: bool = False
    # attention window for hybrid long-context shared attention (0 = full)
    attn_window: int = 0

    # ------------------------------------------------------------------

    @property
    def hd(self) -> int:
        return self.head_dim or (self.d_model // self.n_heads)

    @property
    def pattern(self) -> tuple[BlockKind, ...]:
        return self.block_pattern or ("attn",)

    @property
    def cycle_len(self) -> int:
        return len(self.pattern)

    @property
    def n_cycles(self) -> int:
        assert self.n_layers % self.cycle_len == 0, \
            f"{self.name}: n_layers {self.n_layers} % cycle {self.cycle_len}"
        return self.n_layers // self.cycle_len

    def block_kind(self, i: int) -> BlockKind:
        return self.pattern[i % self.cycle_len]

    @property
    def torch_dtype(self) -> torch.dtype:
        return _TORCH_DTYPES[self.dtype]

    # -- reduced config for CPU tests ------------------------------------

    def reduced(self, **overrides) -> "ArchConfig":
        """Small same-family config: few layers, narrow width, tiny vocab."""
        cyc = self.cycle_len
        base = dict(
            n_layers=max(cyc, 2 * cyc if self.n_layers >= 2 * cyc else cyc),
            d_model=128,
            n_heads=max(2, min(4, self.n_heads)),
            n_kv_heads=1 if self.n_kv_heads == 1 else 2,
            head_dim=32 if self.head_dim else None,
            d_ff=256 if self.d_ff else 0,
            vocab=512,
            n_experts=8 if self.n_experts else 0,
            top_k=min(2, self.top_k) if self.n_experts else 0,
            encoder_layers=2 if self.encoder_layers else 0,
            audio_seq=24,
            cross_attn_every=2 if self.cross_attn_every else 0,
            vision_seq=16,
            ssm_state=16 if self.ssm_state else 0,
            ssm_head_dim=32 if self.ssm_state else 64,
            attn_q_chunk=64,
            attn_window=16 if self.attn_window else 0,
            dtype="float32",
        )
        base.update(overrides)
        # keep heads consistent with d_model when head_dim not pinned
        if base.get("head_dim") is None and not self.head_dim:
            base["head_dim"] = None
            base["n_heads"] = max(2, base["d_model"] // 32)
            base["n_kv_heads"] = 1 if self.n_kv_heads == 1 else 2
            # d_model/n_heads must be integral
            while base["d_model"] % base["n_heads"]:
                base["n_heads"] -= 1
        return replace(self, name=self.name + "-smoke", **base)

    # -- shapes ----------------------------------------------------------------

    def shapes(self) -> list[ShapeSpec]:
        """The assigned shapes this arch runs (skips documented in DESIGN.md)."""
        out = [TRAIN_4K, PREFILL_32K, DECODE_32K]
        if self.subquadratic:
            out.append(LONG_500K)
        return out

    def skipped_shapes(self) -> list[tuple[ShapeSpec, str]]:
        if self.subquadratic:
            return []
        return [(LONG_500K, "pure full-attention arch: 500k needs "
                            "sub-quadratic attention (DESIGN.md §5)")]

    # -- input specs (shapes and dtypes, no allocation) ----------------------

    def input_specs(self, shape: ShapeSpec
                    ) -> dict[str, tuple[tuple[int, ...], torch.dtype]]:
        """Abstract model inputs for one cell as ``(shape, dtype)`` pairs.
        Modality frontends are stubs: audio/vision entries are precomputed
        embeddings."""
        B, S = shape.global_batch, shape.seq_len
        i32 = torch.int32
        dt = self.torch_dtype
        if shape.kind == "train":
            specs = {"tokens": ((B, S), i32), "labels": ((B, S), i32)}
        elif shape.kind == "prefill":
            specs = {"tokens": ((B, S), i32)}
        else:  # decode: one new token against a cache of length S
            specs = {"tokens": ((B, 1), i32), "pos": ((B,), i32)}
        if self.encoder_layers:
            specs["audio_embed"] = ((B, self.audio_seq, self.d_model), dt)
        if self.cross_attn_every:
            specs["vision_embed"] = ((B, self.vision_seq, self.d_model), dt)
        return specs
