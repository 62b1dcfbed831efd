"""qwen2-7b [dense]: 28L d_model=3584 28H (GQA kv=4) d_ff=18944 vocab=152064.

GQA with QKV bias.  28 heads are not divisible by the 16-way model axis:
the sharding layer falls back to sequence sharding for attention (see
the reference's parallel.axes divisibility fallback).  [arXiv:2407.10671; hf]
"""
from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="qwen2-7b",
    n_layers=28, d_model=3584, n_heads=28, n_kv_heads=4,
    d_ff=18944, vocab=152064,
    qkv_bias=True, ffn_kind="swiglu", rope_theta=1e6,
)
