"""llama-3.2-vision-11b [vlm]: 40L d_model=4096 32H (GQA kv=8) d_ff=14336
vocab=128256; gated cross-attention image layers every 5th layer.

The vision tower is a STUB — input_specs supplies precomputed patch
embeddings (B, 1601, d).  [hf:meta-llama/Llama-3.2-11B-Vision; unverified]
"""
from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="llama-3.2-vision-11b",
    n_layers=40, d_model=4096, n_heads=32, n_kv_heads=8,
    d_ff=14336, vocab=128256,
    block_pattern=("attn", "attn", "attn", "attn", "cross_attn"),
    cross_attn_every=5, vision_seq=1601,
    ffn_kind="swiglu", rope_theta=5e5,
)
