"""qwen3-moe-30b-a3b [moe]: 48L d_model=2048 32H (kv=4) expert d_ff=768
vocab=151936, 128 experts top-8.  [hf:Qwen/Qwen3-30B-A3B; hf]
"""
from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="qwen3-moe-30b-a3b",
    n_layers=48, d_model=2048, n_heads=32, n_kv_heads=4,
    d_ff=768, vocab=151936, head_dim=128,
    n_experts=128, top_k=8, qk_norm=True,
    ffn_kind="swiglu", rope_theta=1e6,
)
