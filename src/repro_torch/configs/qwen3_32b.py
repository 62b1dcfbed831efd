"""qwen3-32b [dense]: 64L d_model=5120 64H (GQA kv=8) d_ff=25600 vocab=151936.

qk-norm (per-head RMSNorm on q/k), head_dim=128.  [hf:Qwen/Qwen3-8B; hf]
"""
from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="qwen3-32b",
    n_layers=64, d_model=5120, n_heads=64, n_kv_heads=8,
    d_ff=25600, vocab=151936, head_dim=128,
    qk_norm=True, ffn_kind="swiglu", rope_theta=1e6,
)
