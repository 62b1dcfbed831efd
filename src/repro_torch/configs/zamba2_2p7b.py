"""zamba2-2.7b [hybrid]: 54L d_model=2560 32H (kv=32) d_ff=10240 ssm_state=64.

Mamba2 backbone with a SHARED attention+MLP block every third layer
(one weight set reused at each occurrence, per-occurrence input adapter).
Runs long_500k: SSM state is O(1) and the shared attention uses a 4096-token
sliding window (ring-buffer cache).  [arXiv:2411.15242; hf]
"""
from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="zamba2-2.7b",
    n_layers=54, d_model=2560, n_heads=32, n_kv_heads=32,
    d_ff=10240, vocab=32000,
    block_pattern=("mamba", "mamba", "shared_attn"),
    ssm_state=64, ssm_expand=2, ssm_head_dim=64, ssm_conv_width=4,
    attn_window=4096, subquadratic=True,
    ffn_kind="swiglu", rope_theta=10000.0,
)
