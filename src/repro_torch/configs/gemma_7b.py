"""gemma-7b [dense]: 28L d_model=3072 16H (kv=16) d_ff=24576 vocab=256000.

GeGLU MLP, head_dim=256 (q_dim 4096 > d_model), sqrt(d) embedding scale,
final-logit softcap.  [arXiv:2403.08295; hf]
"""
from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="gemma-7b",
    n_layers=28, d_model=3072, n_heads=16, n_kv_heads=16,
    d_ff=24576, vocab=256000, head_dim=256,
    ffn_kind="geglu", scale_embed=True, logit_softcap=30.0,
    rope_theta=10000.0,
)
