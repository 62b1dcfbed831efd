"""granite-34b [dense]: 88L d_model=6144 48H (MQA kv=1) d_ff=24576 vocab=49152.

llama-arch code model; deep-narrow with multi-query attention (kv=1 is
replicated across the model axis; the KV cache shards over batch/sequence
instead).  [arXiv:2405.04324; hf]
"""
from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="granite-34b",
    n_layers=88, d_model=6144, n_heads=48, n_kv_heads=1,
    d_ff=24576, vocab=49152,
    ffn_kind="swiglu", rope_theta=10000.0,
)
