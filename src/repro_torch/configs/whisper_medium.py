"""whisper-medium [audio]: 24+24L d_model=1024 16H d_ff=4096 vocab=51865.

Encoder-decoder; the conv frontend is a STUB — input_specs supplies
precomputed 1500-frame embeddings (B, 1500, d).  Decoder layers carry
cross-attention to the encoder output; GELU MLPs.  Decode shapes run at the
assigned 32k cache length (backbone exercise; beyond the audio model's
native 448).  [arXiv:2212.04356; unverified]
"""
from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="whisper-medium",
    n_layers=24, d_model=1024, n_heads=16, n_kv_heads=16,
    d_ff=4096, vocab=51865,
    ffn_kind="gelu",
    encoder_layers=24, audio_seq=1500,
    block_pattern=("cross_attn",),
    rope_theta=10000.0,
)
