"""xlstm-125m [ssm]: 12L d_model=768 4H vocab=50304, alternating
mLSTM (matrix memory) / sLSTM (scalar memory, block-diagonal recurrence)
blocks; d_ff=0 — expansion lives inside the blocks.  Runs long_500k
(recurrent state, no KV growth).  [arXiv:2405.04517; unverified]
"""
from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="xlstm-125m",
    n_layers=12, d_model=768, n_heads=4, n_kv_heads=4,
    d_ff=0, vocab=50304,
    block_pattern=("mlstm", "slstm"),
    subquadratic=True,
)
