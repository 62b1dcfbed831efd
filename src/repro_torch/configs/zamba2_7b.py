"""zamba2-7b [hybrid]: 81L d_model=3584, Mamba2 (112 heads of 64, 2 groups,
d_state 64) with two shared attention + MLP blocks, vocab 32000.

Zamba2-7B-Instruct as published: 81 Mamba2 layers (expand 2, a width-4
convolution with bias over x, B and C, a gated RMSNorm per group, no clamp on
dt); before the Mamba2 layer at each of the 13 ``hybrid_layer_ids`` one of two
shared blocks runs, in turn, on concat(h, embedding) (7168 wide): RMSNorm,
attention of 32 heads of head_dim 224 with rope and softmax scale (224/2)^-0.5,
causal; RMSNorm; a GeGLU MLP of 14336 with exact GELU and the use's rank-128
adapter on its gate/up product; then the use's d x d linear, added to that Mamba2
layer's input only.  No residual inside the block, no linear biases.
[arXiv:2411.15242; hf Zyphra/Zamba2-7B-Instruct config.json]
"""
from repro_torch.models.config import PortArchConfig

#: ``hybrid_layer_ids`` of the published config
HYBRID_LAYER_IDS = (6, 11, 17, 23, 29, 35, 41, 47, 53, 59, 65, 71, 77)

CONFIG = PortArchConfig(
    name="zamba2-7b",
    n_layers=81, d_model=3584, n_heads=32, n_kv_heads=32, head_dim=224,
    d_ff=14336, vocab=32000,
    layer_kinds=tuple("hybrid" if i in HYBRID_LAYER_IDS else "mamba" for i in range(81)),
    n_shared_blocks=2, adapter_rank=128, attn_scale_div=2.0,
    ssm_state=64, ssm_expand=2, ssm_head_dim=64, ssm_conv_width=4,
    ssm_groups=2, ssm_conv_xbc=True, ssm_conv_bias=True,
    ffn_kind="geglu", gelu_approximate="none", rope_theta=10000.0, norm_eps=1e-5,
)
