"""zamba2-7b [hybrid] — Mamba2 backbone + shared attention blocks
[arXiv:2411.15242; unverified].

81 layer slots: 13 groups of (5 Mamba2 + 1 shared transformer block) + 3
tail Mamba2 layers = 68 Mamba2 + 13 invocations of ONE shared attn+MLP block
(weights shared, per-site KV cache).  d_model=3584, attn 32H (kv=32),
d_ff=14336, ssm_state=64, expand=2 (d_inner=7168, 112 ssm heads of dim 64).
"""
from .base import HybridConfig, ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="zamba2_7b",
    family="hybrid",
    n_layers=81,
    d_model=3584,
    n_heads=32,
    n_kv_heads=32,
    d_ff=14336,
    vocab_size=32000,
    ssm=SSMConfig(kind="mamba2", d_state=64, expand=2, head_dim=64, d_conv=4),
    hybrid=HybridConfig(n_groups=13, ssm_per_group=5, tail_ssm_layers=3),
    mlp_type="swiglu",
    tie_embeddings=False,
)
