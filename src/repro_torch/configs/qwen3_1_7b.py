"""qwen3-1.7b [dense] — qk_norm + GQA [hf:Qwen/Qwen3-1.7B (family per
Qwen/Qwen3-8B card); hf].

28L, d_model=2048, 16H (kv=8), head_dim=128, d_ff=6144, vocab=151936.
Per-head RMSNorm on q and k before RoPE (qk_norm), rope_theta=1e6.
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="qwen3_1_7b",
    family="decoder",
    n_layers=28,
    d_model=2048,
    n_heads=16,
    n_kv_heads=8,
    head_dim=128,
    d_ff=6144,
    vocab_size=151936,
    qk_norm=True,
    rope_theta=1e6,
    mlp_type="swiglu",
    tie_embeddings=True,
)
