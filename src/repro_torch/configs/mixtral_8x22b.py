"""mixtral-8x22b [moe] — 8 experts top-2, SWA [arXiv:2401.04088; hf].

56L, d_model=6144, 48H (kv=8), head_dim=128, d_ff=16384 per expert,
vocab=32768, sliding window 4096 (per assignment) => runs long_500k with a
windowed KV cache.
"""
from .base import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="mixtral_8x22b",
    family="decoder",
    n_layers=56,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    head_dim=128,
    d_ff=16384,
    vocab_size=32768,
    attn_type="swa",
    window=4096,
    moe=MoEConfig(n_experts=8, top_k=2, d_ff_expert=16384, renormalize=True),
    mlp_type="swiglu",
    tie_embeddings=False,
)
