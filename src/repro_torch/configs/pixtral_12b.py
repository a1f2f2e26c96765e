"""pixtral-12b [vlm] — pixtral-ViT frontend + mistral-nemo-like decoder
[hf:mistralai/Pixtral-12B-2409; unverified].

Decoder backbone: 40L, d_model=5120, 32H (kv=8), head_dim=128, d_ff=14336,
vocab=131072, rope_theta=1e9 (nemo long-rope convention).  The ViT frontend
is a STUB per the assignment: ``input_specs()`` supplies precomputed patch
embeddings prepended to the text sequence.
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="pixtral_12b",
    family="decoder",
    n_layers=40,
    d_model=5120,
    n_heads=32,
    n_kv_heads=8,
    head_dim=128,
    d_ff=14336,
    vocab_size=131072,
    rope_theta=1e9,
    mlp_type="swiglu",
    tie_embeddings=False,
    frontend="vision",
    frontend_tokens=1024,
)
