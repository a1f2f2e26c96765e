"""gemma2-2b [dense] — local+global alternating attention, logit softcap
[arXiv:2408.00118; hf].

26L, d_model=2304, 8H (kv=4), head_dim=256, d_ff=9216, vocab=256000.
GeGLU MLP, RMSNorm(1+w) with post-block norms, attn softcap 50, logit
softcap 30, sliding window 4096 on even (local) layers.
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="gemma2_2b",
    family="decoder",
    n_layers=26,
    d_model=2304,
    n_heads=8,
    n_kv_heads=4,
    head_dim=256,
    d_ff=9216,
    vocab_size=256000,
    attn_type="local_global",
    window=4096,
    attn_softcap=50.0,
    logit_softcap=30.0,
    mlp_type="geglu",
    norm_plus_one=True,
    post_block_norm=True,
    embed_scale_sqrt_dim=True,
    tie_embeddings=True,
)
