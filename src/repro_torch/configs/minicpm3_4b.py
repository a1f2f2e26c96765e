"""minicpm3-4b [dense] — MLA attention [hf:openbmb/MiniCPM3-4B; hf].

62L, d_model=2560, 40H (kv=40), d_ff=6400, vocab=73448.  Multi-head Latent
Attention: q_lora=768, kv_lora=256, qk_nope=64, qk_rope=32, v_head=64 — the
compressed latent is the KV cache (int8-quantizable via the paper's scheme).
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="minicpm3_4b",
    family="decoder",
    n_layers=62,
    d_model=2560,
    n_heads=40,
    n_kv_heads=40,
    d_ff=6400,
    vocab_size=73448,
    attn_type="mla",
    q_lora_rank=768,
    kv_lora_rank=256,
    qk_nope_head_dim=64,
    qk_rope_head_dim=32,
    v_head_dim=64,
    mlp_type="swiglu",
    tie_embeddings=True,
)
