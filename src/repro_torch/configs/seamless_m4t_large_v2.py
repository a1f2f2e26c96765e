"""seamless-m4t-large-v2 [audio] — enc-dec multimodal [arXiv:2308.11596; hf].

24L (24 enc + 24 dec), d_model=1024, 16H (kv=16), d_ff=8192, vocab=256206.
The speech frontend (w2v-BERT conformer) is a STUB per the assignment:
``input_specs()`` supplies precomputed frame embeddings (B, S_src, d_model).
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="seamless_m4t_large_v2",
    family="encdec",
    n_layers=24,
    n_encoder_layers=24,
    d_model=1024,
    n_heads=16,
    n_kv_heads=16,
    d_ff=8192,
    vocab_size=256206,
    mlp_type="gelu",
    attn_type="full",
    tie_embeddings=True,
    frontend="audio",
)
