"""minicpm-2b [dense] — llama-like, trained with WSD schedule
[arXiv:2404.06395; hf].

40L, d_model=2304, 36H (kv=36), d_ff=5760, vocab=122753.  The WSD
(warmup-stable-decay) schedule lives in repro.optim.schedule.
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="minicpm_2b",
    family="decoder",
    n_layers=40,
    d_model=2304,
    n_heads=36,
    n_kv_heads=36,
    d_ff=5760,
    vocab_size=122753,
    mlp_type="swiglu",
    tie_embeddings=True,
)
