"""rwkv6-3b [ssm] — "Finch", attention-free with data-dependent decay
[arXiv:2404.05892; hf].

32L, d_model=2560, d_ff=8960, vocab=65536, head_dim=64 (40 wkv heads).
State is O(1) in sequence length => runs the long_500k cell.
"""
from .base import ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="rwkv6_3b",
    family="rwkv6",
    n_layers=32,
    d_model=2560,
    n_heads=40,
    n_kv_heads=40,
    d_ff=8960,
    vocab_size=65536,
    ssm=SSMConfig(kind="rwkv6", head_dim=64, lora_rank=64),
    tie_embeddings=False,
)
