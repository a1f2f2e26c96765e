"""qwen2-moe-a2.7b [moe] — 60 routed experts top-4 + shared expert
[hf:Qwen/Qwen1.5-MoE-A2.7B; hf].

24L, d_model=2048, 16H (kv=16), vocab=151936, moe_intermediate=1408,
shared_expert_intermediate=5632 (the "4 shared"), norm_topk_prob=False.
"""
from .base import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="qwen2_moe_a2_7b",
    family="decoder",
    n_layers=24,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    d_ff=1408,
    vocab_size=151936,
    moe=MoEConfig(
        n_experts=60,
        top_k=4,
        d_ff_expert=1408,
        n_shared_experts=4,
        d_ff_shared=5632,
        renormalize=False,
    ),
    mlp_type="swiglu",
    tie_embeddings=True,
)
