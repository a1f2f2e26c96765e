"""Model/run configuration dataclasses.

One :class:`ModelConfig` describes any of the 10 assigned architectures
(dense / MoE / SSM / hybrid / enc-dec / VLM-audio-stub); family-specific
sections are optional sub-configs.  ``reduced()`` derives the CPU smoke-test
configs; full configs are exercised via the dry-run only.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    d_ff_expert: int
    n_shared_experts: int = 0
    d_ff_shared: int = 0
    capacity_factor: float = 1.25
    router_aux_loss: float = 0.001
    renormalize: bool = True  # mixtral renormalizes top-k probs; qwen2-moe not


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    kind: str  # "rwkv6" | "mamba2"
    d_state: int = 64
    expand: int = 2
    head_dim: int = 64
    d_conv: int = 4  # mamba2 conv width
    dt_rank: int = 0
    lora_rank: int = 64  # rwkv6 data-dependent-decay LoRA rank


@dataclasses.dataclass(frozen=True)
class HybridConfig:
    """Zamba2-style: groups of SSM layers with a shared transformer block
    interleaved (shared weights, per-site KV cache)."""

    n_groups: int
    ssm_per_group: int
    tail_ssm_layers: int = 0


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str  # "decoder" | "encdec" | "rwkv6" | "hybrid"
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: Optional[int] = None
    # attention flavor
    attn_type: str = "full"  # "full" | "swa" | "local_global" | "mla"
    window: Optional[int] = None
    attn_softcap: Optional[float] = None
    logit_softcap: Optional[float] = None
    qk_norm: bool = False
    rope_theta: float = 10000.0
    # MLA (minicpm3)
    q_lora_rank: int = 0
    kv_lora_rank: int = 0
    qk_nope_head_dim: int = 0
    qk_rope_head_dim: int = 0
    v_head_dim: int = 0
    # MLP
    mlp_type: str = "swiglu"  # "swiglu" | "geglu" | "gelu"
    norm_eps: float = 1e-6
    norm_plus_one: bool = False  # gemma-style (1 + w)
    post_block_norm: bool = False  # gemma2 post-norms
    embed_scale_sqrt_dim: bool = False
    tie_embeddings: bool = True
    # families
    moe: Optional[MoEConfig] = None
    ssm: Optional[SSMConfig] = None
    hybrid: Optional[HybridConfig] = None
    # enc-dec
    n_encoder_layers: int = 0
    # modality frontend stub: "audio" | "vision" | None
    frontend: Optional[str] = None
    frontend_tokens: int = 0  # patches/frames prepended to the text sequence
    # scan/remat
    scan_layers: bool = True
    remat_policy: str = "nothing_saveable"  # "nothing_saveable"|"dots"|"none"
    # quantized serving (the paper's technique at scale)
    kv_cache_dtype: str = "bf16"  # "bf16" | "int8"
    w8a8_serving: bool = False

    def hd(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    def reduced(self) -> "ModelConfig":
        """Small same-family config for CPU smoke tests."""
        cuts = dict(
            n_layers=min(self.n_layers, 2 if self.hybrid is None else self.n_layers),
            d_model=256,
            n_heads=max(2, min(4, self.n_heads)),
            n_kv_heads=max(1, min(2, self.n_kv_heads)) if self.n_kv_heads < self.n_heads else max(2, min(4, self.n_heads)),
            d_ff=512,
            vocab_size=512,
            head_dim=64 if self.head_dim else None,
            frontend_tokens=8 if self.frontend else 0,
            window=min(self.window, 64) if self.window else None,
            n_encoder_layers=min(self.n_encoder_layers, 2),
        )
        if self.q_lora_rank:
            cuts.update(q_lora_rank=64, kv_lora_rank=32, qk_nope_head_dim=32, qk_rope_head_dim=16, v_head_dim=32)
        moe = self.moe
        if moe is not None:
            moe = dataclasses.replace(moe, n_experts=min(8, moe.n_experts), top_k=min(2, moe.top_k),
                                      d_ff_expert=128, d_ff_shared=256 if moe.n_shared_experts else 0)
        ssm = self.ssm
        if ssm is not None:
            ssm = dataclasses.replace(ssm, d_state=16, head_dim=32, lora_rank=16)
        hybrid = self.hybrid
        if hybrid is not None:
            hybrid = dataclasses.replace(hybrid, n_groups=2, ssm_per_group=2, tail_ssm_layers=1)
            cuts["n_layers"] = 2 * 2 + 2 + 1  # groups*(ssm+shared) + tail
        return dataclasses.replace(self, moe=moe, ssm=ssm, hybrid=hybrid, **cuts)


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    """One assigned input-shape cell."""

    name: str  # train_4k | prefill_32k | decode_32k | long_500k
    kind: str  # "train" | "prefill" | "decode"
    seq_len: int
    global_batch: int
    microbatches: int = 1  # gradient-accumulation steps (train only)


SHAPES: Tuple[ShapeConfig, ...] = (
    ShapeConfig("train_4k", "train", 4096, 256, microbatches=8),
    ShapeConfig("prefill_32k", "prefill", 32768, 32),
    ShapeConfig("decode_32k", "decode", 32768, 128),
    ShapeConfig("long_500k", "decode", 524288, 1),
)

SHAPE_BY_NAME = {s.name: s for s in SHAPES}
