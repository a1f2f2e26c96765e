"""Architecture registry: the 10 assigned configs + the paper's own examples.

Each ``<arch>.py`` exports ``CONFIG`` with the exact published dimensions
([source; verified-tier] in its docstring).  ``get_config(name)`` resolves
hyphen or underscore ids; ``get_config(name, reduced=True)`` returns the
CPU smoke-test reduction.
"""
from __future__ import annotations

import importlib

from .base import SHAPES, SHAPE_BY_NAME, ModelConfig, MoEConfig, ShapeConfig, SSMConfig, HybridConfig  # noqa: F401

ARCH_IDS = (
    "seamless_m4t_large_v2",
    "minicpm3_4b",
    "gemma2_2b",
    "minicpm_2b",
    "qwen3_1_7b",
    "rwkv6_3b",
    "zamba2_7b",
    "pixtral_12b",
    "qwen2_moe_a2_7b",
    "mixtral_8x22b",
)


def canon(name: str) -> str:
    return name.replace("-", "_").replace(".", "_")


def get_config(name: str, *, reduced: bool = False) -> ModelConfig:
    cid = canon(name)
    if cid not in ARCH_IDS:
        raise KeyError(f"unknown arch {name!r}; have {ARCH_IDS}")
    mod = importlib.import_module(f".{cid}", __name__)
    cfg: ModelConfig = mod.CONFIG
    return cfg.reduced() if reduced else cfg


def all_configs(reduced: bool = False):
    return {cid: get_config(cid, reduced=reduced) for cid in ARCH_IDS}
