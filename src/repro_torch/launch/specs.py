"""Meta-tensor input specs + shardings for every (arch × shape) cell, as in
``repro.launch.specs``.

``repro`` describes each input with a ``jax.ShapeDtypeStruct`` and shapes a
tree with ``jax.eval_shape``; here a spec is a tensor on the ``meta``
device (shape and dtype, no storage), and a tree is built by running its
init on ``meta``.  Nothing is allocated; the dry-run runs its steps on
these.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch

from ..configs.base import ModelConfig, ShapeConfig
from ..distributed import sharding as shlib
from ..models import model as M

F32, BF16, I32 = torch.float32, torch.bfloat16, torch.int32


def sds(shape, dtype) -> torch.Tensor:
    return torch.empty(tuple(shape), dtype=dtype, device="meta")


def train_batch_specs(cfg: ModelConfig, sc: ShapeConfig) -> Dict[str, torch.Tensor]:
    b, s = sc.global_batch, sc.seq_len
    out = {}
    if cfg.frontend == "vision":
        n_txt = s - cfg.frontend_tokens
        out["tokens"] = sds((b, n_txt), I32)
        out["labels"] = sds((b, n_txt), I32)
        out["patch_embeds"] = sds((b, cfg.frontend_tokens, cfg.d_model), BF16)
    else:
        out["tokens"] = sds((b, s), I32)
        out["labels"] = sds((b, s), I32)
    if cfg.family == "encdec":
        out["src_embeds"] = sds((b, s, cfg.d_model), BF16)
    return out


def batch_shardings(batch_specs, mesh) -> Dict:
    out = {}
    for k, v in batch_specs.items():
        axes = ("batch",) + (None,) * (len(v.shape) - 1)
        out[k] = shlib.sharding_for(v.shape, axes, mesh)
    return out


def params_specs(cfg: ModelConfig):
    return M.init_params(torch.Generator().manual_seed(0), cfg, device="meta")


def params_shardings(p_specs, mesh):
    axes = M.param_logical_axes(p_specs)
    return shlib.tree_shardings(p_specs, lambda path, _: _at(axes, path), mesh)


def cache_specs(cfg: ModelConfig, batch: int, max_len: int, src_len: int = 0):
    return M.init_cache(cfg, batch, max_len, src_len=src_len, device="meta")


def cache_shardings(c_specs, mesh):
    axes = M.cache_logical_axes(c_specs)
    return shlib.tree_shardings(c_specs, lambda path, _: _at(axes, path), mesh)


def decode_input_specs(cfg: ModelConfig, sc: ShapeConfig):
    """(tokens, pos, cache) for one decode step with a cache of sc.seq_len."""
    b = sc.global_batch
    toks = sds((b, 1), I32)
    pos = sds((b,), I32)
    cache = cache_specs(cfg, b, sc.seq_len, src_len=min(sc.seq_len, 4096) if cfg.family == "encdec" else 0)
    return toks, pos, cache


def prefill_input_specs(cfg: ModelConfig, sc: ShapeConfig):
    batch = train_batch_specs(cfg, sc)
    batch.pop("labels")
    cache = cache_specs(cfg, sc.global_batch, sc.seq_len, src_len=sc.seq_len if cfg.family == "encdec" else 0)
    return batch, cache


def skip_reason(cfg: ModelConfig, sc: ShapeConfig) -> Optional[str]:
    """Assignment skip rules (documented in DESIGN.md §4)."""
    if sc.name == "long_500k":
        subquadratic = cfg.family in ("rwkv6", "hybrid") or cfg.attn_type in ("swa", "local_global")
        if not subquadratic:
            return "long_500k skipped: pure full-attention arch (per assignment)"
    return None


def _at(tree, path):
    for k in path:
        tree = tree[k]
    return tree
