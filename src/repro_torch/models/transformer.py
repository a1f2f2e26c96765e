"""Transformer stacks: decoder (GQA/MLA/MoE variants), encoder, enc-dec,
over stacked layer params with a leading (L, ...) dimension, as in
``repro.models.transformer``.

``repro`` scans the stack with ``lax.scan`` (or unrolls it when
``scan_layers`` is False); eager PyTorch has nothing to trace, so both take
the same loop over the layer dimension here.  Per-layer attention flavor
(gemma2's local/global alternation, mixtral's SWA) is data — a per-layer
window from :func:`layer_windows` — so one block body serves every arch.
"""
from __future__ import annotations

import functools
from typing import Optional, Tuple

import numpy as np
import torch
from torch.utils.checkpoint import CheckpointPolicy, checkpoint, create_selective_checkpoint_contexts

from ..configs.base import ModelConfig
from ..distributed.sharding import bind_mesh, shard
from . import attention as attn
from .layers import init_mlp, mlp, rmsnorm
from .moe import init_moe, moe_ffn

# ---------------------------------------------------------------------------
# per-layer params
# ---------------------------------------------------------------------------


def _norm_init(cfg: ModelConfig, lead, dtype, device) -> torch.Tensor:
    fill = torch.zeros if cfg.norm_plus_one else torch.ones
    return fill(tuple(lead) + (cfg.d_model,), dtype=dtype, device=device)


def init_decoder_layer(gen, cfg: ModelConfig, dtype=torch.float32, device=None, lead=()) -> dict:
    """One decoder layer's params, or ``lead`` stacked ones."""
    dev = device or gen.device
    p = {"ln1": _norm_init(cfg, lead, dtype, dev), "ln2": _norm_init(cfg, lead, dtype, dev)}
    if cfg.post_block_norm:
        p["ln1_post"] = _norm_init(cfg, lead, dtype, dev)
        p["ln2_post"] = _norm_init(cfg, lead, dtype, dev)
    if cfg.attn_type == "mla":
        p["attn"] = attn.init_mla(gen, cfg, dtype, device, lead)
    else:
        p["attn"] = attn.init_attention(gen, cfg, dtype, device, lead)
    if cfg.moe is not None:
        p["moe"] = init_moe(gen, cfg, dtype, device, lead)
    else:
        p["mlp"] = init_mlp(gen, cfg.d_model, cfg.d_ff, cfg.mlp_type, dtype, device, lead)
    return p


def init_encoder_layer(gen, cfg: ModelConfig, dtype=torch.float32, device=None, lead=()) -> dict:
    return init_decoder_layer(gen, cfg, dtype, device, lead)


def init_cross_layer(gen, cfg: ModelConfig, dtype=torch.float32, device=None, lead=()) -> dict:
    """Decoder layer + cross-attention sub-block (enc-dec)."""
    p = init_decoder_layer(gen, cfg, dtype, device, lead)
    p["xattn"] = attn.init_attention(gen, cfg, dtype, device, lead)
    p["ln_x"] = torch.ones(tuple(lead) + (cfg.d_model,), dtype=dtype, device=device or gen.device)
    return p


# ---------------------------------------------------------------------------
# block bodies
# ---------------------------------------------------------------------------


def _norm(x, scale, cfg):
    return rmsnorm(x, scale, eps=cfg.norm_eps, plus_one=cfg.norm_plus_one)


def decoder_block(
    p: dict,
    x: torch.Tensor,
    pos: torch.Tensor,
    cfg: ModelConfig,
    *,
    window: int,  # 0 = full
    cache: Optional[dict] = None,
    mode: str = "train",
    bidirectional: bool = False,
    cross_kv: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
    q_chunk: int = 1024,
    kv_chunk: int = 1024,
) -> Tuple[torch.Tensor, Optional[dict], torch.Tensor]:
    """Returns (hidden, new_cache, aux_loss).  ``cross_kv`` is this layer's
    precomputed encoder K/V (enc-dec only; cached at prefill for decode)."""
    x = shard(x, "batch", None, None)
    h = _norm(x, p["ln1"], cfg)
    if cfg.attn_type == "mla":
        a_out, new_cache = attn.mla_attention(
            p["attn"], h, pos, cfg, cache=cache, mode=mode, q_chunk=q_chunk, kv_chunk=kv_chunk
        )
    else:
        a_out, new_cache = attn.gqa_attention(
            p["attn"], h, pos, cfg,
            window=window, cache=cache, mode=mode, bidirectional=bidirectional,
            q_chunk=q_chunk, kv_chunk=kv_chunk,
        )
    if cfg.post_block_norm:
        a_out = _norm(a_out, p["ln1_post"], cfg)
    x = x + a_out

    if cross_kv is not None:  # enc-dec cross attention
        h = _norm(x, p["ln_x"], cfg)
        x = x + attn.cross_attention(p["xattn"], h, cross_kv, cfg)

    h = _norm(x, p["ln2"], cfg)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    if cfg.moe is not None:
        f_out, aux = moe_ffn(p["moe"], h, cfg)
    else:
        f_out = mlp(p["mlp"], h, cfg.mlp_type)
    if cfg.post_block_norm:
        f_out = _norm(f_out, p["ln2_post"], cfg)
    return x + f_out, new_cache, aux


# ---------------------------------------------------------------------------
# stacks (a loop over the stacked layer dimension)
# ---------------------------------------------------------------------------


def layer_windows(cfg: ModelConfig, n_layers: int) -> np.ndarray:
    """Per-layer attention window sizes (0 = unlimited)."""
    if cfg.attn_type == "swa":
        return np.full((n_layers,), cfg.window or 0, np.int32)
    if cfg.attn_type == "local_global":
        w = np.zeros((n_layers,), np.int32)
        w[0::2] = cfg.window or 0  # even layers local (gemma2 convention)
        return w
    return np.zeros((n_layers,), np.int32)


#: The matmul outputs the ``"dots"`` policy keeps, as ``jax.checkpoint_policies.
#: checkpoint_dots`` keeps XLA's dot results.
_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.bmm.default, torch.ops.aten.addmm.default)


def _save_dots(ctx, op, *args, **kwargs):
    return CheckpointPolicy.MUST_SAVE if op in _DOTS else CheckpointPolicy.PREFER_RECOMPUTE


def _remat(fn, policy: str):
    """``fn`` under ``repro``'s rematerialization ``policy``: ``"none"``
    keeps every activation; ``"nothing_saveable"`` keeps only ``fn``'s
    inputs and recomputes the rest in the backward; ``"dots"`` also keeps
    the matmul outputs.  Recomputation repeats the same operations, so the
    gradients equal those of ``"none"`` bit for bit, under the mesh of the
    forward (:func:`~repro_torch.distributed.sharding.bind_mesh`)."""
    if policy == "none":
        return fn
    fn = bind_mesh(fn)
    if policy == "nothing_saveable":
        return functools.partial(checkpoint, fn, use_reentrant=False)
    if policy == "dots":
        return functools.partial(
            checkpoint, fn, use_reentrant=False,
            context_fn=functools.partial(create_selective_checkpoint_contexts, _save_dots))
    raise ValueError(f"unknown remat policy {policy!r}")


def tree_unbind(tree, n: int) -> list:
    """The ``n`` slices of the leading dimension of every leaf, as a list of
    ``n`` trees of views; dicts, tuples and lists keep their shape, ``None``
    stays ``None``.  ``torch.unbind``'s backward stacks the slices'
    gradients once, where indexing one slice at a time would fill a zero
    ``(L, ...)`` gradient for every slice."""
    if tree is None:
        return [None] * n
    if isinstance(tree, dict):
        parts = {k: tree_unbind(v, n) for k, v in tree.items()}
        return [{k: v[i] for k, v in parts.items()} for i in range(n)]
    if isinstance(tree, (tuple, list)):
        parts = [tree_unbind(v, n) for v in tree]
        return [type(tree)(v[i] for v in parts) for i in range(n)]
    if tree.shape[0] != n:
        raise ValueError(f"a leaf of {tree.shape[0]} slices in a stack of {n}")
    return list(torch.unbind(tree))


def stack_len(tree) -> int:
    """The leading (stacked) dimension of a tree's first leaf."""
    while isinstance(tree, (dict, tuple, list)):
        tree = next(iter(tree.values())) if isinstance(tree, dict) else tree[0]
    return tree.shape[0]


def tree_stack(trees):
    """Stack a list of like-shaped trees leaf by leaf along a new axis 0."""
    first = trees[0]
    if first is None:
        return None
    if isinstance(first, dict):
        return {k: tree_stack([t[k] for t in trees]) for k in first}
    if isinstance(first, (tuple, list)):
        return type(first)(tree_stack([t[j] for t in trees]) for j in range(len(first)))
    return torch.stack(trees)


def run_decoder_stack(
    stacked: dict,  # params with leading (L, ...) dim
    x: torch.Tensor,
    pos: torch.Tensor,
    cfg: ModelConfig,
    *,
    windows: np.ndarray,  # (L,) int
    caches: Optional[dict] = None,  # stacked leading (L, ...)
    mode: str = "train",
    bidirectional: bool = False,
    cross_kv: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,  # stacked (L, ...)
    q_chunk: int = 1024,
    kv_chunk: int = 1024,
) -> Tuple[torch.Tensor, Optional[dict], torch.Tensor]:
    """The layer stack, one layer at a time (``scan_layers`` either way)."""
    block = _remat(decoder_block, cfg.remat_policy if mode == "train" else "none")
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    new_list = []
    n = len(windows)
    for i, (p_l, c_l, x_kv) in enumerate(zip(tree_unbind(stacked, n), tree_unbind(caches, n),
                                             tree_unbind(cross_kv, n))):
        x, c_new, aux_l = block(
            p_l, x, pos, cfg,
            window=int(windows[i]), cache=c_l, mode=mode,
            bidirectional=bidirectional, cross_kv=x_kv,
            q_chunk=q_chunk, kv_chunk=kv_chunk,
        )
        aux = aux + aux_l
        new_list.append(c_new)
    new_caches = None if caches is None else tree_stack(new_list)
    return x, new_caches, aux


def compute_cross_kv(stacked_xattn: dict, enc_out: torch.Tensor, cfg: ModelConfig):
    """Precompute per-layer encoder K/V for cross-attention (cached for
    decode): a tuple of (L, B, T, Hkv, Dh) k and v."""
    kv = [attn.encdec_cross_kv(p_l, enc_out, cfg)
          for p_l in tree_unbind(stacked_xattn, stack_len(stacked_xattn))]
    return tree_stack(kv)
