"""Unified model API over all four families (decoder / enc-dec / rwkv6 /
hybrid), as in ``repro.models.model``:

    init_params(generator, cfg, dtype, device)   -> params tree (f32 masters)
    init_cache(cfg, batch, max_len, device=...)  -> serving cache tree
    loss_fn(params, batch, cfg)                  -> (loss, metrics)   [train]
    prefill(params, batch, cfg, cache)           -> (last_logits, cache)
    decode_step(params, tokens, pos, cache, cfg) -> (logits, cache)
    param_logical_axes(params)                   -> logical-axes tree
    params_from_numpy(tree) / cache_from_numpy(tree) -> trees on a device

Parameters keep ``repro``'s tree exactly: the same nested dict keys and the
same stacked leading dimensions, so ``repro``'s parameters and caches carry
across as a tree map of their leaves (:func:`params_from_numpy`), and so do the
optimizer's moments (:func:`opt_state_from_numpy`).

Modality frontends are stubs, as in ``repro``: batches carry precomputed
frame/patch embeddings which are concatenated or consumed directly.
"""
from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch

from ..configs.base import ModelConfig
from ..core.compile import resolve_device
from ..distributed.sharding import shard, unshard
from . import attention as attn
from . import transformer as tfm
from .layers import embed, init_embedding, logits_from_embedding, param, rmsnorm
from .mamba2 import init_mamba2_layer, init_mamba2_state, mamba2_block
from .rwkv6 import init_rwkv6_layer, init_rwkv6_state, rwkv6_block

# ---------------------------------------------------------------------------
# trees
# ---------------------------------------------------------------------------


def tree_map(fn: Callable, tree, path: Tuple = ()):
    """``fn(path, leaf)`` over every tensor leaf of a dict / tuple / list
    tree; ``path`` holds dict keys (str) and sequence indices (int); ``None``
    stays ``None``."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, path + (k,)) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(tree_map(fn, v, path + (i,)) for i, v in enumerate(tree))
    return fn(path, tree)


def _to_tensor(a, device) -> torch.Tensor:
    a = np.array(a, copy=True, order="C")  # torch shares the buffer: own a writable one
    if a.dtype.name == "bfloat16":  # ml_dtypes' bfloat16: reinterpret the bits
        return torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16).to(device)
    return torch.from_numpy(a).to(device)


def params_from_numpy(tree, device=None):
    """A parameter tree of numpy arrays (``repro``'s, through ``np.asarray``
    on each leaf, or loaded from disk) as tensors on ``device`` (``None``:
    the card), the tree's shape kept."""
    dev = resolve_device(device)
    return tree_map(lambda _, a: _to_tensor(a, dev), tree)


def opt_state_from_numpy(state, device=None):
    """An AdamW state ``{"m", "v", "step"}`` of numpy arrays (``repro``'s,
    through ``np.asarray`` on each leaf) as tensors on ``device`` (``None``:
    the card); ``step`` stays a 0-d int32 tensor."""
    return params_from_numpy(state, device)


def cache_from_numpy(tree, device=None):
    """A serving cache tree of numpy arrays (bfloat16 ones included) as
    tensors on ``device`` (``None``: the card)."""
    return params_from_numpy(tree, device)


def cast_params(params, dtype: torch.dtype):
    """Every float32 leaf of two or more dims as ``dtype``, the rest as they
    are: the cast ``repro``'s ``forward`` makes on each call.  A leaf that
    already has ``dtype`` is returned as it is, so casting a cast tree copies
    nothing."""
    return tree_map(lambda _, a: a.to(dtype) if a.dtype == torch.float32 and a.ndim >= 2 else a,
                    params)


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------


def padded_vocab(cfg: ModelConfig) -> int:
    """Vocab padded to a multiple of 256 (``repro``'s shardable, lane-aligned
    width).  Padded logits are masked in :func:`_logits`."""
    return (cfg.vocab_size + 255) // 256 * 256


def init_params(generator: torch.Generator, cfg: ModelConfig, dtype=torch.float32,
                device=None) -> dict:
    """Seeded parameters in ``repro``'s tree.  Values are drawn on the
    generator's device and placed on ``device`` (``None``: the card)."""
    dev = resolve_device(device)
    gen = generator
    d = cfg.d_model
    fill = torch.zeros if cfg.norm_plus_one else torch.ones
    p: dict = {"embed": init_embedding(gen, padded_vocab(cfg), d, dtype, dev)}
    p["final_norm"] = fill((d,), dtype=dtype, device=dev)
    if not cfg.tie_embeddings:
        p["lm_head"] = param(gen, (d, padded_vocab(cfg)), dtype=dtype, device=dev)

    if cfg.family == "decoder":
        p["layers"] = tfm.init_decoder_layer(gen, cfg, dtype, dev, lead=(cfg.n_layers,))
    elif cfg.family == "encdec":
        p["encoder"] = tfm.init_encoder_layer(gen, cfg, dtype, dev, lead=(cfg.n_encoder_layers,))
        p["layers"] = tfm.init_cross_layer(gen, cfg, dtype, dev, lead=(cfg.n_layers,))
        p["enc_final_norm"] = torch.ones((d,), dtype=dtype, device=dev)
    elif cfg.family == "rwkv6":
        lead = (cfg.n_layers,)
        p["layers"] = init_rwkv6_layer(gen, cfg, dtype, dev, lead)
        p["layers"]["ln1"] = torch.ones(lead + (d,), dtype=dtype, device=dev)
        p["layers"]["ln2"] = torch.ones(lead + (d,), dtype=dtype, device=dev)
    elif cfg.family == "hybrid":
        hy = cfg.hybrid

        def init_mamba(lead):
            lp = init_mamba2_layer(gen, cfg, dtype, dev, lead)
            lp["ln"] = torch.ones(lead + (d,), dtype=dtype, device=dev)
            return lp

        p["mamba_groups"] = init_mamba((hy.n_groups, hy.ssm_per_group))
        if hy.tail_ssm_layers:
            p["mamba_tail"] = init_mamba((hy.tail_ssm_layers,))
        p["shared_block"] = tfm.init_decoder_layer(gen, cfg, dtype, dev)
    else:
        raise ValueError(f"unknown family {cfg.family!r}")
    return p


# ---------------------------------------------------------------------------
# caches
# ---------------------------------------------------------------------------


def init_cache(cfg: ModelConfig, batch: int, max_len: int, src_len: int = 0, *,
               device=None) -> dict:
    """The serving cache on ``device`` (``None``: the card)."""
    dev = resolve_device(device)
    dt = cfg.kv_cache_dtype
    if cfg.attn_type == "swa" and cfg.window:
        # ring buffer: SWA never attends past `window`, so the cache is capped
        max_len = min(max_len, cfg.window)
    spec = attn.KVCacheSpec(batch, max_len, cfg.n_kv_heads, cfg.hd(), dt)
    if cfg.family == "decoder":
        if cfg.attn_type == "mla":
            return {"layers": attn.init_mla_cache(batch, max_len, cfg, dt, dev, (cfg.n_layers,))}
        return {"layers": attn.init_kv_cache(spec, dev, (cfg.n_layers,))}
    if cfg.family == "encdec":
        shape = (cfg.n_layers, batch, src_len, cfg.n_kv_heads, cfg.hd())
        return {
            "layers": attn.init_kv_cache(spec, dev, (cfg.n_layers,)),
            "cross_kv": (torch.zeros(shape, dtype=torch.bfloat16, device=dev),
                         torch.zeros(shape, dtype=torch.bfloat16, device=dev)),
        }
    if cfg.family == "rwkv6":
        return {"layers": init_rwkv6_state(batch, cfg, dev, (cfg.n_layers,))}
    if cfg.family == "hybrid":
        hy = cfg.hybrid
        cache = {
            "mamba_groups": init_mamba2_state(batch, cfg, dev, (hy.n_groups, hy.ssm_per_group)),
            "shared_kv": attn.init_kv_cache(spec, dev, (hy.n_groups,)),
        }
        if hy.tail_ssm_layers:
            cache["mamba_tail"] = init_mamba2_state(batch, cfg, dev, (hy.tail_ssm_layers,))
        return cache
    raise ValueError(cfg.family)


def init_hybrid_states(cfg: ModelConfig, batch: int, *, device=None) -> dict:
    """Mamba recurrence states only (no KV cache)."""
    dev = resolve_device(device)
    hy = cfg.hybrid
    st = {"mamba_groups": init_mamba2_state(batch, cfg, dev, (hy.n_groups, hy.ssm_per_group)),
          "shared_kv": None}
    if hy.tail_ssm_layers:
        st["mamba_tail"] = init_mamba2_state(batch, cfg, dev, (hy.tail_ssm_layers,))
    return st


# ---------------------------------------------------------------------------
# forward bodies per family
# ---------------------------------------------------------------------------


def _embed_inputs(params, batch: Dict, cfg: ModelConfig, compute_dtype):
    """Token (+ frontend-stub) embedding.  Returns (x (B,S,d), pos (S,))."""
    dev = params["embed"]["table"].device
    tokens = torch.as_tensor(batch["tokens"], device=dev)
    x = embed(params["embed"], tokens, scale_by_sqrt_dim=cfg.embed_scale_sqrt_dim).to(compute_dtype)
    if cfg.frontend == "vision" and "patch_embeds" in batch:
        patches = torch.as_tensor(batch["patch_embeds"], device=dev)
        x = torch.cat([patches.to(compute_dtype), x], dim=1)
    pos = torch.arange(x.shape[1], dtype=torch.int32, device=dev)
    return x, pos


def _rwkv_stack(params, x, caches, cfg, mode):
    body = tfm._remat(rwkv6_block, cfg.remat_policy if mode == "train" else "none")
    n = tfm.stack_len(params["layers"])
    states = []
    for p_l, st_l in zip(tfm.tree_unbind(params["layers"], n), tfm.tree_unbind(caches["layers"], n)):
        x = shard(x, "batch", None, None)
        x, st = body(p_l, x, st_l, cfg, {"ln1": p_l["ln1"], "ln2": p_l["ln2"]})
        states.append(st)
    return x, {"layers": tfm.tree_stack(states)}, torch.zeros((), device=x.device)


def _mamba_stack(x, p_stack, st_stack, cfg, mode):
    body = tfm._remat(mamba2_block, cfg.remat_policy if mode == "train" else "none")
    n = tfm.stack_len(st_stack)
    states = []
    for p_l, st_l in zip(tfm.tree_unbind(p_stack, n), tfm.tree_unbind(st_stack, n)):
        x, st = body(p_l, shard(x, "batch", None, None), st_l, cfg, p_l["ln"])
        states.append(st)
    return x, tfm.tree_stack(states)


def _hybrid_stack(params, x, pos, caches, cfg, mode, q_chunk, kv_chunk):
    hy = cfg.hybrid

    def group_body(x, p_g, st_g, kv_g):
        x, st = _mamba_stack(x, p_g, st_g, cfg, mode)
        x, kv, aux_l = tfm.decoder_block(
            params["shared_block"], x, pos, cfg,
            window=0, cache=kv_g, mode=mode, q_chunk=q_chunk, kv_chunk=kv_chunk,
        )
        return x, aux_l, st, kv

    group_body = tfm._remat(group_body, cfg.remat_policy if mode == "train" else "none")
    aux = torch.zeros((), device=x.device)
    m_list, kv_list = [], []
    n = hy.n_groups
    for p_g, st_g, kv_g in zip(tfm.tree_unbind(params["mamba_groups"], n),
                               tfm.tree_unbind(caches["mamba_groups"], n),
                               tfm.tree_unbind(caches.get("shared_kv"), n)):
        x, aux_l, st, kv = group_body(x, p_g, st_g, kv_g)
        aux = aux + aux_l
        m_list.append(st)
        kv_list.append(kv)
    new_cache = {"mamba_groups": tfm.tree_stack(m_list), "shared_kv": tfm.tree_stack(kv_list)}
    if hy.tail_ssm_layers:
        x, new_cache["mamba_tail"] = _mamba_stack(x, params["mamba_tail"], caches["mamba_tail"],
                                                  cfg, mode)
    return x, new_cache, aux


def forward(
    params: dict,
    batch: Dict,
    cfg: ModelConfig,
    *,
    mode: str = "train",  # train | prefill | decode
    caches: Optional[dict] = None,
    pos: Optional[torch.Tensor] = None,  # (B,) decode positions
    compute_dtype=torch.bfloat16,
    q_chunk: int = 1024,
    kv_chunk: int = 1024,
) -> Tuple[torch.Tensor, Optional[dict], torch.Tensor]:
    """Returns (hidden (B,S,d), new_caches, aux_loss)."""
    params = cast_params(params, compute_dtype)
    dev = params["embed"]["table"].device
    windows = tfm.layer_windows(cfg, cfg.n_layers)
    if pos is not None:
        pos = torch.as_tensor(pos, device=dev)

    if cfg.family == "rwkv6":
        x, _ = _embed_inputs(params, batch, cfg, compute_dtype)
        if caches is None:
            caches = init_cache(cfg, x.shape[0], 0, device=dev)
        x, new_caches, aux = _rwkv_stack(params, x, caches, cfg, mode)
    elif cfg.family == "hybrid":
        x, xpos = _embed_inputs(params, batch, cfg, compute_dtype)
        p_eff = pos if mode == "decode" else xpos
        if caches is None:
            caches = init_hybrid_states(cfg, x.shape[0], device=dev)
        x, new_caches, aux = _hybrid_stack(params, x, p_eff, caches, cfg, mode, q_chunk, kv_chunk)
    elif cfg.family == "encdec":
        x, xpos = _embed_inputs(params, batch, cfg, compute_dtype)
        p_eff = pos if mode == "decode" else xpos
        layer_caches = None if caches is None else caches["layers"]
        if mode == "decode":
            cross_kv = tuple(a.to(compute_dtype) for a in caches["cross_kv"])
        else:
            src = torch.as_tensor(batch["src_embeds"], device=dev).to(compute_dtype)
            enc_out, _, _ = tfm.run_decoder_stack(
                params["encoder"], src, torch.arange(src.shape[1], dtype=torch.int32, device=dev),
                cfg, windows=np.zeros((cfg.n_encoder_layers,), np.int32), caches=None,
                mode="train", bidirectional=True, q_chunk=q_chunk, kv_chunk=kv_chunk,
            )
            enc_out = rmsnorm(enc_out, params["enc_final_norm"], eps=cfg.norm_eps)
            cross_kv = tfm.compute_cross_kv(params["layers"]["xattn"], enc_out, cfg)
        x, new_layer_caches, aux = tfm.run_decoder_stack(
            params["layers"], x, p_eff, cfg,
            windows=windows, caches=layer_caches, mode=mode, cross_kv=cross_kv,
            q_chunk=q_chunk, kv_chunk=kv_chunk,
        )
        new_caches = None
        if caches is not None:
            new_caches = {"layers": new_layer_caches,
                          "cross_kv": tuple(a.to(torch.bfloat16) for a in cross_kv)}
    else:  # decoder
        x, xpos = _embed_inputs(params, batch, cfg, compute_dtype)
        p_eff = pos if mode == "decode" else xpos
        layer_caches = None if caches is None else caches["layers"]
        x, new_layer_caches, aux = tfm.run_decoder_stack(
            params["layers"], x, p_eff, cfg,
            windows=windows, caches=layer_caches, mode=mode,
            q_chunk=q_chunk, kv_chunk=kv_chunk,
        )
        new_caches = None if caches is None else {"layers": new_layer_caches}

    x = rmsnorm(x, params["final_norm"], eps=cfg.norm_eps, plus_one=cfg.norm_plus_one)
    return x, new_caches, aux


def _logits(params, x, cfg: ModelConfig) -> torch.Tensor:
    if cfg.tie_embeddings:
        logits = logits_from_embedding(params["embed"], x, softcap=cfg.logit_softcap)
    else:
        logits = x.to(torch.float32) @ params["lm_head"].to(torch.float32)
        if cfg.logit_softcap is not None:
            logits = cfg.logit_softcap * torch.tanh(logits / cfg.logit_softcap)
    vp = padded_vocab(cfg)
    if vp != cfg.vocab_size:  # mask the padded tail
        mask = torch.arange(vp, device=logits.device) < cfg.vocab_size
        logits = torch.where(mask, logits, -1e30)
    return shard(logits, "batch", None, "vocab_act")


# ---------------------------------------------------------------------------
# train / serve entry points
# ---------------------------------------------------------------------------


def loss_fn(
    params: dict,
    batch: Dict,
    cfg: ModelConfig,
    *,
    compute_dtype=torch.bfloat16,
    q_chunk: int = 1024,
    kv_chunk: int = 1024,
) -> Tuple[torch.Tensor, Dict]:
    """Next-token cross-entropy over the padded vocab + MoE aux, as
    ``repro``'s.  The gold logit is a gather where ``repro`` contracts a
    one-hot: both give the one logit exactly, and the gather builds no
    (B, S, V) one-hot."""
    x, _, aux = forward(
        params, batch, cfg, mode="train",
        compute_dtype=compute_dtype, q_chunk=q_chunk, kv_chunk=kv_chunk,
    )
    if cfg.frontend == "vision" and "patch_embeds" in batch:
        x = x[:, batch["patch_embeds"].shape[1]:]  # loss over text positions only
    # next-token objective: position t predicts label t+1
    labels = torch.as_tensor(batch["labels"], device=x.device).long()
    labels = torch.cat([labels[:, 1:], torch.full_like(labels[:, :1], -1)], dim=1)
    logits = _logits(params, x, cfg)  # (B, S, V) f32
    m = logits.amax(dim=-1, keepdim=True)
    lse = torch.log(torch.sum(torch.exp(logits - m), dim=-1)) + m[..., 0]
    valid = labels >= 0
    # DTensor's vocab-parallel gather leaves a masked partial that the
    # subtraction below cannot reduce: gather from whole rows under a mesh
    gold = torch.gather(unshard(logits, -1), -1, torch.where(valid, labels, 0)[..., None])[..., 0]
    valid = valid.to(torch.float32)
    nll = (lse - gold) * valid
    tokens = valid.sum()
    loss = nll.sum() / torch.clamp_min(tokens, 1.0)
    total = loss + aux
    return total, {"loss": loss, "aux_loss": aux, "tokens": tokens}


def prefill(
    params: dict,
    batch: Dict,
    cfg: ModelConfig,
    caches: dict,
    *,
    compute_dtype=torch.bfloat16,
    q_chunk: int = 1024,
    kv_chunk: int = 1024,
    cast: Optional[dict] = None,
) -> Tuple[torch.Tensor, dict]:
    """Run the prompt through the model, writing caches; returns logits at the
    last position (B, V).  ``cast`` is ``cast_params(params, compute_dtype)``
    made once by the caller, so the forward pass copies no weight; the
    readout uses ``params`` (the f32 masters), as ``repro``'s does."""
    x, new_caches, _ = forward(
        params if cast is None else cast, batch, cfg, mode="prefill", caches=caches,
        compute_dtype=compute_dtype, q_chunk=q_chunk, kv_chunk=kv_chunk,
    )
    logits = _logits(params, x[:, -1:], cfg)[:, 0]
    return logits, new_caches


def decode_step(
    params: dict,
    tokens: torch.Tensor,  # (B, 1)
    pos: torch.Tensor,  # (B,) position of the new token
    caches: dict,
    cfg: ModelConfig,
    *,
    compute_dtype=torch.bfloat16,
    cast: Optional[dict] = None,
) -> Tuple[torch.Tensor, dict]:
    """One serving step: append one token per sequence, return (B, V) logits
    (``cast`` as in :func:`prefill`)."""
    x, new_caches, _ = forward(
        params if cast is None else cast, {"tokens": tokens}, cfg, mode="decode",
        caches=caches, pos=pos, compute_dtype=compute_dtype,
    )
    logits = _logits(params, x, cfg)[:, 0]
    return logits, new_caches


# ---------------------------------------------------------------------------
# sharding: logical axes from param paths
# ---------------------------------------------------------------------------

_AXES_BY_NAME = {
    "table": ("vocab", "embed"),
    "lm_head": ("embed", "vocab"),
    "wq": ("embed", "heads"),
    "wk": ("embed", "heads"),
    "wv": ("embed", "heads"),
    "wo": ("heads", "embed"),
    "w_gate": ("embed", "mlp"),
    "w_up": ("embed", "mlp"),
    "w_down": ("mlp", "embed"),
    "q_down": ("embed", "heads"),
    "q_up": ("embed", "heads"),
    "kv_down": ("embed", "heads"),
    "kv_up": ("embed", "heads"),
    "router": ("embed", None),
    "shared_gate_proj": ("embed", None),
    "shared_w_gate": ("embed", "mlp"),
    "shared_w_up": ("embed", "mlp"),
    "shared_w_down": ("mlp", "embed"),
    "in_proj": ("embed", "mlp"),
    "out_proj": ("mlp", "embed"),
    "conv_w": (None, "mlp"),
    "tm_maa_w1": ("embed", "mlp"),
    "tm_maa_w2": (None, None, "embed"),
    "td_w1": ("embed", None),
    "td_w2": (None, "embed"),
    "wr": ("embed", "heads"),
    "wg": ("embed", "heads"),
    "cm_wk": ("embed", "mlp"),
    "cm_wv": ("mlp", "embed"),
    "cm_wr": ("embed", "heads"),
}

_MOE_STACKED = {"w_gate", "w_up", "w_down"}  # under "moe": leading expert dim


def _names(path) -> list:
    """Path entries as ``repro`` names them: dict keys, ``None`` for a
    sequence index."""
    return [k if isinstance(k, str) else None for k in path]


def param_logical_axes(params: dict) -> dict:
    """Logical axes per leaf from path names; leading stack dims (layers,
    groups, experts) map to None/"expert"."""

    def leaf_axes(path, leaf) -> Tuple:
        names = _names(path)
        last = names[-1]
        scales_only = False
        if last in ("q8", "s"):  # W8A8-converted leaf: axes come from parent
            scales_only = last == "s"
            last = names[-2]
        base = _AXES_BY_NAME.get(last)
        if base is None:
            return (None,) * leaf.ndim
        if "moe" in names and last in _MOE_STACKED:
            base = ("expert",) + base
        if scales_only:
            base = base[-1:]  # per-out-channel scales follow the out axis
        # pad leading stack dims (layer scan, hybrid groups) with None
        return (None,) * (leaf.ndim - len(base)) + base

    return tree_map(leaf_axes, params)


def cache_logical_axes(caches: dict, model_axis: int = 16) -> dict:
    """Logical axes for serving caches: KV tensors prefer head-sharding over
    the model axis, and fall back to sequence sharding when the kv-head
    count does not divide it."""

    def leaf_axes(path, leaf) -> Tuple:
        last = _names(path)[-1]
        if last in ("k", "v") and leaf.ndim >= 4:
            if leaf.shape[-2] % model_axis == 0:
                base = ("batch", None, "kv_heads_act", None)
            else:
                base = ("batch", "seq_shard", None, None)
        elif last in ("ckv", "k_pe"):
            base = ("batch", "seq_shard", None)
        elif last in ("wkv", "ssd"):
            base = ("batch", "kv_heads_act", None, None)
        elif last in ("tm_shift", "cm_shift"):
            base = ("batch", None)
        elif last == "conv":
            base = ("batch", None, None)
        elif last in ("k_scale", "v_scale", "ckv_scale"):
            base = ("batch",) + (None,) * (leaf.ndim - 1)
        else:
            base = (None,) * leaf.ndim
        return (None,) * (leaf.ndim - len(base)) + tuple(base)

    return tree_map(leaf_axes, caches)
