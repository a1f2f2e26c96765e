"""Attention: GQA (+qk_norm, softcap, sliding window, local/global), MLA,
cross-attention, chunked (flash-style) computation, and bf16/int8 KV caches.

Conventions, as in ``repro.models.attention``:

* q is kept grouped as (B, S, Hkv, G, Dh) — G = n_heads // n_kv_heads — so GQA
  never materializes repeated K/V.
* Prefill uses :func:`chunked_attention`: a loop over KV chunks inside a loop
  over Q chunks with an online softmax, in ``repro``'s chunking and carry
  order.  It is written in plain tensor ops, not with
  ``scaled_dot_product_attention``: a library kernel would sum in another
  order than the reference.
* The int8 KV cache is the paper's symmetric scheme on the cache: per
  (batch, head) scales chosen at prefill, round half to even, saturate; the
  decode path dequantizes on read.

Every mask, position and ring index is built on the input's device.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from ..configs.base import ModelConfig
from ..core.qlayers import div127
from ..distributed.sharding import local_einsum, pad_as, shard, split_last, unshard_for_split, unshard_grad_for_split
from .layers import apply_rope, linear, param, rmsnorm, softcap_fn

NEG_INF = -2.0**30  # large-negative instead of -inf: keeps softmax NaN-free


# ---------------------------------------------------------------------------
# params
# ---------------------------------------------------------------------------


def init_attention(gen, cfg: ModelConfig, dtype=torch.float32, device=None, lead=()) -> dict:
    hd = cfg.hd()
    lead = tuple(lead)
    p = {
        "wq": param(gen, lead + (cfg.d_model, cfg.n_heads * hd), dtype=dtype, device=device),
        "wk": param(gen, lead + (cfg.d_model, cfg.n_kv_heads * hd), dtype=dtype, device=device),
        "wv": param(gen, lead + (cfg.d_model, cfg.n_kv_heads * hd), dtype=dtype, device=device),
        "wo": param(gen, lead + (cfg.n_heads * hd, cfg.d_model), dtype=dtype, device=device),
    }
    if cfg.qk_norm:
        p["q_norm"] = torch.ones(lead + (hd,), dtype=dtype, device=p["wq"].device)
        p["k_norm"] = torch.ones(lead + (hd,), dtype=dtype, device=p["wq"].device)
    return p


def init_mla(gen, cfg: ModelConfig, dtype=torch.float32, device=None, lead=()) -> dict:
    lead = tuple(lead)
    qk_head = cfg.qk_nope_head_dim + cfg.qk_rope_head_dim
    p = {"q_down": param(gen, lead + (cfg.d_model, cfg.q_lora_rank), dtype=dtype, device=device)}
    dev = p["q_down"].device
    p["q_norm"] = torch.ones(lead + (cfg.q_lora_rank,), dtype=dtype, device=dev)
    p["q_up"] = param(gen, lead + (cfg.q_lora_rank, cfg.n_heads * qk_head), dtype=dtype, device=device)
    p["kv_down"] = param(gen, lead + (cfg.d_model, cfg.kv_lora_rank + cfg.qk_rope_head_dim),
                         dtype=dtype, device=device)
    p["kv_norm"] = torch.ones(lead + (cfg.kv_lora_rank,), dtype=dtype, device=dev)
    p["kv_up"] = param(gen, lead + (cfg.kv_lora_rank,
                                    cfg.n_heads * (cfg.qk_nope_head_dim + cfg.v_head_dim)),
                       dtype=dtype, device=device)
    p["wo"] = param(gen, lead + (cfg.n_heads * cfg.v_head_dim, cfg.d_model), dtype=dtype, device=device)
    return p


# ---------------------------------------------------------------------------
# masks
# ---------------------------------------------------------------------------


def _mask(q_pos, kv_pos, *, window: int, bidirectional: bool) -> torch.Tensor:
    """(..., Sq, Skv) boolean validity; ``window`` 0 means unlimited."""
    d = q_pos[..., :, None] - kv_pos[..., None, :]
    m = torch.ones(d.shape, dtype=torch.bool, device=d.device) if bidirectional else d >= 0
    if window > 0:
        m = m & (d < window)
    return m


# ---------------------------------------------------------------------------
# chunked (flash-style) attention
# ---------------------------------------------------------------------------


def _div(s: int, c: int) -> int:
    """The largest divisor of s that is ≤ c."""
    c = min(c, s)
    while s % c:
        c -= 1
    return c


def chunked_attention(
    q: torch.Tensor,  # (B, Sq, Hkv, G, Dh)
    k: torch.Tensor,  # (B, Skv, Hkv, Dh)
    v: torch.Tensor,  # (B, Skv, Hkv, Dv)
    q_pos: torch.Tensor,  # (Sq,) int
    kv_pos: torch.Tensor,  # (Skv,) int
    *,
    scale: float,
    window: int,  # 0 = none
    softcap: Optional[float] = None,
    bidirectional: bool = False,
    q_chunk: int = 1024,
    kv_chunk: int = 1024,
) -> torch.Tensor:
    b, sq, hkv, g, dh = q.shape
    skv = k.shape[1]
    dv = v.shape[-1]  # may differ from dh (MLA: v_head_dim != qk dim)
    q_chunk = _div(sq, q_chunk)
    kv_chunk = _div(skv, kv_chunk)
    qf, kf, vf = q.to(torch.float32), k.to(torch.float32), v.to(torch.float32)
    outs = []
    for q0 in range(0, sq, q_chunk):
        q_i, qp_i = qf[:, q0:q0 + q_chunk], q_pos[q0:q0 + q_chunk]
        m_run = torch.full((b, hkv, g, q_chunk), NEG_INF, dtype=torch.float32, device=q.device)
        l_run = torch.zeros((b, hkv, g, q_chunk), dtype=torch.float32, device=q.device)
        acc = torch.zeros((b, hkv, g, q_chunk, dv), dtype=torch.float32, device=q.device)
        for k0 in range(0, skv, kv_chunk):
            k_j, v_j = kf[:, k0:k0 + kv_chunk], vf[:, k0:k0 + kv_chunk]
            s = local_einsum("bqhgd,bkhd->bhgqk", q_i, k_j) * scale
            s = softcap_fn(s, softcap)
            valid = _mask(qp_i, kv_pos[k0:k0 + kv_chunk], window=window, bidirectional=bidirectional)
            s = torch.where(valid[None, None, None], s, NEG_INF)
            m_new = torch.maximum(m_run, s.amax(dim=-1))
            corr = torch.exp(m_run - m_new)
            p = torch.exp(s - m_new[..., None])
            l_run = l_run * corr + p.sum(dim=-1)
            pv = local_einsum("bhgqk,bkhd->bhgqd", p, v_j)
            acc = acc * corr[..., None] + pv
            m_run = m_new
        out = acc / torch.clamp_min(l_run, 1e-30)[..., None]  # (B,Hkv,G,qc,Dv)
        outs.append(out.permute(0, 3, 1, 2, 4))  # (B,qc,Hkv,G,Dv)
    return torch.cat(outs, dim=1).to(q.dtype)


def decode_attention(
    q: torch.Tensor,  # (B, 1, Hkv, G, Dh)
    k: torch.Tensor,  # (B, T, Hkv, Dh)
    v: torch.Tensor,
    cur_pos: torch.Tensor,  # (B,) int — position of the new token
    kv_pos: torch.Tensor,  # (T,) or (B, T)
    *,
    scale: float,
    window: int,
    softcap: Optional[float] = None,
) -> torch.Tensor:
    s = local_einsum("bqhgd,bkhd->bhgqk", q.to(torch.float32), k.to(torch.float32)) * scale
    s = softcap_fn(s, softcap)
    kv_pos_b = (kv_pos if kv_pos.ndim == 2 else kv_pos[None, :]).expand(q.shape[0], k.shape[1])
    d = cur_pos[:, None] - kv_pos_b  # (B, T)
    valid = (d >= 0) & (kv_pos_b >= 0)
    if window > 0:
        valid = valid & (d < window)
    s = torch.where(valid[:, None, None, None, :], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    out = local_einsum("bhgqk,bkhd->bqhgd", p, v.to(torch.float32))
    return out.to(q.dtype)


# ---------------------------------------------------------------------------
# KV cache (bf16 | int8 per the paper's symmetric scheme)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class KVCacheSpec:
    batch: int
    max_len: int
    n_kv_heads: int
    head_dim: int
    dtype: str  # "bf16" | "int8"


def init_kv_cache(spec: KVCacheSpec, device=None, lead=()) -> dict:
    """One cache, or ``lead`` stacked ones (layers, groups), on ``device``."""
    shape = tuple(lead) + (spec.batch, spec.max_len, spec.n_kv_heads, spec.head_dim)
    scales = tuple(lead) + (spec.batch, spec.n_kv_heads)
    if spec.dtype == "int8":
        return {
            "k": torch.zeros(shape, dtype=torch.int8, device=device),
            "v": torch.zeros(shape, dtype=torch.int8, device=device),
            "k_scale": torch.ones(scales, dtype=torch.float32, device=device),
            "v_scale": torch.ones(scales, dtype=torch.float32, device=device),
        }
    return {"k": torch.zeros(shape, dtype=torch.bfloat16, device=device),
            "v": torch.zeros(shape, dtype=torch.bfloat16, device=device)}


def _quantize_kv(x: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """Symmetric int8 quantization of (B, S, H, D) with per-(B, H) scales —
    round half to even + saturate, the paper's QuantizeLinear semantics."""
    q = torch.round(x.to(torch.float32) / scale[:, None, :, None])
    return torch.clamp(q, -128, 127).to(torch.int8)


def _write_rows(buf: torch.Tensor, val: torch.Tensor) -> torch.Tensor:
    """A copy of ``buf`` with ``val`` written at positions [0, S) of axis 1,
    as one select between ``buf`` and ``val`` padded to ``buf``'s length.
    A store into a slice of a DTensor sharded along axis 1 (a cache laid
    out over ``seq_shard``) writes the wrong rows without an error; the
    select keeps each rank's rows, and is exact on any tensor."""
    s, t = val.shape[1], buf.shape[1]
    padded = pad_as(val, buf, (0, 0) * (buf.ndim - 2) + (0, t - s))
    old = torch.arange(t, device=buf.device) >= s
    return torch.where(old.reshape((t,) + (1,) * (buf.ndim - 2)), buf, padded)


def _write_at(buf: torch.Tensor, val: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
    """A copy of ``buf`` (B, T, ...) with each row b's one-token ``val[b, 0]``
    written at position ``pos[b]``, as one select over the rows (a pointwise
    op, so a cache laid out over a mesh keeps its layout; an indexed store
    has no DTensor rule on sharded rows).  Positions clamp into [0, T), as
    ``lax.dynamic_update_slice`` clamps its start index."""
    t = buf.shape[1]
    hit = torch.arange(t, device=buf.device) == pos.long().clamp(0, t - 1)[:, None]  # (B, T)
    return torch.where(hit.reshape(hit.shape + (1,) * (buf.ndim - 2)), val.to(buf.dtype), buf)


def write_prefill_kv(cache: dict, k: torch.Tensor, v: torch.Tensor) -> dict:
    """Write a full prefill of K/V at positions [0, S)."""
    if "k_scale" in cache:
        k_scale = div127(k.to(torch.float32).abs().amax(dim=(1, 3))) + 1e-8
        v_scale = div127(v.to(torch.float32).abs().amax(dim=(1, 3))) + 1e-8
        return {
            "k": _write_rows(cache["k"], _quantize_kv(k, k_scale)),
            "v": _write_rows(cache["v"], _quantize_kv(v, v_scale)),
            "k_scale": k_scale,
            "v_scale": v_scale,
        }
    return {"k": _write_rows(cache["k"], k.to(cache["k"].dtype)),
            "v": _write_rows(cache["v"], v.to(cache["v"].dtype))}


def write_decode_kv(cache: dict, k: torch.Tensor, v: torch.Tensor, pos: torch.Tensor) -> dict:
    """Insert one token's K/V at per-batch position ``pos`` (B,)."""
    out = dict(cache)
    if "k_scale" in cache:
        k, v = _quantize_kv(k, cache["k_scale"]), _quantize_kv(v, cache["v_scale"])
    out["k"] = _write_at(cache["k"], k.to(cache["k"].dtype), pos)
    out["v"] = _write_at(cache["v"], v.to(cache["v"].dtype), pos)
    return out


def read_kv(cache: dict) -> Tuple[torch.Tensor, torch.Tensor]:
    if "k_scale" in cache:
        k = cache["k"].to(torch.float32) * cache["k_scale"][:, None, :, None]
        v = cache["v"].to(torch.float32) * cache["v_scale"][:, None, :, None]
        return k.to(torch.bfloat16), v.to(torch.bfloat16)
    return cache["k"], cache["v"]


# ---------------------------------------------------------------------------
# full attention blocks
# ---------------------------------------------------------------------------


def _split_heads(x, n_heads, hd):
    return split_last(x, n_heads, hd)


def gqa_attention(
    p: dict,
    x: torch.Tensor,  # (B, S, d)
    pos: torch.Tensor,  # (S,) for train/prefill, (B,) current positions for decode
    cfg: ModelConfig,
    *,
    window: int,  # 0 = none
    cache: Optional[dict] = None,
    mode: str = "train",  # train | prefill | decode
    bidirectional: bool = False,
    q_chunk: int = 1024,
    kv_chunk: int = 1024,
) -> Tuple[torch.Tensor, Optional[dict]]:
    b, s, _ = x.shape
    hd = cfg.hd()
    hkv = cfg.n_kv_heads
    g = cfg.n_heads // hkv
    q = _split_heads(linear(x, p["wq"]), cfg.n_heads, hd)  # (B,S,H,Dh)
    k = _split_heads(linear(x, p["wk"]), hkv, hd)
    v = _split_heads(linear(x, p["wv"]), hkv, hd)
    if cfg.qk_norm:
        q = rmsnorm(q, p["q_norm"], eps=cfg.norm_eps)
        k = rmsnorm(k, p["k_norm"], eps=cfg.norm_eps)
    rope_pos = (pos[None, :] if mode != "decode" else pos[:, None]).expand(b, s)
    q = apply_rope(q, rope_pos, cfg.rope_theta)
    k = apply_rope(k, rope_pos, cfg.rope_theta)
    q = shard(unshard_for_split(q, 2, hkv).reshape(b, s, hkv, g, hd), "batch", None, "kv_heads_act", None, None)
    k = shard(k, "batch", None, "kv_heads_act", None)
    v = shard(v, "batch", None, "kv_heads_act", None)
    scale = hd**-0.5

    new_cache = None
    if mode == "decode":
        assert cache is not None
        t_cache = cache["k"].shape[1]
        if cfg.attn_type == "swa" and cfg.window and t_cache <= cfg.window:
            # ring buffer: the cache holds only the last `window` tokens.  Slot
            # i stores position p_i = pos − ((pos − i) mod T); slots never
            # written yet resolve to p_i < 0 and are masked out.
            new_cache = write_decode_kv(cache, k, v, torch.remainder(pos, t_cache))
            idx = torch.arange(t_cache, dtype=pos.dtype, device=pos.device)
            kv_pos = pos[:, None] - torch.remainder(pos[:, None] - idx[None, :], t_cache)
        else:
            new_cache = write_decode_kv(cache, k, v, pos)
            kv_pos = torch.arange(t_cache, dtype=pos.dtype, device=pos.device)
        kf, vf = read_kv(new_cache)
        out = decode_attention(q, kf, vf, pos, kv_pos, scale=scale, window=window,
                               softcap=cfg.attn_softcap)
    else:
        if cache is not None:
            t_cache = cache["k"].shape[1]
            if s > t_cache:
                # SWA ring cache shorter than the prompt: only the last
                # `window` tokens matter for future decode.  Position p lives
                # in slot p mod W ⇒ roll the tail slice into ring order.
                shift = (s - t_cache) % t_cache
                k_w = torch.roll(k[:, s - t_cache:], shift, dims=1)
                v_w = torch.roll(v[:, s - t_cache:], shift, dims=1)
                new_cache = write_prefill_kv(cache, k_w, v_w)
            else:
                new_cache = write_prefill_kv(cache, k, v)
        out = chunked_attention(
            q, k, v, pos, pos,
            scale=scale, window=window, softcap=cfg.attn_softcap,
            bidirectional=bidirectional, q_chunk=q_chunk, kv_chunk=kv_chunk,
        )
    # the gradient of the merged heads splits into (Hkv, G) again
    out = unshard_grad_for_split(out.reshape(b, s, cfg.n_heads * hd), -1, hkv)
    return linear(out, p["wo"]), new_cache


def cross_attention(
    p: dict,
    x: torch.Tensor,  # (B, S, d) decoder side
    enc_kv: Tuple[torch.Tensor, torch.Tensor],  # precomputed (B, T, Hkv, Dh) k, v
    cfg: ModelConfig,
) -> torch.Tensor:
    b, s, _ = x.shape
    hd = cfg.hd()
    hkv = cfg.n_kv_heads
    g = cfg.n_heads // hkv
    q = unshard_for_split(_split_heads(linear(x, p["wq"]), cfg.n_heads, hd), 2, hkv).reshape(b, s, hkv, g, hd)
    k, v = enc_kv
    t = k.shape[1]
    out = chunked_attention(
        q, k, v,
        torch.arange(s, device=x.device), torch.arange(t, device=x.device),
        scale=hd**-0.5, window=0, bidirectional=True,
        q_chunk=min(1024, s), kv_chunk=min(1024, t),
    )
    return linear(unshard_grad_for_split(out.reshape(b, s, cfg.n_heads * hd), -1, hkv), p["wo"])


def encdec_cross_kv(p: dict, enc_out: torch.Tensor, cfg: ModelConfig):
    hd = cfg.hd()
    k = _split_heads(linear(enc_out, p["wk"]), cfg.n_kv_heads, hd)
    v = _split_heads(linear(enc_out, p["wv"]), cfg.n_kv_heads, hd)
    return k, v


# ---------------------------------------------------------------------------
# MLA (multi-head latent attention, minicpm3/deepseek style)
# ---------------------------------------------------------------------------


def init_mla_cache(batch: int, max_len: int, cfg: ModelConfig, dtype: str = "bf16",
                   device=None, lead=()) -> dict:
    lead = tuple(lead)
    ckv = lead + (batch, max_len, cfg.kv_lora_rank)
    k_pe = torch.zeros(lead + (batch, max_len, cfg.qk_rope_head_dim), dtype=torch.bfloat16,
                       device=device)
    if dtype == "int8":
        return {"ckv": torch.zeros(ckv, dtype=torch.int8, device=device),
                "ckv_scale": torch.ones(lead + (batch,), dtype=torch.float32, device=device),
                "k_pe": k_pe}
    return {"ckv": torch.zeros(ckv, dtype=torch.bfloat16, device=device), "k_pe": k_pe}


def _quantize_ckv(ckv: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    q = torch.round(ckv.to(torch.float32) / scale[:, None, None])
    return torch.clamp(q, -128, 127).to(torch.int8)


def mla_attention(
    p: dict,
    x: torch.Tensor,
    pos: torch.Tensor,
    cfg: ModelConfig,
    *,
    cache: Optional[dict] = None,
    mode: str = "train",
    q_chunk: int = 1024,
    kv_chunk: int = 1024,
) -> Tuple[torch.Tensor, Optional[dict]]:
    """MLA with the compressed-latent KV cache (quantizing the latent is the
    paper's scheme applied to it)."""
    b, s, _ = x.shape
    nh = cfg.n_heads
    dn, dr, dv = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim, cfg.v_head_dim

    cq = rmsnorm(linear(x, p["q_down"]), p["q_norm"], eps=cfg.norm_eps)
    q = _split_heads(linear(cq, p["q_up"]), nh, dn + dr)
    q_nope, q_pe = q[..., :dn], q[..., dn:]

    ckv_full = linear(x, p["kv_down"])  # (B,S,rank+dr)
    ckv, k_pe = ckv_full[..., : cfg.kv_lora_rank], ckv_full[..., cfg.kv_lora_rank:]
    ckv = rmsnorm(ckv, p["kv_norm"], eps=cfg.norm_eps)

    rope_pos = (pos[None, :] if mode != "decode" else pos[:, None]).expand(b, s)
    q_pe = apply_rope(q_pe, rope_pos, cfg.rope_theta)
    k_pe = apply_rope(k_pe[:, :, None, :], rope_pos, cfg.rope_theta)[:, :, 0, :]

    new_cache = None
    if mode == "decode":
        assert cache is not None
        new_cache = dict(cache)
        if "ckv_scale" in cache:
            ckv_q = _quantize_ckv(ckv, cache["ckv_scale"])
        else:
            ckv_q = ckv.to(cache["ckv"].dtype)
        new_cache["ckv"] = _write_at(cache["ckv"], ckv_q, pos)
        new_cache["k_pe"] = _write_at(cache["k_pe"], k_pe.to(cache["k_pe"].dtype), pos)
        ckv_all = new_cache["ckv"].to(torch.float32)
        if "ckv_scale" in cache:
            ckv_all = ckv_all * cache["ckv_scale"][:, None, None]
        k_pe_all = new_cache["k_pe"]
        t = ckv_all.shape[1]
    else:
        if cache is not None:
            new_cache = dict(cache)
            if "ckv_scale" in cache:
                sc = div127(ckv.to(torch.float32).abs().amax(dim=(1, 2))) + 1e-8
                ckv_q = _quantize_ckv(ckv, sc)
                new_cache["ckv_scale"] = sc
            else:
                ckv_q = ckv.to(cache["ckv"].dtype)
            new_cache["ckv"] = _write_rows(cache["ckv"], ckv_q)
            new_cache["k_pe"] = _write_rows(cache["k_pe"], k_pe.to(cache["k_pe"].dtype))
        ckv_all, k_pe_all, t = ckv, k_pe, s

    # up-project latents to per-head K (nope) and V
    kv = _split_heads(linear(ckv_all.to(x.dtype), p["kv_up"]), nh, dn + dv)
    k_nope, v = kv[..., :dn], kv[..., dn:]
    k = torch.cat([k_nope, k_pe_all[:, :, None, :].to(x.dtype).expand(b, t, nh, dr)], dim=-1)
    qh = torch.cat([q_nope, q_pe], dim=-1).reshape(b, s, nh, 1, dn + dr)
    scale = (dn + dr) ** -0.5
    if mode == "decode":
        kv_pos = torch.arange(t, dtype=pos.dtype, device=pos.device)
        out = decode_attention(qh, k, v, pos, kv_pos, scale=scale, window=0)
    else:
        out = chunked_attention(qh, k, v, pos, pos, scale=scale, window=0,
                                q_chunk=q_chunk, kv_chunk=kv_chunk)
    # heads may arrive split unevenly (40 over 16); DTensor merges only even splits
    out = unshard_grad_for_split(unshard_for_split(out, 2, nh).reshape(b, s, nh * dv), -1, nh)
    return linear(out, p["wo"]), new_cache

