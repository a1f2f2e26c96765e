"""Mamba2 (SSD) block — used by the zamba2-7b hybrid (arXiv:2411.15242), as in
``repro.models.mamba2``.

The chunked State-Space-Dual algorithm (Dao & Gu 2024): within a chunk the
recurrence is computed as masked-decay attention (matmuls); across chunks a
(B, H, P, N) state is carried, chunk by chunk, each chunk rematerialized.  Decode is the O(1)
single-step recurrence.

    h_t = exp(dt_t·A) h_{t-1} + dt_t · x_t ⊗ B_t
    y_t = C_t · h_t + D · x_t
"""
from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

from ..configs.base import ModelConfig
from .layers import linear, param, remat_chunk, rmsnorm


def _dims(cfg: ModelConfig):
    ssm = cfg.ssm
    d_inner = ssm.expand * cfg.d_model
    n_heads = d_inner // ssm.head_dim
    conv_dim = d_inner + 2 * ssm.d_state
    return d_inner, n_heads, conv_dim


def init_mamba2_layer(gen, cfg: ModelConfig, dtype=torch.float32, device=None, lead=()) -> dict:
    ssm = cfg.ssm
    d_inner, n_heads, conv_dim = _dims(cfg)
    lead = tuple(lead)
    p = {
        "in_proj": param(gen, lead + (cfg.d_model, 2 * d_inner + 2 * ssm.d_state + n_heads),
                         dtype=dtype, device=device),
        "conv_w": param(gen, lead + (ssm.d_conv, conv_dim), 0.2, dtype, device),
        "out_proj": param(gen, lead + (d_inner, cfg.d_model), dtype=dtype, device=device),
    }
    dev = p["in_proj"].device
    p["conv_b"] = torch.zeros(lead + (conv_dim,), dtype=dtype, device=dev)
    p["A_log"] = torch.zeros(lead + (n_heads,), dtype=torch.float32, device=dev)
    p["dt_bias"] = torch.zeros(lead + (n_heads,), dtype=torch.float32, device=dev)
    p["D"] = torch.ones(lead + (n_heads,), dtype=torch.float32, device=dev)
    p["gate_norm"] = torch.ones(lead + (d_inner,), dtype=dtype, device=dev)
    return p


def init_mamba2_state(batch: int, cfg: ModelConfig, device=None, lead=()) -> dict:
    ssm = cfg.ssm
    d_inner, n_heads, conv_dim = _dims(cfg)
    lead = tuple(lead)
    return {
        "conv": torch.zeros(lead + (batch, ssm.d_conv - 1, conv_dim), dtype=torch.bfloat16,
                            device=device),
        "ssd": torch.zeros(lead + (batch, n_heads, ssm.head_dim, ssm.d_state), dtype=torch.float32,
                           device=device),
    }


def _causal_conv(xbc: torch.Tensor, w: torch.Tensor, b: torch.Tensor, prev: torch.Tensor):
    """Depthwise causal conv1d, width K: (B,S,C) with (B,K-1,C) history."""
    k = w.shape[0]
    full = torch.cat([prev.to(xbc.dtype), xbc], dim=1)  # (B, S+K-1, C)
    out = sum(full[:, i: i + xbc.shape[1]] * w[i] for i in range(k)) + b
    new_prev = full[:, -(k - 1):] if k > 1 else prev
    return F.silu(out), new_prev.to(torch.bfloat16)


def _ssd_chunk(s_prev, xh, bm, cm, dt, la):
    """One SSD chunk: intra-chunk masked attention + inter-chunk state.
    s_prev (B,H,P,N) f32; xh (B,L,H,P); bm, cm (B,L,N); dt, la (B,L,H)."""
    l_cum = torch.cumsum(la, dim=1)  # (B,L,H) cumulative log-decay
    l_last = l_cum[:, -1]  # (B,H)

    # intra-chunk: att[i,j] = (C_i·B_j)·exp(l_i−l_j)·dt_j  for j ≤ i
    cb = torch.einsum("bin,bjn->bij", cm, bm)  # (B,L,L)
    diff = l_cum[:, :, None, :] - l_cum[:, None, :, :]  # (B,L,L,H) = l_i − l_j
    li = torch.tril(torch.ones((xh.shape[1], xh.shape[1]), dtype=torch.bool, device=xh.device))
    m = torch.where(li[None, :, :, None], torch.exp(diff), 0.0) * dt[:, None, :, :]
    xf = xh.to(torch.float32)
    y_intra = torch.einsum("bijh,bjhp->bihp", cb[..., None] * m, xf)

    # inter-chunk: carry-in state read by C with prefix decay
    y_inter = torch.einsum("bin,bhpn->bihp", cm, s_prev) * torch.exp(l_cum)[..., None]

    # state update: suffix-decayed outer products + fully decayed carry
    w_suffix = torch.exp(l_last[:, None, :] - l_cum) * dt  # (B,L,H)
    s_contrib = torch.einsum("bjh,bjn,bjhp->bhpn", w_suffix, bm, xf)
    s_new = torch.exp(l_last)[:, :, None, None] * s_prev + s_contrib
    return s_new, (y_intra + y_inter).to(xh.dtype)


def _ssd_scan(state, xh, bm, cm, dt, la, *, chunk: int):
    """The SSD over time, chunk by chunk (:func:`_ssd_chunk`), each chunk
    rematerialized: the backward stores only the (B,H,P,N) chunk-boundary
    states, not the (B,L,L,H) intra-chunk decay matrices.  Returns the final
    state and y (B,S,H,P)."""
    s = xh.shape[1]
    chunk = min(chunk, s)
    if s % chunk:
        raise ValueError(f"sequence length {s} is not a multiple of the SSD chunk {chunk}")
    ys = []
    for c0 in range(0, s, chunk):
        sl = slice(c0, c0 + chunk)
        state, y_c = remat_chunk(_ssd_chunk, state, xh[:, sl], bm[:, sl], cm[:, sl], dt[:, sl], la[:, sl])
        ys.append(y_c)
    return state, torch.cat(ys, dim=1)


def mamba2_mix(p: dict, x: torch.Tensor, state: dict, cfg: ModelConfig, *,
               chunk: int = 256) -> Tuple[torch.Tensor, dict]:
    ssm = cfg.ssm
    b, s, _ = x.shape
    d_inner, nh, conv_dim = _dims(cfg)
    pdim, n = ssm.head_dim, ssm.d_state

    zxbcdt = linear(x, p["in_proj"])
    z, xbc, dt = torch.split(zxbcdt, [d_inner, conv_dim, zxbcdt.shape[-1] - d_inner - conv_dim], dim=-1)
    xbc, conv_state = _causal_conv(xbc, p["conv_w"], p["conv_b"], state["conv"])
    xs, bm, cm = torch.split(xbc, [d_inner, n, xbc.shape[-1] - d_inner - n], dim=-1)
    xh = xs.reshape(b, s, nh, pdim)
    dt = F.softplus(dt.to(torch.float32) + p["dt_bias"])  # (B,S,H)
    a = -torch.exp(p["A_log"])  # (H,) negative
    log_decay = dt * a  # (B,S,H)  = log(exp(dt·A))

    if s == 1:  # decode: single recurrence step
        s_prev = state["ssd"]
        kv = torch.einsum("bh,bn,bhp->bhpn", dt[:, 0], bm[:, 0].to(torch.float32),
                          xh[:, 0].to(torch.float32))
        s_new = torch.exp(log_decay[:, 0])[:, :, None, None] * s_prev + kv
        y = torch.einsum("bn,bhpn->bhp", cm[:, 0].to(torch.float32), s_new)[:, None]
        y = y.reshape(b, 1, nh, pdim)
        ssd_state = s_new
    else:
        ssd_state, y = _ssd_scan(state["ssd"], xh, bm.to(torch.float32), cm.to(torch.float32), dt,
                                 log_decay, chunk=chunk)

    y = y + p["D"][None, None, :, None].to(y.dtype) * xh.to(y.dtype)
    y = y.reshape(b, s, d_inner)
    y = rmsnorm(y.to(x.dtype) * F.silu(z), p["gate_norm"], eps=cfg.norm_eps)
    out = linear(y, p["out_proj"])
    return out, {"conv": conv_state, "ssd": ssd_state}


def mamba2_block(p: dict, x: torch.Tensor, state: dict, cfg: ModelConfig,
                 norm_scale: torch.Tensor) -> Tuple[torch.Tensor, dict]:
    h, state = mamba2_mix(p, rmsnorm(x, norm_scale, eps=cfg.norm_eps), state, cfg)
    return x + h, state
