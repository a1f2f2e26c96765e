"""RWKV6 ("Finch") — attention-free recurrent LM block with data-dependent
decay (arXiv:2404.05892), as in ``repro.models.rwkv6``.

Per layer: a time-mix block (WKV6 recurrence) and a channel-mix block.  The
per-channel, *data-dependent* decay ``w_t`` uses the paper's LoRA
parameterization:

    w_t = exp(-exp(time_decay + tanh(x_w @ A_w) @ B_w))

WKV6 recurrence per head (D = head dim), with bonus ``u`` for the current
token:

    y_t = r_t · (diag(u)·k_t·v_tᵀ + S_t)
    S_{t+1} = diag(w_t)·S_t + k_t·v_tᵀ

Prefill runs the recurrence over time, chunk by chunk, with a (B, H, D, D)
f32 state; decode is a single step.
"""
from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

from ..configs.base import ModelConfig
from ..distributed.sharding import split_last
from .layers import einsum, linear, matmul, param, rmsnorm


def init_rwkv6_layer(gen, cfg: ModelConfig, dtype=torch.float32, device=None, lead=()) -> dict:
    d = cfg.d_model
    ssm = cfg.ssm
    hd = ssm.head_dim
    nh = d // hd
    r = ssm.lora_rank
    lead = tuple(lead)

    def prm(shape, scale=0.02):
        return param(gen, lead + shape, scale, dtype, device)

    p = {
        # time-mix (WKV6)
        "tm_maa_x": prm((d,), 0.1),
        "tm_maa": prm((5, d), 0.1),  # per-target baseline mus
        "tm_maa_w1": prm((d, 5 * r)),
        "tm_maa_w2": prm((5, r, d)),
        "time_decay": prm((d,), 0.5),
        "td_w1": prm((d, r)),
        "td_w2": prm((r, d)),
        "time_faaaa": prm((nh, hd), 0.5),  # bonus u
        "wr": prm((d, d)),
        "wk": prm((d, d)),
        "wv": prm((d, d)),
        "wg": prm((d, d)),
        "wo": prm((d, d)),
        # channel-mix
        "cm_maa_k": prm((d,), 0.1),
        "cm_maa_r": prm((d,), 0.1),
        "cm_wk": prm((d, cfg.d_ff)),
        "cm_wv": prm((cfg.d_ff, d)),
        "cm_wr": prm((d, d)),
    }
    p["ln_x"] = torch.ones(lead + (d,), dtype=dtype, device=p["wr"].device)  # group norm scale
    return p


def init_rwkv6_state(batch: int, cfg: ModelConfig, device=None, lead=()) -> dict:
    d = cfg.d_model
    hd = cfg.ssm.head_dim
    nh = d // hd
    lead = tuple(lead)
    return {
        "tm_shift": torch.zeros(lead + (batch, d), dtype=torch.bfloat16, device=device),
        "cm_shift": torch.zeros(lead + (batch, d), dtype=torch.bfloat16, device=device),
        "wkv": torch.zeros(lead + (batch, nh, hd, hd), dtype=torch.float32, device=device),
    }


def _ddlerp(p: dict, x: torch.Tensor, xx: torch.Tensor):
    """Finch data-dependent token-shift interpolation for the 5 targets."""
    base = x + (xx - x) * p["tm_maa_x"]
    lora = torch.tanh(matmul(base, p["tm_maa_w1"]))  # (B,S,5r)
    lora = split_last(lora, 5, -1)  # (B,S,5,r)
    deltas = einsum("bsfr,frd->bsfd", lora, p["tm_maa_w2"])  # (B,S,5,d)
    outs = []
    for i in range(5):
        mu = p["tm_maa"][i] + deltas[..., i, :]
        outs.append(x + (xx - x) * mu)
    return outs  # w, k, v, r, g


def _wkv_scan(r, k, v, w, u, state, *, chunk: int = 128):
    """Sequential WKV6.  r,k,v: (B,S,H,D); w: (B,S,H,D) decay in (0,1);
    u: (H,D); state: (B,H,D,D) f32.  Returns y (B,S,H,D) f32, new state.
    Time runs in chunks of ``chunk`` steps (``repro``'s rematerialization
    unit), each step in order."""
    b, s, nh, hd = r.shape
    chunk = min(chunk, s)
    if s % chunk:
        raise ValueError(f"sequence length {s} is not a multiple of the WKV chunk {chunk}")
    r, k, v, w = (a.to(torch.float32) for a in (r, k, v, w))
    st = state
    ys = []
    for c0 in range(0, s, chunk):
        for t in range(c0, c0 + chunk):
            kv = torch.einsum("bhk,bhv->bhkv", k[:, t], v[:, t])  # (B,H,D,D)
            ys.append(torch.einsum("bhk,bhkv->bhv", r[:, t], u[None, :, :, None] * kv + st))
            st = w[:, t][..., None] * st + kv
    return torch.stack(ys, dim=1), st  # (B,S,H,D)


def rwkv6_time_mix(p: dict, x: torch.Tensor, state: dict, cfg: ModelConfig) -> Tuple[torch.Tensor, dict]:
    b, s, d = x.shape
    hd = cfg.ssm.head_dim
    nh = d // hd
    # token shift: previous token (state carries the last token across calls)
    prev = torch.cat([state["tm_shift"][:, None, :].to(x.dtype), x[:, :-1]], dim=1)
    xw, xk, xv, xr, xg = _ddlerp(p, x, prev)

    # data-dependent decay (the Finch contribution)
    dd = matmul(torch.tanh(matmul(xw, p["td_w1"])), p["td_w2"])
    w = torch.exp(-torch.exp((p["time_decay"] + dd).to(torch.float32)))  # (B,S,d) in (0,1)

    r = split_last(linear(xr, p["wr"]), nh, hd)
    k = split_last(linear(xk, p["wk"]), nh, hd)
    v = split_last(linear(xv, p["wv"]), nh, hd)
    g = F.silu(linear(xg, p["wg"]))
    wh = split_last(w, nh, hd)

    y, wkv_new = _wkv_scan(r, k, v, wh, p["time_faaaa"].to(torch.float32), state["wkv"])

    # per-head group norm then gate
    y = y.reshape(b, s, nh, hd)
    mu = y.mean(-1, keepdim=True)
    var = ((y - mu) ** 2).mean(-1, keepdim=True)
    y = ((y - mu) * torch.rsqrt(var + 64e-5)).reshape(b, s, d) * p["ln_x"].to(torch.float32)
    out = linear(y.to(x.dtype) * g, p["wo"])
    new_state = {**state, "tm_shift": x[:, -1].to(torch.bfloat16), "wkv": wkv_new}
    return out, new_state


def rwkv6_channel_mix(p: dict, x: torch.Tensor, state: dict) -> Tuple[torch.Tensor, dict]:
    prev = torch.cat([state["cm_shift"][:, None, :].to(x.dtype), x[:, :-1]], dim=1)
    xk = x + (prev - x) * p["cm_maa_k"]
    xr = x + (prev - x) * p["cm_maa_r"]
    k = torch.square(torch.relu(linear(xk, p["cm_wk"])))
    kv = linear(k, p["cm_wv"])
    out = torch.sigmoid(linear(xr, p["cm_wr"])) * kv
    return out, {**state, "cm_shift": x[:, -1].to(torch.bfloat16)}


def rwkv6_block(p: dict, x: torch.Tensor, state: dict, cfg: ModelConfig,
                norms: dict) -> Tuple[torch.Tensor, dict]:
    """Pre-norm residual block: time-mix then channel-mix."""
    h, state = rwkv6_time_mix(p, rmsnorm(x, norms["ln1"], eps=cfg.norm_eps), state, cfg)
    x = x + h
    h, state = rwkv6_channel_mix(p, rmsnorm(x, norms["ln2"], eps=cfg.norm_eps), state)
    return x + h, state
