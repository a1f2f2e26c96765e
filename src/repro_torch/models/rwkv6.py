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

Prefill runs the recurrence over time in rematerialized chunks of 128
steps, each in sub-chunks in matmul form (:func:`_wkv_scan`), with a
(B, H, D, D) f32 state carried between them; decode is a chunk of one step.
"""
from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

from ..configs.base import ModelConfig
from ..distributed.sharding import local_einsum, shard, split_last, unshard_grad_for_split
from .layers import einsum, linear, matmul, param, remat_chunk, rmsnorm


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


#: Steps of one WKV sub-chunk: within it the recurrence is one pairwise
#: (C, C, D) decay tensor a head and three matmuls; 128 / 32 sub-chunks make
#: a rematerialization chunk.
WKV_SUB = 32
#: Floor of the log-decay in the cumulative sums.  Below −104 float32 ``w``
#: is already 0, and every difference that holds such a step lies below it,
#: so the floor changes no float32 value; it keeps −inf (``time_decay + dd``
#: over 88.7) and near-overflow decays out of the sums, where they would
#: make the later differences NaN or swallow them in rounding.
LW_FLOOR = -1e4


def _wkv_sub(r, k, v, lw, u, st):
    """One sub-chunk of C steps in matmul form.  r, k, v, lw: (B,C,H,D) f32,
    ``lw`` the log-decay (≤ 0); u: (H,D); st: (B,H,D,D).  With L the
    inclusive and Lx the exclusive cumulative log-decay over the sub-chunk:

        A[t,s] = Σ_d r_t·k_s·exp(Lx_t − L_s)   (s < t),  A[t,t] = Σ_d r_t·u·k_t
        y      = A·v + (r ⊙ exp(Lx))·S_in
        S_out  = exp(L_last) ⊙ S_in + Σ_s (k_s ⊙ exp(L_last − L_s))·v_sᵀ

    Every exponent is a difference of cumulative sums that is ≤ 0; the
    masked pairs enter ``exp`` as −inf.  Never ``exp(Lx_t)·exp(−L_s)``: that
    product overflows float32 at realistic decays.  The sums and their
    differences are taken in float64 and rounded once: in float32 a large
    decay early in the sub-chunk would leave its rounding error in every
    later difference.  The rest is float32.  A one-step sub-chunk, as at
    decode, has Lx = 0 and L_last − L_s = 0 and no pairs: it is the
    per-step recurrence, with the same values."""
    diag = (r * u * k).sum(-1, keepdim=True)  # (B,C,H,1)
    if r.shape[1] == 1:
        y = local_einsum("bthk,bhkv->bthv", r, st) + diag * v
        st = torch.exp(lw[:, 0])[..., None] * st + local_einsum("bshk,bshv->bhkv", k, v)
        return y, st
    c = r.shape[1]
    f32 = torch.float32
    ll = torch.cumsum(torch.clamp_min(lw.to(torch.float64), LW_FLOOR), dim=1)
    lx = torch.cat([torch.zeros_like(ll[:, :1]), ll[:, :-1]], dim=1)  # L_{t-1}: exact at s = t - 1
    y = local_einsum("bthk,bhkv->bthv", r * torch.exp(lx.to(f32)), st) + diag * v
    below = torch.ones((c, c), dtype=torch.bool, device=r.device).tril(-1)[None, :, :, None, None]
    diff = torch.where(below, lx[:, :, None] - ll[:, None], float("-inf"))  # (B,C,C,H,D)
    a = (r[:, :, None] * k[:, None] * torch.exp(diff.to(f32))).sum(-1)  # (B,C,C,H)
    y = y + local_einsum("btsh,bshv->bthv", a, v)
    last = ll[:, -1]  # (B,H,D)
    st = (torch.exp(last.to(f32))[..., None] * st
          + local_einsum("bshk,bshv->bhkv", k * torch.exp((last[:, None] - ll).to(f32)), v))
    return y, st


def _wkv_chunk(r, k, v, lw, u, st):
    """One rematerialization chunk: its sub-chunks of WKV_SUB steps in order
    (the last one ragged when the chunk is not a multiple)."""
    ys = []
    for c0 in range(0, r.shape[1], WKV_SUB):
        sl = slice(c0, c0 + WKV_SUB)
        y, st = _wkv_sub(r[:, sl], k[:, sl], v[:, sl], lw[:, sl], u, st)
        ys.append(y)
    return torch.cat(ys, dim=1), st


def _check_chunk(s: int, chunk: int) -> int:
    chunk = min(chunk, s)
    if s % chunk:
        raise ValueError(f"sequence length {s} is not a multiple of the WKV chunk {chunk}")
    return chunk


def _wkv_scan(r, k, v, lw, u, state, *, chunk: int = 128):
    """Chunked WKV6.  r,k,v: (B,S,H,D); lw: (B,S,H,D) log-decay, ``log w``;
    u: (H,D); state: (B,H,D,D) f32.  Returns y (B,S,H,D) f32, new state.

    ``repro``'s recurrence in another order: time runs in chunks of
    ``chunk`` steps, each rematerialized (the backward stores only the
    chunk-boundary states, as ``repro``'s ``jax.checkpoint`` does), and each
    chunk in sub-chunks of :data:`WKV_SUB` steps in matmul form
    (:func:`_wkv_sub`).  Decode (S = 1) is one sub-chunk of one step."""
    chunk = _check_chunk(r.shape[1], chunk)
    # on a mesh: batch over data, heads over model where they divide it
    r, k, v, lw = (shard(a.to(torch.float32), "batch", None, "heads_act", None) for a in (r, k, v, lw))
    st, ys = shard(state, "batch", "heads_act", None, None), []
    for c0 in range(0, r.shape[1], chunk):
        sl = slice(c0, c0 + chunk)
        y, st = remat_chunk(_wkv_chunk, r[:, sl], k[:, sl], v[:, sl], lw[:, sl], u, st)
        ys.append(y)
    return torch.cat(ys, dim=1), st


def wkv_scan_plain(r, k, v, lw, u, state, *, chunk: int = 128):
    """The plain version of :func:`_wkv_scan`: ``repro``'s recurrence one
    step at a time, ``w = exp(lw)``, nothing rematerialized.  The tests and
    ``chip_smoke.py`` hold the chunked form against it."""
    _check_chunk(r.shape[1], chunk)
    r, k, v, lw = (a.to(torch.float32) for a in (r, k, v, lw))
    w = torch.exp(lw)
    st, ys = state, []
    for t in range(r.shape[1]):
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

    # data-dependent decay (the Finch contribution), as its log: float32
    # w = exp(-exp(x)) underflows to 0 where log w is still finite
    dd = matmul(torch.tanh(matmul(xw, p["td_w1"])), p["td_w2"])
    lw = -torch.exp((p["time_decay"] + dd).to(torch.float32))  # (B,S,d) log w, < 0

    r = split_last(linear(xr, p["wr"]), nh, hd)
    k = split_last(linear(xk, p["wk"]), nh, hd)
    v = split_last(linear(xv, p["wv"]), nh, hd)
    g = F.silu(linear(xg, p["wg"]))
    lwh = split_last(lw, nh, hd)

    y, wkv_new = _wkv_scan(r, k, v, lwh, p["time_faaaa"].to(torch.float32), state["wkv"])

    # per-head group norm then gate
    y = y.reshape(b, s, nh, hd)
    mu = y.mean(-1, keepdim=True)
    var = ((y - mu) ** 2).mean(-1, keepdim=True)
    y = (y - mu) * torch.rsqrt(var + 64e-5)
    # merge the heads; on a mesh the gradient splits them again, and 40
    # heads over a 16-way axis must be whole for that
    y = unshard_grad_for_split(y.reshape(b, s, d), -1, nh) * p["ln_x"].to(torch.float32)
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
