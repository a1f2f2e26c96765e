"""Plain PyTorch reference of the codified transformer block, and the
comparison that decides ``correct`` for ``tokpath-minicpm2b``.

It imports nothing of the program. From the harness's pre-quantized
parameters it computes one causal forward pass per sequence, op for op as
the PQ-IR artifact states them:

* a projection: int8 x · W → int32 (+ bias) → float32 → × quant_scale →
  × 2**-shift [→ ReLU] → round half to even → clip to int8;
* a residual: both codes to float32, add, round, clip;
* attention per head: int8 Q·Kᵀ → float32 × qk_scale → s·mask +
  (mask − 1)·30000 → minus the row max → round(· / 0.125) clipped to int8
  → + 128 → the uint8 exp table (rebuilt here) → p = w / Σw (float32) →
  round(p · 127) → int8 P·V → × 1/127 → round, clip;
* logits: int8 x · lm_head → float32 × lm_scale.

Integer products are summed in float64, which holds them exactly. Nothing
is batched, cached or padded: the sequence is the prompt and the served
tokens, and the causal mask is the plain one.

The comparison: for each sampled request, the widest gap by which a served
token's logit lies below the reference's best at its position, and, for a
request still in its slot, how many of the slot's int8 K/V rows differ from
the reference's. The program is exact, so both limits are 0. The control
is this reference with every int8 activation (the embedding rows,
projections, residuals and attention outputs, so the K/V rows too) rounded
to int4 precision: the nearest step below the configuration's int8.
"""
from __future__ import annotations

import math
from typing import Dict, List, Tuple

import numpy as np
import torch

BIG = 30000.0
LUT_SCALE = 0.125
P_SCALE = 127.0
#: Heads computed together: bounds the (heads, T, T) temporaries.
HEAD_BLOCK = 12
LIMITS = {"token_gap": 0.0, "kv_rows_wrong": 0}


def exp_table(device) -> torch.Tensor:
    """lut[i] = round(exp(min(i - 128, 0) · 0.125) · 255), as uint8."""
    i = np.arange(256, dtype=np.float64)
    vals = np.rint(np.exp(np.minimum(i - 128.0, 0.0) * LUT_SCALE) * 255.0)
    return torch.from_numpy(np.clip(vals, 0, 255).astype(np.uint8)).to(device)


def f32(x: float, device) -> torch.Tensor:
    return torch.tensor(np.float32(x), device=device)


def round_clip(f: torch.Tensor) -> torch.Tensor:
    return torch.round(f).clamp_(-128, 127).to(torch.int8)


def coarsen(x: torch.Tensor, bits: int) -> torch.Tensor:
    """int8 codes rounded to ``bits``-bit precision (the control)."""
    if bits == 8:
        return x
    step = 2 ** (8 - bits)
    lo, hi = -(2 ** (bits - 1)), 2 ** (bits - 1) - 1
    return (torch.round(x.float() / step).clamp_(lo, hi) * step).to(torch.int8)


def project(x, w, b, qs, shift, relu, bits):
    dev = x.device
    acc = x.double() @ w.double() + b.double()
    f = acc.float() * f32(qs, dev)
    f = f * f32(2.0 ** -shift, dev)
    if relu:
        f = torch.relu(f)
    return coarsen(round_clip(f), bits)


def residual(a, b, bits):
    return coarsen(round_clip(a.float() + b.float()), bits)


def attention(q, k, v, qk_scale, lut, bits):
    """q, k, v: (H, T, dh) int8; causal; returns (H, T, dh) int8."""
    dev = q.device
    t = q.shape[1]
    mask = torch.tril(torch.ones((t, t), dtype=torch.float32, device=dev))
    pen = (mask - f32(1.0, dev)) * f32(BIG, dev)
    out = []
    for h in range(0, q.shape[0], HEAD_BLOCK):
        qh, kh, vh = q[h:h + HEAD_BLOCK], k[h:h + HEAD_BLOCK], v[h:h + HEAD_BLOCK]
        s = (qh.double() @ kh.double().transpose(1, 2)).float() * f32(qk_scale, dev)
        masked = s * mask + pen
        d = masked - masked.amax(dim=2, keepdim=True)
        idx = torch.round(d / f32(LUT_SCALE, dev)).clamp_(-128, 127).long() + 128
        w = lut[idx]
        den = w.int().sum(dim=2, keepdim=True)
        p = w.float() / den.float()
        pq = torch.round(p * f32(P_SCALE, dev)).clamp_(-128, 127)
        ctx = (pq.double() @ vh.double()).float() * f32(1.0 / P_SCALE, dev)
        out.append(round_clip(ctx))
        del s, masked, d, idx, w, p, pq, ctx
    return coarsen(torch.cat(out), bits)


def forward(inputs: Dict, tokens: np.ndarray, first: int, bits: int = 8):
    """One causal pass over ``tokens``: float32 logits at positions
    [first, T) and the int8 (K, V) rows of every layer, (layers, 2, T, D)."""
    emb = inputs["embedding"]
    dev = emb.device
    d = emb.shape[1]
    heads = inputs["heads"]
    dh = d // heads
    qk_scale = float(np.float32(inputs["act_scale"] * inputs["act_scale"] / math.sqrt(dh)))
    lut = exp_table(dev)
    tok = torch.as_tensor(np.asarray(tokens, np.int64), device=dev)
    x = coarsen(emb[tok], bits)
    t = x.shape[0]
    lay = inputs["layers"]
    n_layers = lay["qkv"]["w"].shape[0]
    kv = torch.empty((n_layers, 2, t, d), dtype=torch.int8, device=dev)

    def proj(name, l, h, relu=False):
        p = lay[name]
        return project(h, p["w"][l], p["b"][l], p["quant_scale"], p["shift"], relu, bits)

    for l in range(n_layers):
        qkv = proj("qkv", l, x)
        q, k, v = qkv[:, :d], qkv[:, d:2 * d], qkv[:, 2 * d:]
        kv[l, 0], kv[l, 1] = k, v

        def heads_of(z):
            return z.reshape(t, heads, dh).transpose(0, 1)

        ctx = attention(heads_of(q), heads_of(k), heads_of(v), qk_scale, lut, bits)
        ctx = ctx.transpose(0, 1).reshape(t, d)
        x1 = residual(x, proj("o", l, ctx), bits)
        x = residual(x1, proj("down", l, proj("up", l, x1, relu=True)), bits)
    acc = x[first:].double() @ inputs["lm_head"].double()
    logits = acc.float() * f32(inputs["lm_scale"], dev)
    return logits, kv


def compare(cfg, inputs: Dict, served: List[Dict], control: bool = False) -> List[Tuple[str, float, float]]:
    """The numbers compared, each with its limit, over the sampled requests.

    With ``control`` the int4 reference stands in the program's place: its
    first choice at every position is judged by the int8 reference's
    logits, and its K/V rows against the int8 reference's."""
    gap, rows_wrong, checked = 0.0, 0, 0
    for item in served:
        prompt, toks = item["prompt"], item["tokens"]
        seq = np.concatenate([prompt, np.asarray(toks[:-1], np.int64)])
        first = len(prompt) - 1
        logits, kv = forward(inputs, seq, first)
        best = logits.max(dim=1).values
        if control:
            low, kv_low = forward(inputs, seq, first, bits=4)
            chosen = low.argmax(dim=1)
            rows_wrong += int((kv_low != kv).any(dim=3).sum())
            del low, kv_low
        else:
            chosen = torch.as_tensor(toks, device=logits.device)
            if item["kv"] is not None:
                n = item["kv"].shape[2]
                rows_wrong += int((item["kv"].to(kv.device) != kv[:, :, :n]).any(dim=3).sum())
        got = logits.gather(1, chosen[:, None])[:, 0]
        gap = max(gap, float((best - got).max()))
        checked += len(toks)
        del logits, kv
    if not checked:
        raise ValueError("no served token to compare")
    return [("token_gap", gap, LIMITS["token_gap"]), ("kv_rows_wrong", rows_wrong, LIMITS["kv_rows_wrong"])]
