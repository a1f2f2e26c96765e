"""Plain PyTorch reference of the codified Mellum2 block: grouped-query
attention over full and windowed layers, and routed int8 experts.

It imports nothing of the program. From pre-quantized parameters it
computes one causal forward pass per sequence, op for op as the PQ-IR
artifact states them (``serving/token_path.py``, ``core/moe.py``):

* a projection: int8 x · W → int32 (+ bias) → float32 → × quant_scale →
  × 2**-shift → round half to even → clip to int8;
* attention per query head, against its group's KV head: int8 Q·Kᵀ →
  float32 × qk_scale → s·mask + (mask − 1)·30000 → minus the row max →
  round(· / 0.125) clipped to int8 → + 128 → the uint8 exp table →
  p = w / Σw → round(p · 127) → int8 P·V → × 1/127 → round, clip.  A full
  layer's query at p sees keys 0 … p, a window layer's p − W + 1 … p;
* the routed experts: the router's int32 sums; expert i chosen when fewer
  than k experts beat it (a larger sum, or an equal sum and a lower id);
  weights from the exp table over the sum's difference to the best, × the
  router scale, at the table's step; p = w / Σw over the chosen (one float32
  division), round(p · 127); per chosen expert gate → SiLU table, up, the
  float32 product × h_scale → int8, down → int8 y; Σ pq · y → × 1/127 →
  round, clip;
* residuals: both codes to float32, add, round, clip; logits: int8 x ·
  lm_head → float32 × lm_scale.

Integer products are summed in float64, which holds them exactly
(TF32 is switched off for every matmul here).  Nothing is cached or
padded.  :func:`forward_many` takes several sequences at once: the
projections and the experts run over all their tokens in blocks (each
expert only on the tokens that chose it, grouped by expert), attention
sequence by sequence in blocks of query rows against only the keys they
may see.

``params`` is a plain dict: ``embedding`` (V, D) int8, ``lm_head`` (D, V)
int8, ``lm_scale``, ``act_scale``, ``heads``, ``kv_heads``, ``head_dim``,
``window``, ``kinds`` (``"full"``/``"window"`` per layer), ``top_k``, and
``layers``: one dict per layer with ``qkv`` and ``o`` as ``(w (K, N) int8,
b (N,) int32, quant_scale, shift)``, ``router`` (D, E), ``gate`` and ``up``
(E, D, F), ``down`` (E, F, D) int8, ``gate_rs``/``up_rs``/``down_rs`` as
``(quant_scale, shift)``, ``router_scale``, ``h_scale`` and ``silu`` (256,)
int8.  ``bits`` below 8 rounds every int8 activation to that precision
(the control).
"""
from __future__ import annotations

import math
from typing import Dict, List, Tuple

import numpy as np
import torch

BIG = 30000.0
LUT_SCALE = 0.125
P_SCALE = 127.0
#: Query rows of one full layer's attention block (a window layer's block is
#: half its window): bounds the (heads, rows, keys) temporaries.
ROW_BLOCK = 1024
#: Tokens of one block of the projections and the experts.
TOKEN_BLOCK = 32768
#: Positions of one lm_head block.
LOGIT_BLOCK = 512


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


def imm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Exact integer a @ b, as float64."""
    return a.double() @ b.double()


def rescale(acc: torch.Tensor, qs: float, shift: int) -> torch.Tensor:
    dev = acc.device
    f = acc.float() * f32(qs, dev)
    return round_clip(f * f32(2.0 ** -shift, dev))


def project(x, lin, bits):
    """A projection over row blocks of ``x`` (bounds the float64 sums)."""
    w, b, qs, shift = lin
    wd = w.double()
    out = []
    for i in range(0, x.shape[0], TOKEN_BLOCK):
        acc = x[i:i + TOKEN_BLOCK].double() @ wd
        if b is not None:
            acc = acc + b.double()
        out.append(rescale(acc, qs, shift))
    return coarsen(torch.cat(out), bits)


def attention(q, k, v, qk_scale, window, lut, bits):
    """q (H, T, dh) of one KV group, k and v (T, dh) int8; causal, and with
    ``window`` each row sees its last ``window`` positions only."""
    dev = q.device
    t = q.shape[1]
    out = torch.empty_like(q)
    block = max(1, window // 2) if window else ROW_BLOCK
    for i0 in range(0, t, block):
        i1 = min(t, i0 + block)
        j0 = max(0, i0 - window + 1) if window else 0
        rows = torch.arange(i0, i1, device=dev)[:, None]
        cols = torch.arange(j0, i1, device=dev)[None, :]
        seen = cols <= rows
        if window:
            seen &= cols > rows - window
        mask = seen.float()
        s = imm(q[:, i0:i1], k[j0:i1].t()).float() * f32(qk_scale, dev)
        masked = s * mask + (mask - f32(1.0, dev)) * f32(BIG, dev)
        d = masked - masked.amax(dim=2, keepdim=True)
        w = lut[torch.round(d / f32(LUT_SCALE, dev)).clamp_(-128, 127).long() + 128]
        p = w.float() / w.int().sum(dim=2, keepdim=True).float()
        pq = torch.round(p * f32(P_SCALE, dev)).clamp_(-128, 127)
        out[:, i0:i1] = round_clip(imm(pq, v[j0:i1]).float() * f32(1.0 / P_SCALE, dev))
        del s, masked, d, w, p, pq
    return coarsen(out, bits)


def route(x, lay, top_k, lut):
    """(chosen (T, E) bool, pq (T, E) int64): top-k by integer comparison,
    ties to the lower id, and the int8 codes of their weights."""
    dev = x.device
    a = imm(x, lay["router"]).long()
    e = a.shape[1]
    beats = a[:, None, :] > a[:, :, None]  # [t, i, j]: expert j beats expert i
    beats |= (a[:, None, :] == a[:, :, None]) & torch.ones((e, e), dtype=torch.bool, device=dev).tril(-1)
    chosen = beats.sum(dim=2) < top_k
    f = (a - a.amax(dim=1, keepdim=True)).int().float() * f32(lay["router_scale"], dev)
    w = lut[torch.round(f / f32(LUT_SCALE, dev)).clamp_(-128, 127).long() + 128].long() * chosen
    p = w.float() / w.sum(dim=1, keepdim=True).float()
    return chosen, torch.round(p * f32(P_SCALE, dev)).clamp_(-128, 127).long()


def experts(x, lay, top_k, lut, bits):
    """The routed-expert layer on x (T, D) int8: over row blocks, each
    expert only on the rows that chose it."""
    dev = x.device
    silu = lay["silu"].long()
    weights = {name: lay[name].double() for name in ("gate", "up", "down")}
    out = []
    for i in range(0, x.shape[0], TOKEN_BLOCK):
        xb = x[i:i + TOKEN_BLOCK]
        chosen, pq = route(xb, lay, top_k, lut)
        acc = torch.zeros(xb.shape, dtype=torch.float64, device=dev)
        for e in torch.nonzero(chosen.any(dim=0))[:, 0].tolist():
            rows = torch.nonzero(chosen[:, e])[:, 0]
            xe = xb[rows].double()
            g = silu[rescale(xe @ weights["gate"][e], *lay["gate_rs"]).long() + 128].to(torch.int8)
            u = rescale(xe @ weights["up"][e], *lay["up_rs"])
            h = coarsen(round_clip(g.float() * u.float() * f32(lay["h_scale"], dev)), bits)
            y = coarsen(rescale(h.double() @ weights["down"][e], *lay["down_rs"]), bits)
            acc[rows] += pq[rows, e:e + 1].double() * y.double()
        out.append(coarsen(round_clip(acc.float() * f32(1.0 / P_SCALE, dev)), bits))
    return torch.cat(out)


def residual(a, b, bits):
    return coarsen(round_clip(a.float() + b.float()), bits)


def forward_many(params: Dict, seqs: List, bits: int = 8) -> Tuple[torch.Tensor, List[torch.Tensor], List[int]]:
    """Causal passes over several sequences at once: the projections and
    experts over all their tokens together, attention sequence by sequence.
    Returns the last layer's int8 rows ``(ΣT, D)``, each layer's int8 (K, V)
    rows ``(2, ΣT, KW)``, and each sequence's first row."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    emb = params["embedding"]
    dev = emb.device
    heads, kvh, dh = params["heads"], params["kv_heads"], params["head_dim"]
    group, qw, kw = heads // kvh, heads * dh, kvh * dh
    qk_scale = float(np.float32(params["act_scale"] * params["act_scale"] / math.sqrt(dh)))
    lut = exp_table(dev)
    lens = [len(sq) for sq in seqs]
    starts = np.concatenate([[0], np.cumsum(lens)[:-1]]).astype(int).tolist()
    tok = torch.as_tensor(np.concatenate([np.asarray(sq, np.int64) for sq in seqs]), device=dev)
    x = coarsen(emb[tok], bits)
    kv = []
    for lay, kind in zip(params["layers"], params["kinds"]):
        window = params["window"] if kind == "window" else 0
        qkv = project(x, lay["qkv"], bits)
        k, v = qkv[:, qw:qw + kw], qkv[:, qw + kw:]
        kv.append(torch.stack([k, v]))
        ctx = torch.empty((x.shape[0], qw), dtype=torch.int8, device=dev)
        for o, t in zip(starts, lens):
            q = qkv[o:o + t, :qw].reshape(t, heads, dh).transpose(0, 1)
            c = ctx[o:o + t].view(t, heads, dh)
            for g in range(kvh):
                hs = slice(g * group, (g + 1) * group)
                c[:, hs] = attention(q[hs], k[o:o + t, g * dh:(g + 1) * dh], v[o:o + t, g * dh:(g + 1) * dh],
                                     qk_scale, window, lut, bits).transpose(0, 1)
        del qkv
        x1 = residual(x, project(ctx, lay["o"], bits), bits)
        x = residual(x1, experts(x1, lay, params["top_k"], lut, bits), bits)
    return x, kv, starts


def logits_of(params: Dict, x: torch.Tensor) -> torch.Tensor:
    """float32 logits of int8 rows x: int8 x · lm_head → float32 × lm_scale."""
    head = params["lm_head"].double()
    out = torch.cat([(x[i:i + LOGIT_BLOCK].double() @ head).float() for i in range(0, x.shape[0], LOGIT_BLOCK)])
    return out * f32(params["lm_scale"], x.device)


def forward(params: Dict, tokens, first: int, bits: int = 8) -> Tuple[torch.Tensor, List[torch.Tensor]]:
    """One causal pass over ``tokens``: float32 logits at positions
    [first, T), and each layer's int8 (K, V) rows ``(2, T, KW)``."""
    x, kv, _ = forward_many(params, [tokens], bits)
    return logits_of(params, x[first:]), kv


def ring_rows(rows: torch.Tensor, n: int, window: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(ring slots, positions) that a window layer's decode ring holds after
    ``n`` positions: slot r the latest position p < n with p % window == r."""
    slots = torch.arange(min(n, window), device=rows.device)
    pos = slots + window * torch.div(n - 1 - slots, window, rounding_mode="floor")
    return slots, pos


# ---------------------------------------------------------------------------
# The benchmark's comparison
# ---------------------------------------------------------------------------
#
# For each sampled request, the widest gap by which a served token's logit
# lies below the reference's best at its position, and, for a request still
# in its slot, how many of the slot's int8 K/V rows differ from the
# reference's: rows [0, n) of each full layer's cache, and each ring slot of
# a window layer against the position it holds. The program is exact, so
# both limits are 0. The control is this reference with every int8
# activation rounded to int4 precision (the nearest step below the
# configuration's int8): its first choice at every position is judged by
# the int8 reference's logits, and its K/V rows against the int8 reference's.
# All the sampled requests go through one forward_many.

LIMITS = {"token_gap": 0.0, "kv_rows_wrong": 0}


def _rows_wrong(got: torch.Tensor, want: torch.Tensor) -> int:
    return int((got.to(want.device) != want).any(dim=-1).sum())


def compare(cfg, inputs: Dict, served: List[Dict], control: bool = False) -> List[Tuple[str, float, float]]:
    """The numbers compared, each with its limit, over the sampled requests."""
    if not any(item["tokens"] for item in served):
        raise ValueError("no served token to compare")
    seqs = [np.concatenate([item["prompt"], np.asarray(item["tokens"][:-1], np.int64)]) for item in served]
    x, kv, starts = forward_many(inputs, seqs)
    if control:
        x_low, kv_low, _ = forward_many(inputs, seqs, bits=4)
    gap, rows_wrong = 0.0, 0
    window = inputs["window"]
    for item, seq, o in zip(served, seqs, starts):
        first, t = len(item["prompt"]) - 1, len(seq)
        logits = logits_of(inputs, x[o + first:o + t])
        best = logits.max(dim=1).values
        if control:
            chosen = logits_of(inputs, x_low[o + first:o + t]).argmax(dim=1)
            rows_wrong += sum(_rows_wrong(a[:, o:o + t], b[:, o:o + t]) for a, b in zip(kv_low, kv))
        else:
            chosen = torch.as_tensor(item["tokens"], device=logits.device)
            if item["kv"] is not None:
                n = item["kv"]["n"]
                for l, kind in enumerate(inputs["kinds"]):
                    want = kv[l][:, o:o + t]
                    if kind == "full":
                        rows_wrong += _rows_wrong(item["kv"][l], want[:, :n])
                    else:
                        slots, pos = ring_rows(want, n, window)
                        rows_wrong += _rows_wrong(item["kv"][l][:, slots.cpu()], want[:, pos])
        gap = max(gap, float((best - logits.gather(1, chosen[:, None])[:, 0]).max()))
        del logits
    return [("token_gap", gap, LIMITS["token_gap"]), ("kv_rows_wrong", rows_wrong, LIMITS["kv_rows_wrong"])]
