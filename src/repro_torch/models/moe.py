"""Mixture-of-Experts FFN: token-choice top-k routing with capacity-bounded
segment-sum dispatch (no (T, E, C) dispatch tensor is ever materialized),
as in ``repro.models.moe``.

Covers both MoE archs of the zoo:
  * qwen2-moe-a2.7b — 60 routed experts top-4 + gated shared expert
  * mixtral-8x22b   — 8 routed experts top-2, renormalized top-k probs

Where the port differs in means, not in result:

* ``lax.top_k`` returns the lower index first on ties, and ``torch.topk``
  promises no order on the card, so the top k are taken from a stable
  descending sort;
* the segment sum is a ``scatter_add`` into each group's ``E·C + 1`` rows
  (a DTensor op, local to each group's shard).  Every in-capacity
  (token, slot) owns its row alone, so each kept row is one value added to
  zero, exact in any order; the last row collects the overflow and is
  dropped, so the atomics there change no result.

The router stays f32 (accuracy-critical, tiny — a deliberate non-quantized
island).
"""
from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

from ..configs.base import ModelConfig
from ..distributed.sharding import shard
from ..core.qlayers import dynamic_quantize
from ..kernels.ref import int_matmul
from .layers import linear, matmul, param


def init_moe(gen, cfg: ModelConfig, dtype=torch.float32, device=None, lead=()) -> dict:
    m = cfg.moe
    assert m is not None
    lead = tuple(lead)
    d, f = cfg.d_model, m.d_ff_expert
    p = {
        "router": param(gen, lead + (d, m.n_experts), scale=0.02, device=device),
        "w_gate": param(gen, lead + (m.n_experts, d, f), dtype=dtype, device=device),
        "w_up": param(gen, lead + (m.n_experts, d, f), dtype=dtype, device=device),
        "w_down": param(gen, lead + (m.n_experts, f, d), dtype=dtype, device=device),
    }
    if m.n_shared_experts:
        fs = m.d_ff_shared
        p.update(
            shared_gate_proj=param(gen, lead + (d, 1), device=device),
            shared_w_gate=param(gen, lead + (d, fs), dtype=dtype, device=device),
            shared_w_up=param(gen, lead + (d, fs), dtype=dtype, device=device),
            shared_w_down=param(gen, lead + (fs, d), dtype=dtype, device=device),
        )
    return p


def _dispatch_shards(t: int) -> int:
    """Number of shard-local dispatch groups: the size of the batch
    ('pod'×'data') mesh axes when a mesh is active, else 1."""
    from ..distributed.sharding import active_mesh, axis_sizes

    mesh = active_mesh()
    if mesh is None:
        return 1
    sizes = axis_sizes(mesh)
    nd = 1
    for ax in ("pod", "data"):
        nd *= sizes.get(ax, 1)
    return nd if t % nd == 0 else 1


def _expert_einsum(buf: torch.Tensor, w) -> torch.Tensor:
    """(x,e,c,d) × (e,d,f) → (x,e,c,f); the W8A8 path when the expert weights
    are pre-quantized (exact int8 contraction + per-channel rescale)."""
    if isinstance(w, dict) and "q8" in w:
        bq, sx = dynamic_quantize(buf)
        acc = int_matmul(bq, w["q8"][None])  # (x,e,c,d) @ (1,e,d,f)
        return (acc.to(torch.float32) * (sx * w["s"][None, :, None, :])).to(buf.dtype)
    # a broadcast matmul, not einsum: under a mesh DTensor's einsum backward
    # views an expert dim it split unevenly (60 over 16) and fails
    return torch.matmul(buf, w.to(buf.dtype)[None])


def top_k(probs: torch.Tensor, k: int):
    """The k largest along the last axis, lower index first among equals
    (``lax.top_k``'s order), from a stable descending sort."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def route(p: dict, xf: torch.Tensor, cfg: ModelConfig):
    """Router softmax, top-k and each (token, slot)'s capacity slot for the
    dispatch groups ``xf`` (nd, Tl, d).  Returns ``(probs, gate_w, gate_idx,
    slot, in_cap, cap)``; ``slot`` is ``E·C`` (the dead row) where a token
    overflows its expert's capacity."""
    m = cfg.moe
    nd, tl, _ = xf.shape
    k, e = m.top_k, m.n_experts
    cap = int(max(1, round(tl * k / e * m.capacity_factor)))
    cap = (cap + 7) // 8 * 8  # tile-friendly local capacity
    logits = matmul(xf.to(torch.float32), p["router"])  # (nd, Tl, E) f32
    probs = torch.softmax(logits, dim=-1)
    gate_w, gate_idx = top_k(probs, k)  # (nd, Tl, k)
    if m.renormalize:
        gate_w = gate_w / torch.clamp_min(gate_w.sum(-1, keepdim=True), 1e-9)
    # position of each (token, slot) within its expert, local to the group:
    # one-hot cumsum over the group's flattened (token, slot) order.
    flat_e = gate_idx.reshape(nd, tl * k)
    onehot = F.one_hot(flat_e, e).to(torch.int32)  # (nd, Tl*k, E)
    pos = ((torch.cumsum(onehot, dim=1) - 1) * onehot).amax(dim=-1)  # (nd, Tl*k)
    in_cap = pos < cap
    slot = torch.where(in_cap, flat_e * cap + pos, torch.full_like(flat_e, e * cap))
    return probs, gate_w, gate_idx, slot, in_cap, cap


def moe_ffn(p: dict, x: torch.Tensor, cfg: ModelConfig) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (output (B,S,d), aux load-balance loss scalar)."""
    m = cfg.moe
    b, s, d = x.shape
    t = b * s
    k, e = m.top_k, m.n_experts
    nd = _dispatch_shards(t)
    tl = t // nd  # tokens per dispatch group

    xf = shard(x.reshape(nd, tl, d), "batch", None, None)
    probs, gate_w, gate_idx, slot, in_cap, cap = route(p, xf, cfg)
    rows = e * cap + 1

    # dispatch: per-group scatter into (E*C, d) buffers (unique slots ⇒ copy)
    x_slots = torch.repeat_interleave(xf, k, dim=1)  # (nd, Tl*k, d)
    buf = xf.new_zeros((nd, rows, d)).scatter_add(1, slot[..., None].expand(nd, tl * k, d), x_slots)
    buf = buf[:, :-1].reshape(nd, e, cap, d)
    buf = shard(buf, "batch", None, None, None)

    # expert computation — swiglu per expert
    g = _expert_einsum(buf, p["w_gate"])
    u = _expert_einsum(buf, p["w_up"])
    g = shard(g, "batch", None, None, "mlp_act")
    h = F.silu(g) * u
    out = shard(_expert_einsum(h, p["w_down"]), "batch", None, None, None)

    # combine: gather each slot's expert output, weight, sum over k slots
    out_flat = out.reshape(nd, e * cap, d)
    take = torch.clamp_max(slot, e * cap - 1)[..., None].expand(nd, tl * k, d)
    gathered = torch.where(in_cap[..., None], torch.gather(out_flat, 1, take), 0.0)
    # (nd, Tl, d) on: under a mesh, DTensor's backward of a (t, d) view
    # back to (nd, Tl, d) mislays a token dim sharded over two mesh axes
    y = (gathered.reshape(nd, tl, k, d) * gate_w[..., None].to(gathered.dtype)).sum(dim=2)

    # shared expert(s) — qwen2-moe style, sigmoid-gated
    if "shared_w_gate" in p:
        sg = F.silu(linear(xf, p["shared_w_gate"]))
        su = linear(xf, p["shared_w_up"])
        sh = linear(sg * su, p["shared_w_down"])
        gate = torch.sigmoid(matmul(xf.to(torch.float32), p["shared_gate_proj"]))
        y = y + sh * gate.to(y.dtype)

    # load-balance aux loss (Switch-style): E * Σ_e f_e · P_e
    frac_tokens = F.one_hot(gate_idx.reshape(nd, tl * k), e).to(torch.float32).mean(dim=(0, 1))
    frac_probs = probs.mean(dim=(0, 1))
    aux = e * torch.sum(frac_tokens * frac_probs) * m.router_aux_loss
    return y.reshape(b, s, d), aux
