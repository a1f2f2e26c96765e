"""The codified routed-expert layer: one PQ-IR region of standard operators
whose node count does not depend on the number of experts.

A token's int8 activation ``x`` (codes on the block's shared scale) goes
through

* **the router** — ``MatMulInteger(x, Wr)`` → int32 accumulators ``a`` of
  every expert, under one per-tensor scale;
* **top-k by integer comparison** — expert i's rank is the number of experts
  j with ``a_j > a_i``, or ``a_j == a_i`` and ``j < i`` (ties go to the
  lower id); it is chosen when its rank is below k.  The comparisons are
  ``Clip(a_j − a_i, 0, 1)`` on int32 over an ``(E, E)`` pair axis, and the
  lower-id rule a constant strictly-lower-triangular ``(E, E)`` matrix;
* **the weights** — from the attention's exp table over the code
  difference to the best expert: ``a_i − max a`` → float32 × the router
  scale → ``QuantizeLinear`` at the table's step → ``lut[· + 128]`` (no
  transcendental at run time), zero where not chosen; then one IEEE float32
  division by their integer sum, × 127, round half to even: int8 codes
  ``pq``;
* **every expert as SwiGLU** — stacked ``(E, D, F)`` gate and up and
  ``(E, F, D)`` down weights: gate (w8) → rescale → int8 → the SiLU table
  (``Gather`` of a 256-entry int8 table) ; up (w8) → rescale → int8; their
  product in float32 × ``h_scale`` → int8; down (w8) → rescale → int8 ``y``;
* **the combination** — ``MatMulInteger(pq, y)`` over the expert axis: the
  sum of ``pq_e · y_e`` is an integer (at most ``k · 127 · 127`` in
  magnitude, exact in float32 and in int32 in any order, so the ascending
  expert order is what every order computes), × 1/127, round half to even,
  clip to int8.

An expert the router did not choose has ``pq = 0`` and adds nothing, so the
dense region (every expert on every token: what :class:`ReferenceRuntime`
evaluates) equals the routed computation (only the k chosen experts per
token: what the fused ``qmoe`` step computes, :mod:`repro_torch.kernels.qmoe`)
bit for bit.  The region works per token: nothing mixes rows, so padding a
token axis is exact, and the compiler's padding proof exempts its nodes.

:func:`match_qmoe` finds the region in an (optimized) graph from its router
``MatMulInteger``, and :func:`qmoe_regions` lists every one; the compiler
lowers each to one plan step (``core/compile.py``).
"""
from __future__ import annotations

import dataclasses
from collections import Counter
from typing import Dict, List, Optional

import numpy as np

from ..passes.analysis import GraphAnalysis
from .patterns import ATTN_LUT_SCALE, build_exp_lut, emit_round_clip
from .pqir import GraphBuilder, Node
from .quant import Rescale, decompose_multiplier

#: The probability scale of the routing weights (as the attention's P).
MOE_P_SCALE = 127.0


def build_silu_table(in_scale: float, out_scale: float) -> np.ndarray:
    """The 256-entry int8 SiLU table: entry ``i`` is the int8 code of
    ``silu((i − 128) · in_scale)`` at ``out_scale``, computed in float64 and
    rounded half to even."""
    x = (np.arange(256, dtype=np.float64) - 128.0) * float(in_scale)
    y = x / (1.0 + np.exp(-x))
    return np.clip(np.rint(y / float(out_scale)), -128, 127).astype(np.int8)


@dataclasses.dataclass
class MoEParams:
    """Pre-quantized parameters of one routed-expert layer."""

    router: np.ndarray  # (D, E) int8
    gate: np.ndarray  # (E, D, F) int8
    up: np.ndarray  # (E, D, F) int8
    down: np.ndarray  # (E, F, D) int8
    gate_rescale: Rescale
    up_rescale: Rescale
    down_rescale: Rescale
    router_scale: float  # accumulator → logit units
    h_scale: float  # silu(gate) · up codes → h codes
    silu: np.ndarray  # (256,) int8
    top_k: int

    @property
    def n_experts(self) -> int:
        return int(self.router.shape[1])


def make_moe_params(rng: np.random.Generator, d: int, f: int, e: int, top_k: int,
                    act_scale: float) -> MoEParams:
    """Seeded int8 parameters of one expert layer (the CPU tests' sizes):
    uniform int8 weight codes, and rescales that keep codes spread about 24
    for inputs spread about 25, the router's logits about 2."""
    def codes(*shape):
        return rng.integers(-127, 128, shape).astype(np.int8)

    w_std, x_std = 73.0, 25.0
    return MoEParams(
        router=codes(d, e), gate=codes(e, d, f), up=codes(e, d, f), down=codes(e, f, d),
        gate_rescale=decompose_multiplier(24.0 / (np.sqrt(d) * x_std * w_std)),
        up_rescale=decompose_multiplier(24.0 / (np.sqrt(d) * x_std * w_std)),
        down_rescale=decompose_multiplier(24.0 / (np.sqrt(f) * 20.0 * w_std)),
        router_scale=float(np.float32(2.0 / (np.sqrt(d) * x_std * w_std))),
        h_scale=float(np.float32(1.0 / 16.0)),
        silu=build_silu_table(act_scale, act_scale), top_k=int(top_k),
    )


def _const(gb: GraphBuilder, prefix: str, name: str, value) -> str:
    return gb.add_initializer(f"{prefix}_{name}", np.asarray(value))


def _rescaled(gb: GraphBuilder, acc: str, r: Rescale, prefix: str) -> str:
    f = gb.op("Cast", [acc], out_hint=f"{prefix}_f32", to="float32")
    f = gb.op("Mul", [f, _const(gb, prefix, "quant_scale", np.float32(r.quant_scale))],
              out_hint=f"{prefix}_scaled")
    f = gb.op("Mul", [f, _const(gb, prefix, "quant_shift", np.float32(r.quant_shift))],
              out_hint=f"{prefix}_shifted")
    return emit_round_clip(gb, f, prefix)


def emit_qmoe(gb: GraphBuilder, x: str, p: MoEParams, prefix: str) -> str:
    """Emit the routed-expert region on ``x ("N", "S", D) int8``; returns
    its int8 output ``("N", "S", D)``.  See the module docstring."""
    e = p.n_experts
    i32 = lambda v: np.int32(v)  # noqa: E731
    # router and top-k
    wr = _const(gb, prefix, "router_q", p.router)
    acc = gb.op("MatMulInteger", [x, wr], out_hint=f"{prefix}_router_acc")
    a_i = gb.op("Unsqueeze", [acc, _const(gb, prefix, "ax3", np.array([3], np.int64))],
                out_hint=f"{prefix}_a_i")
    a_j = gb.op("Unsqueeze", [acc, _const(gb, prefix, "ax2", np.array([2], np.int64))],
                out_hint=f"{prefix}_a_j")
    diff = gb.op("Sub", [a_j, a_i], out_hint=f"{prefix}_diff")
    zero, one = _const(gb, prefix, "zero", i32(0)), _const(gb, prefix, "one", i32(1))
    gt = gb.op("Clip", [diff, zero, one], out_hint=f"{prefix}_gt")
    neg = gb.op("Sub", [zero, diff], out_hint=f"{prefix}_neg")
    lt = gb.op("Clip", [neg, zero, one], out_hint=f"{prefix}_lt")
    ne = gb.op("Add", [gt, lt], out_hint=f"{prefix}_ne")
    eq = gb.op("Sub", [one, ne], out_hint=f"{prefix}_eq")
    lower = np.tril(np.ones((e, e), np.int32), -1)  # [i, j] = 1 where j < i
    tie = gb.op("Mul", [eq, _const(gb, prefix, "lower", lower)], out_hint=f"{prefix}_tie")
    beats = gb.op("Add", [gt, tie], out_hint=f"{prefix}_beats")
    rank = gb.op("ReduceSum", [beats], out_hint=f"{prefix}_rank", axes=[3], keepdims=0)
    left = gb.op("Sub", [_const(gb, prefix, "k", i32(p.top_k)), rank], out_hint=f"{prefix}_left")
    sel = gb.op("Clip", [left, zero, one], out_hint=f"{prefix}_sel")
    # routing weights: the exp table over the code difference to the best
    mx = gb.op("ReduceMax", [acc], out_hint=f"{prefix}_best", axes=[2], keepdims=1)
    delta = gb.op("Sub", [acc, mx], out_hint=f"{prefix}_delta")
    df = gb.op("Cast", [delta], out_hint=f"{prefix}_delta_f32", to="float32")
    df = gb.op("Mul", [df, _const(gb, prefix, "router_scale", np.float32(p.router_scale))],
               out_hint=f"{prefix}_logit_delta")
    zp8 = _const(gb, prefix, "zp_i8", np.zeros((), np.int8))
    dq = gb.op("QuantizeLinear", [df, _const(gb, prefix, "lut_scale", np.float32(ATTN_LUT_SCALE)), zp8],
               out_hint=f"{prefix}_delta_q")
    idx = gb.op("Cast", [dq], out_hint=f"{prefix}_idx32", to="int32")
    idx = gb.op("Add", [idx, _const(gb, prefix, "idx_off", i32(128))], out_hint=f"{prefix}_idx")
    w = gb.op("Gather", [_const(gb, prefix, "exp_lut", build_exp_lut()), idx], out_hint=f"{prefix}_w", axis=0)
    wi = gb.op("Cast", [w], out_hint=f"{prefix}_w_i32", to="int32")
    wsel = gb.op("Mul", [wi, sel], out_hint=f"{prefix}_w_sel")
    den = gb.op("ReduceSum", [wsel], out_hint=f"{prefix}_den", axes=[2], keepdims=1)
    pr = gb.op("Div", [gb.op("Cast", [wsel], out_hint=f"{prefix}_w_f32", to="float32"),
                       gb.op("Cast", [den], out_hint=f"{prefix}_den_f32", to="float32")],
               out_hint=f"{prefix}_p")
    pr = gb.op("Mul", [pr, _const(gb, prefix, "p_scale", np.float32(MOE_P_SCALE))], out_hint=f"{prefix}_p_scaled")
    pq = gb.op("QuantizeLinear", [pr, _const(gb, prefix, "pq_scale", np.float32(1.0)), zp8],
               out_hint=f"{prefix}_pq")
    # every expert, stacked
    xe = gb.op("Unsqueeze", [x, _const(gb, prefix, "ax1", np.array([1], np.int64))], out_hint=f"{prefix}_xe")
    g_acc = gb.op("MatMulInteger", [xe, _const(gb, prefix, "gate_q", p.gate)], out_hint=f"{prefix}_gate_acc")
    g = _rescaled(gb, g_acc, p.gate_rescale, f"{prefix}_gate")
    gi = gb.op("Cast", [g], out_hint=f"{prefix}_gate_i32", to="int32")
    gi = gb.op("Add", [gi, _const(gb, prefix, "silu_off", i32(128))], out_hint=f"{prefix}_silu_idx")
    s = gb.op("Gather", [_const(gb, prefix, "silu_lut", p.silu), gi], out_hint=f"{prefix}_silu", axis=0)
    u_acc = gb.op("MatMulInteger", [xe, _const(gb, prefix, "up_q", p.up)], out_hint=f"{prefix}_up_acc")
    u = _rescaled(gb, u_acc, p.up_rescale, f"{prefix}_up")
    su = gb.op("Mul", [gb.op("Cast", [s], out_hint=f"{prefix}_silu_f32", to="float32"),
                       gb.op("Cast", [u], out_hint=f"{prefix}_up_f32", to="float32")],
               out_hint=f"{prefix}_su")
    su = gb.op("Mul", [su, _const(gb, prefix, "h_scale", np.float32(p.h_scale))], out_hint=f"{prefix}_h_f32")
    h = emit_round_clip(gb, su, f"{prefix}_h")
    d_acc = gb.op("MatMulInteger", [h, _const(gb, prefix, "down_q", p.down)], out_hint=f"{prefix}_down_acc")
    y = _rescaled(gb, d_acc, p.down_rescale, f"{prefix}_down")
    # the combination over the expert axis
    yt = gb.op("Transpose", [y], out_hint=f"{prefix}_y_t", perm=[0, 2, 1, 3])
    pq4 = gb.op("Unsqueeze", [pq, _const(gb, prefix, "ax2b", np.array([2], np.int64))], out_hint=f"{prefix}_pq4")
    c_acc = gb.op("MatMulInteger", [pq4, yt], out_hint=f"{prefix}_comb_acc")
    c_acc = gb.op("Squeeze", [c_acc, _const(gb, prefix, "ax2c", np.array([2], np.int64))],
                  out_hint=f"{prefix}_comb")
    cf = gb.op("Cast", [c_acc], out_hint=f"{prefix}_comb_f32", to="float32")
    cf = gb.op("Mul", [cf, _const(gb, prefix, "out_rescale", np.float32(1.0 / MOE_P_SCALE))],
               out_hint=f"{prefix}_comb_scaled")
    return emit_round_clip(gb, cf, f"{prefix}_out")


# ---------------------------------------------------------------------------
# matching the region in an optimized graph
# ---------------------------------------------------------------------------

def _signature(rescale_muls: int) -> Counter:
    """The op-type multiset of one region, with ``rescale_muls`` Muls per
    rescale (2 as emitted, 1 once the passes fold the shift in)."""
    return Counter({
        "MatMulInteger": 5, "Unsqueeze": 4, "Squeeze": 1, "Transpose": 1, "Sub": 5, "Clip": 3,
        "Add": 4, "Mul": 7 + 3 * rescale_muls, "ReduceSum": 2, "ReduceMax": 1,
        "Cast": 12, "QuantizeLinear": 7, "Gather": 2, "Div": 1,
    })


class _View:
    """Producers, consumers and constants of one graph, for the matcher."""

    def __init__(self, ga: GraphAnalysis) -> None:
        self.ga = ga
        self.prod = ga.graph.producers()
        self.cons = ga.graph.consumers()

    def const(self, name: str):
        c = self.ga.const(name) if name else None
        return None if c is None else np.asarray(c)

    def scalar(self, node: Node) -> Optional[float]:
        """The scalar constant operand of a binary node or QuantizeLinear."""
        for t in node.inputs[1:2] + node.inputs[:1]:
            c = self.const(t)
            if c is not None and c.size == 1:
                return float(c.reshape(()))
        return None

    def only(self, tensor: str, op: str) -> Optional[Node]:
        """The one consumer of ``tensor``, if it has type ``op``."""
        cs = self.cons.get(tensor, [])
        return cs[0] if len(cs) == 1 and cs[0].op_type == op else None

    def rescale_after(self, mm: Node):
        """((quant_scale, quant_shift), its QuantizeLinear) of the Cast →
        Mul (→ Mul) → QuantizeLinear chain after ``mm``."""
        n = self.only(mm.outputs[0], "Cast")
        muls = []
        while n is not None:
            (nxt,) = self.cons.get(n.outputs[0], [None])[:1] or (None,)
            if nxt is None or len(self.cons[n.outputs[0]]) != 1:
                return None
            if nxt.op_type == "QuantizeLinear":
                if not 1 <= len(muls) <= 2 or None in muls:
                    return None
                return (muls[0], muls[1] if len(muls) == 2 else 1.0), nxt
            if nxt.op_type != "Mul":
                return None
            muls.append(self.scalar(nxt))
            n = nxt
        return None


def _is_router(v: _View, node: Node) -> bool:
    if node.op_type != "MatMulInteger" or len(node.inputs) != 2:
        return False
    w = v.const(node.inputs[1])
    if w is None or w.ndim != 2 or w.dtype != np.int8:
        return False
    return sorted(c.op_type for c in v.cons.get(node.outputs[0], [])) == ["ReduceMax", "Sub", "Unsqueeze", "Unsqueeze"]


def _sink_of(v: _View, anchor: Node, limit: int = 64) -> Optional[Node]:
    """The region's last QuantizeLinear: after the combining MatMulInteger
    (the one with two computed operands among the anchor's descendants),
    Squeeze → Cast → Mul → QuantizeLinear."""
    seen, frontier = set(), [anchor]
    while frontier and len(seen) < limit:
        n = frontier.pop(0)
        if id(n) in seen:
            continue
        seen.add(id(n))
        if n is not anchor and n.op_type == "MatMulInteger" and v.const(n.inputs[1]) is None:
            sq = v.only(n.outputs[0], "Squeeze")
            c = sq and v.only(sq.outputs[0], "Cast")
            m = c and v.only(c.outputs[0], "Mul")
            return m and v.only(m.outputs[0], "QuantizeLinear")
        for o in n.outputs:
            frontier.extend(v.cons.get(o, []))
    return None


def _closure(v: _View, sink: Node, x: str, limit: int = 80) -> Optional[List[Node]]:
    """The nodes ``sink`` depends on, back to ``x`` and constants."""
    seen: Dict[int, Node] = {}
    stack = [sink]
    while stack:
        n = stack.pop()
        if id(n) in seen:
            continue
        seen[id(n)] = n
        if len(seen) > limit:
            return None
        for t in n.inputs:
            if not t or t == x or v.const(t) is not None:
                continue
            p = v.prod.get(t)
            if p is None:
                return None  # a graph input other than x: not a region
            stack.append(p)
    return list(seen.values())


def match_qmoe(ga: GraphAnalysis, anchor: Node, view: Optional[_View] = None) -> Optional[dict]:
    """The routed-expert region whose router MatMulInteger is ``anchor``,
    with its parameters; None when ``anchor`` starts no such region."""
    v = view or _View(ga)
    if not _is_router(v, anchor):
        return None
    x = anchor.inputs[0]
    sink = _sink_of(v, anchor)
    nodes = sink and _closure(v, sink, x)
    if not nodes or Counter(n.op_type for n in nodes) not in (_signature(1), _signature(2)):
        return None
    members = {id(n) for n in nodes}
    graph_outs = {t.name for t in ga.graph.outputs}
    for n in nodes:  # nothing but the sink's output leaves the region
        if n is not sink and any(o in graph_outs or any(id(c) not in members for c in v.cons.get(o, []))
                                 for o in n.outputs):
            return None
    stacked = [n for n in nodes if n.op_type == "MatMulInteger" and (v.const(n.inputs[1]) is not None)
               and v.const(n.inputs[1]).ndim == 3]
    gate_up = [n for n in stacked if v.prod[n.inputs[0]].op_type == "Unsqueeze"
               and v.prod[n.inputs[0]].inputs[0] == x]
    down = [n for n in stacked if n not in gate_up]
    chains = {id(n): v.rescale_after(n) for n in stacked}
    if len(gate_up) != 2 or len(down) != 1 or None in chains.values():
        return None
    # the gate's codes are cast to int32 (the SiLU table's index), the up's to float32
    to = {id(n): v.cons[chains[id(n)][1].outputs[0]][0].attrs.get("to") for n in gate_up}
    gate = [n for n in gate_up if to[id(n)] == "int32"]
    up = [n for n in gate_up if to[id(n)] == "float32"]
    if len(gate) != 1 or len(up) != 1:
        return None
    gate, up, down = gate[0], up[0], down[0]
    tables = {str(v.const(n.inputs[0]).dtype): v.const(n.inputs[0])
              for n in nodes if n.op_type == "Gather" and v.const(n.inputs[0]) is not None}
    if set(tables) != {"uint8", "int8"}:
        return None
    # scalars by role
    best = [c for c in v.cons[anchor.outputs[0]] if c.op_type == "ReduceMax"][0]
    sub = v.only(best.outputs[0], "Sub")
    cast = sub and v.only(sub.outputs[0], "Cast")
    rmul = cast and v.only(cast.outputs[0], "Mul")
    lut_q = rmul and v.only(rmul.outputs[0], "QuantizeLinear")
    div = [n for n in nodes if n.op_type == "Div"][0]
    pmul = v.only(div.outputs[0], "Mul")
    su = [n for n in nodes if n.op_type == "Mul" and all(
        v.const(t) is None and v.prod[t].op_type == "Cast" and v.prod[t].attrs.get("to") == "float32"
        for t in n.inputs)]
    hmul = len(su) == 1 and v.only(su[0].outputs[0], "Mul")
    omul = v.prod[sink.inputs[0]]
    ks = [n for n in nodes if n.op_type == "Sub" and v.const(n.inputs[0]) is not None
          and v.prod.get(n.inputs[1]) is not None and v.prod[n.inputs[1]].op_type == "ReduceSum"]
    if not (lut_q and pmul and hmul and omul.op_type == "Mul" and len(ks) == 1):
        return None
    return {
        "x": x, "out": sink.outputs[0], "nodes": nodes, "anchor": anchor,
        "router": v.const(anchor.inputs[1]), "gate": v.const(gate.inputs[1]),
        "up": v.const(up.inputs[1]), "down": v.const(down.inputs[1]),
        "gate_scales": chains[id(gate)][0], "up_scales": chains[id(up)][0],
        "down_scales": chains[id(down)][0],
        "exp_lut": tables["uint8"], "silu": tables["int8"],
        "top_k": int(v.const(ks[0].inputs[0]).reshape(())),
        "router_scale": v.scalar(rmul), "lut_scale": v.scalar(lut_q), "p_scale": v.scalar(pmul),
        "h_scale": v.scalar(hmul), "out_rescale": v.scalar(omul),
    }


def qmoe_regions(ga: GraphAnalysis) -> List[dict]:
    """Every routed-expert region of the graph, in node order of anchors."""
    v = _View(ga)
    return [m for m in (match_qmoe(ga, n, v) for n in ga.graph.nodes if _is_router(v, n)) if m]

