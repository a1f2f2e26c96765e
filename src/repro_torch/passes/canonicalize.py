"""Canonicalization passes: semantics-preserving PQ-IR cleanups.

Every pass here is **bit-exact** on integer paths by construction — the
rewrite conditions are chosen so the transformed float arithmetic is
IEEE-identical, not merely close:

* ``const_fold``     — evaluate nodes whose inputs are all initializers using
                       the reference runtime's own op implementations (so the
                       folded value is the value the oracle would compute).
* ``qdq_cancel``     — ``DequantizeLinear → QuantizeLinear`` with identical
                       scale/zero-point and matching **8-bit** dtype is the
                       identity: ``rint((x−z)·s/s)+z == x`` for every
                       representable ``x`` (the f32 products round back
                       exactly because |x·s| error < 1/2 ULP of the integer —
                       true for |x| ≤ 255, not for wide dtypes like int32,
                       which are therefore excluded).
* ``mul_fold``       — consecutive constant ``Mul``s fold to one when either
                       constant is a power of two: scaling by 2**k is exact
                       and commutes with round-to-nearest, so
                       ``RN(RN(x·c)·2**k) == RN(x·(c·2**k))``.  This is
                       precisely the paper's §3.1 quant_scale × 2**−shift
                       rescale pair.  The argument is elementwise, so the
                       constants may be scalars, per-channel vectors, or any
                       broadcast-compatible mix — the per-channel 2**-N shift
                       vector is a power of two in every lane.
* ``add_fold``       — consecutive constant integer ``Add``s fold to one:
                       two's-complement addition is associative even under
                       wrap-around, so ``(x+c1)+c2 == x+(c1+c2)`` exactly for
                       any int dtype (float pairs are left alone — float
                       addition does not associate).
* ``identity_elim``  — same-dtype Cast, ×1.0 / ÷1.0, +0 / −0, identity
                       Transpose/Reshape.
* ``dead_code``      — drop nodes whose outputs are never consumed, and
                       initializers no remaining node reads.

``Reshape``/``Transpose`` sinking lives in :mod:`repro.passes.sink`.
"""
from __future__ import annotations

import math
from typing import Dict, List, Optional

import numpy as np

from ..core import runtime as _rt
from ..core.pqir import DTYPES, Graph, Node
from .analysis import GraphAnalysis
from .rewrite import OpSpec, Pattern, bypass_tensor, match_chain, ql_params, remove_nodes, unique_name


class Pass:
    """A named graph transformation.  ``run`` mutates ``graph`` in place and
    returns its counters (all-zero ⇒ nothing changed)."""

    name = "pass"

    def run(self, graph: Graph) -> Dict[str, int]:
        raise NotImplementedError


# ---------------------------------------------------------------------------
# constant folding
# ---------------------------------------------------------------------------


class ConstantFold(Pass):
    name = "const_fold"

    def run(self, graph: Graph) -> Dict[str, int]:
        folded = 0
        while True:
            ga = GraphAnalysis(graph)
            victim = None
            for node in graph.nodes:
                if any(o in ga.out_names for o in node.outputs):
                    continue
                real_inputs = [i for i in node.inputs if i]
                if not real_inputs or not all(ga.is_const(i) for i in real_inputs):
                    continue
                if node.op_type not in _rt._OPS:
                    continue
                victim = node
                break
            if victim is None:
                return {"folded": folded}
            outs = _rt._OPS[victim.op_type](victim, [ga.const(i) if i else None for i in victim.inputs])
            for name, val in zip(victim.outputs, outs):
                graph.initializers[name] = np.asarray(val)
            remove_nodes(graph, [victim])
            folded += 1


# ---------------------------------------------------------------------------
# Dequantize → Quantize round-trip cancellation
# ---------------------------------------------------------------------------

_QDQ = Pattern(
    "qdq_cancel",
    (
        OpSpec("DequantizeLinear", capture="dql"),
        OpSpec("QuantizeLinear", capture="ql"),
    ),
)


class QdqCancel(Pass):
    name = "qdq_cancel"

    def run(self, graph: Graph) -> Dict[str, int]:
        eliminated = 0
        while True:
            ga = GraphAnalysis(graph)
            applied = False
            for node in graph.toposorted():
                if node.op_type != "DequantizeLinear":
                    continue
                m = match_chain(ga, node, _QDQ)
                if m is None:
                    continue
                dql, ql = m.node("dql"), m.node("ql")
                s1, z1 = ql_params(ga, dql)
                s2, z2 = ql_params(ga, ql)
                if s1 is None or s2 is None or z1 is None or z2 is None:
                    continue
                if not (np.array_equal(s1, s2) and np.array_equal(np.asarray(z1, np.int64), np.asarray(z2, np.int64))):
                    continue
                # per-channel scales cancel too (the round trip is exact
                # elementwise), but only if both ops quantize along the same
                # axis (ONNX default: 1) and the scale/zero-point constants
                # broadcast *into* the data — a rank- or dim-expanding
                # constant makes the chain reshape its input, so removing it
                # would change the output shape.  (s2/z2 have identical
                # shapes: np.array_equal above requires it.)
                if np.asarray(s1).ndim and dql.attrs.get("axis", 1) != ql.attrs.get("axis", 1):
                    continue
                if not (_broadcast_preserves(ga, dql.inputs[0], s1) and _broadcast_preserves(ga, dql.inputs[0], z1)):
                    continue
                # The round-trip only restores x if the output integer dtype
                # is the dtype x already has, and only for 8-bit data — wide
                # dtypes (int32) lose bits in the f32 round trip.
                if ga.dtype(dql.inputs[0]) not in ("int8", "uint8"):
                    continue
                if ga.dtype(dql.inputs[0]) != str(np.asarray(z2).dtype):
                    continue
                src = dql.inputs[0]
                remove_nodes(graph, [dql, ql])
                if not bypass_tensor(graph, src, ql.outputs[0]):
                    graph.nodes.extend([dql, ql])  # can't rewire safely; restore
                    continue
                eliminated += 2
                applied = True
                break
            if not applied:
                return {"eliminated": eliminated}


# ---------------------------------------------------------------------------
# consecutive-Mul rescale folding
# ---------------------------------------------------------------------------

_MULMUL = Pattern(
    "mul_mul",
    (
        OpSpec("Mul", capture="m1", const_operand="c1"),
        OpSpec("Mul", capture="m2", const_operand="c2"),
    ),
)


def _all_pow2(a: np.ndarray) -> bool:
    a = np.asarray(a)
    if not np.issubdtype(a.dtype, np.floating):
        return False
    flat = a.reshape(-1).astype(np.float64)
    if not np.all(np.isfinite(flat)) or np.any(flat <= 0.0):
        return False
    return all(math.frexp(float(v))[0] == 0.5 for v in flat)


def _broadcastable(c1: np.ndarray, c2: np.ndarray) -> bool:
    """Whether two constants may be folded into one.  Broadcast shapes
    compose associatively — broadcast(broadcast(x, c1), c2) ==
    broadcast(x, broadcast(c1, c2)) — so folding two broadcast-compatible
    constants (scalar, per-channel vector, or any mix) never changes the
    chain's output shape or which element pairs meet.  Orthogonal vectors
    (e.g. (1, K) × (K, 1)) are excluded: they broadcast, but the folded
    constant would materialize their O(K²) outer product in the artifact."""
    try:
        folded = np.broadcast_shapes(c1.shape, c2.shape)
    except ValueError:
        return False
    return int(np.prod(folded, dtype=np.int64)) <= max(c1.size, c2.size)


def _broadcast_preserves(ga: GraphAnalysis, tensor: str, c) -> bool:
    """True iff combining ``tensor`` with constant ``c`` cannot change the
    tensor's shape: ``c`` broadcasts *into* it (never expands rank or any
    size-1 dim).  Needs a known static shape for non-scalar ``c``."""
    c = np.asarray(c)
    if c.ndim == 0:
        return True
    sh = ga.shape(tensor)
    if sh is None or c.ndim > len(sh):
        return False
    for cd, xd in zip(c.shape[::-1], tuple(sh)[::-1]):
        if cd != 1 and (xd is None or cd != xd):
            return False
    return True


class MulFold(Pass):
    name = "mul_fold"

    def run(self, graph: Graph) -> Dict[str, int]:
        folded = 0
        eliminated = 0
        while True:
            ga = GraphAnalysis(graph)
            applied = False
            for node in graph.toposorted():
                if node.op_type != "Mul":
                    continue
                m = match_chain(ga, node, _MULMUL)
                if m is None:
                    continue
                c1, c2 = m.consts["c1"], m.consts["c2"]
                if c1.dtype != np.float32 or c2.dtype != np.float32:
                    continue
                # bit-exactness gate: power-of-two scaling commutes with
                # rounding, anything else would double-round differently.
                # Element-wise, so per-channel vectors qualify as long as
                # *every* entry of one constant is a power of two (the §3.1
                # per-channel decomposition makes the whole 2**-N vector so).
                if not (_all_pow2(c1) or _all_pow2(c2)):
                    continue
                if not _broadcastable(c1, c2):
                    continue
                m1, m2 = m.node("m1"), m.node("m2")
                x_in = m1.inputs[1] if ga.is_const(m1.inputs[0]) else m1.inputs[0]
                cname = unique_name(graph, f"{m2.outputs[0]}_folded_scale")
                graph.initializers[cname] = np.asarray(c1 * c2, np.float32)
                fused = Node("Mul", [x_in, cname], [m2.outputs[0]], name=m1.name or "mul_fold")
                idx = next(i for i, n in enumerate(graph.nodes) if n is m1)
                graph.nodes[idx] = fused
                remove_nodes(graph, [m2])
                folded += 1
                eliminated += 1
                applied = True
                break
            if not applied:
                return {"folded": folded, "eliminated": eliminated}


# ---------------------------------------------------------------------------
# consecutive-Add bias folding
# ---------------------------------------------------------------------------

_ADDADD = Pattern(
    "add_add",
    (
        OpSpec("Add", capture="a1", const_operand="c1"),
        OpSpec("Add", capture="a2", const_operand="c2"),
    ),
)


class AddFold(Pass):
    """Fold consecutive constant ``Add``s: ``(x + c1) + c2 → x + (c1 + c2)``.

    Bit-exactness gate: **integer** operands only.  Two's-complement addition
    is associative even under wrap-around, so the fold is exact for any int
    dtype; float addition is not associative, so float pairs are left alone
    (the ``+0`` identity case is already :class:`IdentityElim`'s job).  This
    is the bias-pair analogue of :class:`MulFold` — split int32 bias adds
    around a MatMulInteger collapse to the single Add the QLINEAR fusion
    pattern consumes."""

    name = "add_fold"

    def run(self, graph: Graph) -> Dict[str, int]:
        folded = 0
        eliminated = 0
        while True:
            ga = GraphAnalysis(graph)
            applied = False
            for node in graph.toposorted():
                if node.op_type != "Add":
                    continue
                m = match_chain(ga, node, _ADDADD)
                if m is None:
                    continue
                c1, c2 = m.consts["c1"], m.consts["c2"]
                if not (np.issubdtype(c1.dtype, np.integer) and np.issubdtype(c2.dtype, np.integer)):
                    continue
                a1 = m.node("a1")
                x_in = a1.inputs[1] if ga.is_const(a1.inputs[0]) else a1.inputs[0]
                xd = ga.dtype(x_in)
                if xd is None or not np.issubdtype(DTYPES.get(xd, np.float32), np.integer):
                    continue
                if not _broadcastable(c1, c2):
                    continue
                # Associativity only holds at one fixed width: the folded
                # constant must be summed in the sequential chain's compute
                # dtype d1 = promote(x, c1) (not promote(c1, c2) — narrow
                # consts would wrap too early), and if the second add widens
                # (promote(d1, c2) != d1) the first add's wraparound at d1 is
                # observable and the pair must be kept.
                d1 = np.promote_types(DTYPES[xd], c1.dtype)
                if np.promote_types(d1, c2.dtype) != d1:
                    continue
                a2 = m.node("a2")
                cname = unique_name(graph, f"{a2.outputs[0]}_folded_bias")
                with np.errstate(over="ignore"):
                    graph.initializers[cname] = c1.astype(d1) + c2.astype(d1)
                fused = Node("Add", [x_in, cname], [a2.outputs[0]], name=a1.name or "add_fold")
                idx = next(i for i, n in enumerate(graph.nodes) if n is a1)
                graph.nodes[idx] = fused
                remove_nodes(graph, [a2])
                folded += 1
                eliminated += 1
                applied = True
                break
            if not applied:
                return {"folded": folded, "eliminated": eliminated}


# ---------------------------------------------------------------------------
# identity elimination
# ---------------------------------------------------------------------------


class IdentityElim(Pass):
    name = "identity_elim"

    def run(self, graph: Graph) -> Dict[str, int]:
        eliminated = 0
        while True:
            ga = GraphAnalysis(graph)
            applied = False
            for node in graph.toposorted():
                src = self._identity_source(ga, node)
                if src is None:
                    continue
                remove_nodes(graph, [node])
                if not bypass_tensor(graph, src, node.outputs[0]):
                    graph.nodes.append(node)
                    continue
                eliminated += 1
                applied = True
                break
            if not applied:
                return {"eliminated": eliminated}

    @staticmethod
    def _identity_source(ga: GraphAnalysis, node: Node) -> Optional[str]:
        """Returns the input tensor the node is an identity of, else None."""
        t = node.op_type
        if t == "Cast":
            src = node.inputs[0]
            return src if node.attrs.get("to") == ga.dtype(src) else None
        if t in ("Mul", "Div", "Add", "Sub"):
            if len(node.inputs) != 2:
                return None
            consts = [(i, ga.const(n)) for i, n in enumerate(node.inputs)]
            for idx, c in consts:
                if c is None or c.size != 1:
                    continue
                other = node.inputs[1 - idx]
                if ga.dtype(other) != str(c.dtype):
                    continue  # identity value but dtype-promoting — keep
                if c.ndim:
                    osh = ga.shape(other)
                    if osh is None or c.ndim > len(osh):
                        continue  # rank-expanding broadcast — not an identity
                v = c.reshape(())[()]
                if t == "Mul" and v == 1:
                    return other
                if t == "Div" and idx == 1 and v == 1:
                    return other
                if t == "Add" and v == 0:
                    return other
                if t == "Sub" and idx == 1 and v == 0:
                    return other
            return None
        if t == "Transpose":
            s = ga.shape(node.inputs[0])
            if s is None:
                return None
            perm = node.attrs.get("perm")
            if perm is None:
                perm = list(range(len(s)))[::-1]
            return node.inputs[0] if list(perm) == list(range(len(s))) else None
        if t == "Reshape":
            s_in = ga.shape(node.inputs[0])
            s_out = ga.shape(node.outputs[0])
            if s_in is None or s_out is None or any(d is None for d in s_in) or any(d is None for d in s_out):
                return None
            return node.inputs[0] if tuple(s_in) == tuple(s_out) else None
        return None


# ---------------------------------------------------------------------------
# dead code elimination
# ---------------------------------------------------------------------------


class DeadCode(Pass):
    name = "dead_code"

    def run(self, graph: Graph) -> Dict[str, int]:
        live = {t.name for t in graph.outputs}
        keep: List[Node] = []
        eliminated = 0
        for node in reversed(graph.toposorted()):
            if any(o in live for o in node.outputs):
                keep.append(node)
                live.update(i for i in node.inputs if i)
            else:
                eliminated += 1
        if eliminated:
            alive = {id(n) for n in keep}
            graph.nodes[:] = [n for n in graph.nodes if id(n) in alive]
        used = {i for n in graph.nodes for i in n.inputs if i} | {t.name for t in graph.outputs}
        pruned = [k for k in graph.initializers if k not in used]
        for k in pruned:
            del graph.initializers[k]
        return {"eliminated": eliminated, "pruned_inits": len(pruned)}
