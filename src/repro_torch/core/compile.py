"""The hardware-specific compilation stage on torch devices: PQ-IR → typed
ExecutionPlan → hand-written CUDA kernels (or their plain versions).

The flow is ``repro``'s, level for level:

1. **Optimize** — the :mod:`repro_torch.passes` pipeline (constant folding,
   identity/dead-node elimination, sinking, §3.1 rescale and bias folding,
   Q/DQ cancellation); bit-exact, and the caller's artifact is cloned.
2. **Fuse** — declarative chain patterns (``FUSIONS``: QLINEAR / GEMM /
   LUT) and programmatic region matchers (``REGIONS``) collapse the paper's
   op chains into ``qlinear_matmul`` / ``qlinear_conv2d`` / ``qattention`` /
   ``qact_lut`` steps; the routed-expert regions become ``qmoe`` steps, and
   each codified KV update of a state (``Add(Mul(S, Sub(1, H)), Mul(X,
   H))``) one ``kv_write`` step, which writes only the rows ``H`` selects.
   On the ``cuda`` backend a LUT step that alone reads
   a ``qlinear_matmul`` step's output then folds into that step's epilogue
   (:meth:`Compiler._fold_lut_epilogues`); ``ref`` keeps ``repro``'s steps.
3. **Lower** — drafts become a liveness-planned :class:`ExecutionPlan`.
   Every array constant (weights, bias, scales, LUTs, embeddings) moves to
   the plan's device **once**, here; shape-parameter constants (Slice
   bounds, Reshape targets) stay host integers.  On the ``cuda`` backend the
   matmul and conv parameters are padded, laid out K-contiguous and (matmul)
   int4-packed at this point, once per template.
4. **Specialize (late)** — with ``dynamic_axes`` the plan is a template over
   named axes, bound per (batch × sequence) bucket through a bounded
   :class:`PlanCache`; specializations share the template's device tensors.

Execution is eager: ``jax.jit`` in the reference becomes a direct call of
``plan.execute``.  Backends are ``"ref"`` (plain torch oracles on unpadded
parameters) and ``"cuda"`` (the planned path through the CUDA kernels, whose
wrappers run the plain version only for CPU tensors).  Anything unmatched
falls back to the generic torch op table, so every valid artifact compiles.
"""
from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch

from ..backend import StepDraft, build_plan, const_arg, none_arg, specialize_plan, tensor_arg
from ..backend.generic import _TOPS, SHAPE_OPERANDS
from ..backend.graph import executor_for
from ..backend.plan import ExecutionPlan, PlanCache, bindings_key, resolve_bucketing
from ..backend.registry import lookup
from ..kernels import ops as kops
from ..kernels import qmoe as _kqmoe
from ..kernels.qact_lut import build_lut
from ..obs import trace as _trace
from ..obs.metrics import MetricsRegistry
from ..obs.provenance import PlanProvenance
from ..passes import PassManager, PipelineReport
from ..passes.analysis import (
    BATCH_AXIS,
    GraphAnalysis,
    axis_mixing_nodes,
    axis_positions,
    graph_axes,
    implicit_batch_graph,
)
from ..passes.rewrite import Match, OpSpec, Pattern, match_chain, ql_params
from . import runtime
from .moe import qmoe_regions
from .pqir import Model, Node

# ---------------------------------------------------------------------------
# fusion: declarative pattern specs + plan-step builders
# ---------------------------------------------------------------------------

# activation references the LUT builder bakes; Sigmoid uses the same
# overflow-safe form as the reference runtime so LUTs stay bit-exact vs it
_NP_ACT = {"Tanh": np.tanh, "Sigmoid": runtime.stable_sigmoid}


def _is_round_clip_ql(ga: GraphAnalysis, node: Node) -> bool:
    """QuantizeLinear(scale=1, zp=0) — the paper's pure rounding+clipping
    stage whose zp dtype selects the output dtype."""
    scale, zp = ql_params(ga, node)
    return (
        scale is not None and zp is not None
        and scale.size == 1 and np.asarray(zp).size == 1
        and float(scale) == 1.0 and int(np.asarray(zp)) == 0
    )


def _is_sym_scalar_q(ga: GraphAnalysis, node: Node) -> bool:
    """Scalar-scale, zero-zero-point (symmetric) quantize/dequantize."""
    scale, zp = ql_params(ga, node)
    return (
        scale is not None and zp is not None
        and scale.size == 1 and np.asarray(zp).size == 1
        and int(np.asarray(zp)) == 0
    )


def _dql_int8_sym(ga: GraphAnalysis, node: Node) -> bool:
    return ga.dtype(node.inputs[0]) == "int8" and _is_sym_scalar_q(ga, node)


def _gemm_q_anchor(ga: GraphAnalysis, node: Node) -> bool:
    """Integer Gemm usable as a fused-qlinear core: int8/uint8 activation,
    constant 2-D int8 weight, optional constant integer bias, default
    alpha/beta, no transA (transB folds into the constant at plan time)."""
    if ga.dtype(node.inputs[0]) not in ("int8", "uint8"):
        return False
    if node.attrs.get("transA", 0):
        return False
    if float(node.attrs.get("alpha", 1.0)) != 1.0 or float(node.attrs.get("beta", 1.0)) != 1.0:
        return False
    w = ga.const(node.inputs[1])
    if w is None or w.ndim != 2 or w.dtype != np.int8:
        return False
    if len(node.inputs) > 2 and node.inputs[2]:
        c = ga.const(node.inputs[2])
        if c is None or not np.issubdtype(c.dtype, np.integer):
            return False
    return True


#: The backends a plan can target.
BACKENDS = ("ref", "cuda")


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: ``None`` means the CUDA card.  With
    no card present this raises; it never falls back to the CPU — the caller
    asks for the CPU with ``device="cpu"``."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run on the CPU"
        )
    return dev


def host_to_device(a: np.ndarray, device, dtype=None) -> torch.Tensor:
    """A host array as a tensor on ``device``: where a feed crosses from host
    memory to the device.  Under a tracer the copy is an ``xfer.h2d`` span
    whose ``bytes`` attr is the host bytes read."""
    if not _trace.enabled:
        return torch.as_tensor(a, dtype=dtype, device=device)
    with _trace.span("xfer.h2d", bytes=int(a.nbytes)):
        return torch.as_tensor(a, dtype=dtype, device=device)


def host_to_device_async(a: np.ndarray, device, dtype=None) -> torch.Tensor:
    """:func:`host_to_device` through page-locked memory, returning before
    the device has the bytes: the copy is queued on the current stream, so
    whatever is queued after it reads them, and ``a`` may change at once.
    The host allocator reuses the page-locked block only after the copy.  On
    the CPU it is :func:`host_to_device`."""
    if torch.device(device).type != "cuda":
        return host_to_device(a, device, dtype)
    if not _trace.enabled:
        return torch.as_tensor(a, dtype=dtype).pin_memory().to(device, non_blocking=True)
    with _trace.span("xfer.h2d", bytes=int(a.nbytes)):
        return torch.as_tensor(a, dtype=dtype).pin_memory().to(device, non_blocking=True)


def _dev(compiler: "Compiler", a) -> torch.Tensor:
    """A constant array as a tensor on the compiler's device (moved once)."""
    return torch.from_numpy(np.ascontiguousarray(a)).to(compiler.device)


#: The Fig 1/2 epilogue every qlinear core shares:
#: [Add bias] → Cast(f32) → Mul [→ Mul] → [Relu] → QuantizeLinear(1, 0).
#: The Mul constants may be scalars or per-channel vectors along the
#: output-feature axis — the builder validates the broadcast direction.
_QL_EPILOGUE = (
    OpSpec("Add", capture="bias", optional=True, const_operand="bias_c"),
    OpSpec("Cast", attrs={"to": "float32"}),
    OpSpec("Mul", capture="mul1", const_operand="mul1_c"),
    OpSpec("Mul", capture="mul2", optional=True, const_operand="mul2_c"),
    OpSpec("Relu", capture="relu", optional=True),
    OpSpec("QuantizeLinear", capture="ql", where=_is_round_clip_ql),
)

QLINEAR_PATTERN = Pattern(
    "qlinear",
    (OpSpec(("MatMulInteger", "ConvInteger"), capture="core", arity=2, const_inputs={1: "weight"}),)
    + _QL_EPILOGUE,
)

#: Gemm-codified FC chains (some MLP exporters emit one integer Gemm instead
#: of MatMulInteger + Add) lower onto the same fused qlinear kernel.
GEMM_PATTERN = Pattern(
    "qlinear_gemm",
    (OpSpec("Gemm", capture="core", const_inputs={1: "weight"}, where=_gemm_q_anchor),)
    + _QL_EPILOGUE,
)

LUT_PATTERN = Pattern(
    "qact_lut",
    (
        OpSpec("DequantizeLinear", capture="dql", where=_dql_int8_sym),
        OpSpec("Cast", capture="to16", optional=True, attrs={"to": "float16"}),
        OpSpec(("Tanh", "Sigmoid"), capture="act"),
        OpSpec("Cast", capture="to32", optional=True, attrs={"to": "float32"}),
        OpSpec("QuantizeLinear", capture="ql", where=_is_sym_scalar_q),
    ),
    # the fp16 down-cast and up-cast appear together or not at all
    where=lambda m: (m.node("to16") is None) == (m.node("to32") is None),
)


def _channel_const(c, n_out: int, tail: int, acc_ndim: Optional[int]) -> Optional[np.ndarray]:
    """Normalize a captured epilogue constant to a scalar ``()`` or an
    ``(n_out,)`` vector that broadcasts along the accumulator's
    output-feature axis (``tail`` = trailing spatial singleton dims: 0 for
    the (..., N) matmul layout, 2 for conv's NCHW).  Any other broadcast
    direction (per-row constants, rank-expanding constants whose extra
    leading dims would grow the output shape) returns None — the chain then
    stays unfused rather than fusing incorrectly.  ``acc_ndim`` is the
    accumulator rank when statically known (None ⇒ only rank ≤ 1 constants
    are provably non-expanding)."""
    c = np.asarray(c)
    if c.ndim > (acc_ndim if acc_ndim is not None else 1):
        return None  # broadcasting would prepend dims to the output
    if c.size == 1:
        return c.reshape(())
    shape = c.shape
    if tail:
        if len(shape) <= tail or any(d != 1 for d in shape[len(shape) - tail:]):
            return None
        shape = shape[: len(shape) - tail]
    if not shape or shape[-1] != c.size or c.size != n_out:
        return None
    return c.reshape(-1)


def _static_m(shape) -> Optional[int]:
    """Product of the leading (batch) dims if fully known, else None (a
    symbolic dim — named or unknown — makes the flat M unknowable here)."""
    if shape is None or len(shape) < 1:
        return None
    lead = shape[:-1]
    m = 1
    for d in lead:
        if not isinstance(d, int):
            return None
        m *= int(d)
    return m


def _symbolic_lead(shape) -> Optional[tuple]:
    """The activation's leading dims for an axis-open shape record: named
    axes (strings) mark the symbolic dims — or, on legacy graphs, ``None``
    in the leading position marks the implicit batch; other dims stay
    concrete so late binding can compute the flat M as their product with
    the axis bindings substituted.  A wholly unknown shape returns None —
    binding then leaves M unknown and keeps the default bm rather than
    stamping a flat M it cannot actually know."""
    if shape is None or len(shape) < 2:
        return None
    return tuple(shape[:-1])


def _build_qlinear(compiler: "Compiler", m: Match) -> Optional[StepDraft]:
    """Lower a QLINEAR/GEMM_PATTERN match onto the fused int8 matmul / conv,
    shape-specializing the matmul parameters at plan time.  Returns None
    (fall back unfused) when an epilogue constant does not broadcast along
    the output-feature axis."""
    core = m.anchor
    is_conv = core.op_type == "ConvInteger"
    is_gemm = core.op_type == "Gemm"
    ga = compiler.analysis
    # QONNX-style sub-8-bit weights: the bitwidth rides as a node attribute
    # on the integer core op (weights stay an unpacked int8 initializer, so
    # the reference runtime needs no change); the cuda lowering packs on it.
    weight_bits = int(core.attrs.get("weight_bits", 8))
    zp = ga.const(m.node("ql").inputs[2]) if len(m.node("ql").inputs) > 2 else np.zeros((), np.int8)
    out_dtype = str(np.asarray(zp).dtype)
    relu = m.node("relu") is not None

    w = np.asarray(m.consts["weight"])
    if is_gemm and core.attrs.get("transB", 0):
        w = np.ascontiguousarray(w.T)
    n_out = int(w.shape[0]) if is_conv else int(w.shape[1])
    tail = 2 if is_conv else 0
    # conv accumulators are NCHW by construction; matmul/Gemm rank comes from
    # shape inference (unknown ⇒ _channel_const only admits rank ≤ 1 consts)
    acc_shape = ga.shape(core.outputs[0])
    acc_ndim = 4 if is_conv else (len(acc_shape) if acc_shape is not None else None)

    two_mul = "mul2" in m
    qs = _channel_const(np.asarray(m.consts["mul1_c"], np.float32), n_out, tail, acc_ndim)
    qsh = (
        _channel_const(np.asarray(m.consts["mul2_c"], np.float32), n_out, tail, acc_ndim)
        if two_mul else np.float32(1.0)
    )
    if qs is None or qsh is None:
        return None

    b = None
    if is_gemm and len(core.inputs) > 2 and core.inputs[2]:
        b = _channel_const(ga.const(core.inputs[2]), n_out, 0, acc_ndim)
        if b is None:
            return None
        b = b.astype(np.int32)
    add_c = m.consts.get("bias_c")
    if add_c is not None:
        bc = _channel_const(add_c, n_out, tail, acc_ndim)
        if bc is None:
            return None
        # int32 addition wraps associatively, so folding the Gemm C operand
        # and a trailing Add into one bias is exact even under overflow
        with np.errstate(over="ignore"):
            b = bc.astype(np.int32) if b is None else b + bc.astype(np.int32)
    x_name = core.inputs[0]
    params = {"out_dtype": out_dtype, "relu": relu, "two_mul": two_mul}

    if is_conv:
        attrs = core.attrs
        params.update(
            strides=tuple(attrs.get("strides", (1, 1))),
            pads=tuple(attrs.get("pads", (0, 0, 0, 0))),
        )
        if weight_bits != 8:
            # conv has no packed lane — the bitwidth still renders in the plan
            params["weight_bits"] = weight_bits
        if compiler.backend == "cuda":
            return _build_qconv_planned(compiler, m, w, b, qs, qsh, params)
        consts = (
            _dev(compiler, w),
            None if b is None else _dev(compiler, b),
            _dev(compiler, qs),
            _dev(compiler, np.asarray(qsh, np.float32)),
        )
        return StepDraft(
            "qlinear_conv2d", [tensor_arg(x_name)], [m.out_tensor],
            params=params, consts=consts, kind="fused_qconv", name=core.name,
        )

    if compiler.backend == "ref":
        # plain torch oracle: unpadded params, uint8 handled by int32
        # widening; int4 stays *unpacked* here — this path is what the packed
        # kernel is pinned bit-exact against
        if weight_bits != 8:
            params["weight_bits"] = weight_bits
        consts = (
            _dev(compiler, w),
            None if b is None else _dev(compiler, b),
            _dev(compiler, qs),
            _dev(compiler, np.asarray(qsh, np.float32)),
        )
        return StepDraft(
            "qlinear_matmul", [tensor_arg(x_name)], [m.out_tensor],
            params=params, consts=consts, kind="fused_qlinear", name=core.name,
        )

    # planned CUDA path: fold uint8 → signed int8, pad, lay out and pack at
    # plan time (all batch-independent, so they belong to the template)
    if ga.dtype(x_name) == "uint8":
        b = kops.fold_uint8_input(w, b)
        params["x_uint8"] = True
    if compiler.batch == "dynamic":
        # axis-open template: leave the axis-dependent (m, bm) binding to
        # per-bucket-combination specialization (specialize_plan / PlanCache)
        consts, shape = kops.template_qmatmul_params(
            w, b, qs, np.asarray(qsh, np.float32), weight_bits=weight_bits,
            device=compiler.device,
        )
        shape["lead"] = _symbolic_lead(ga.shape(x_name))
        params["shape"] = shape
        params["dynamic_batch"] = True
    else:
        consts, shape = kops.specialize_qmatmul_params(
            w, b, qs, np.asarray(qsh, np.float32),
            m=_static_m(ga.shape(x_name)), weight_bits=weight_bits,
            device=compiler.device,
        )
        params["shape"] = shape
    return StepDraft(
        "qlinear_matmul", [tensor_arg(x_name)], [m.out_tensor],
        params=params, consts=consts, kind="fused_qlinear", name=core.name,
    )


def _build_qconv_planned(compiler: "Compiler", m: Match, w, b, qs, qsh, params) -> StepDraft:
    """The ``cuda`` conv step: im2col onto the qmatmul kernel.  The weight
    is laid out as the ``(M, C·kH·kW)`` GEMM weight and a uint8 input's
    ``128·Σw`` folds into the bias, once per template.  The shape record's
    ``lead`` is ``(N, OH, OW)`` — the GEMM's M — so the matmul binder closes
    it per batch bucket (M = N_bucket·OH·OW) and chooses bm from it."""
    ga = compiler.analysis
    x_name = m.anchor.inputs[0]
    x_uint8 = ga.dtype(x_name) == "uint8"
    consts, shape = kops.template_qconv_params(
        w, b, qs, np.asarray(qsh, np.float32), strides=params["strides"],
        pads=params["pads"], x_uint8=x_uint8, device=compiler.device,
    )
    xs = ga.shape(x_name)
    if xs is not None and len(xs) == 4:
        oh, ow = kops.conv_out_hw(xs[2], xs[3], shape["kh"], shape["kw"],
                                  shape["strides"], shape["pads"])
        lead = (xs[0], oh, ow)
    else:
        lead = None  # unknown input shape: M stays unknown, bm its default
    if compiler.batch == "dynamic":
        shape["lead"] = lead
        params["shape"] = shape
        params["dynamic_batch"] = True
    else:
        params["shape"] = kops.bind_qmatmul_axes({**shape, "lead": lead}, None)
    return StepDraft(
        "qlinear_conv2d", [tensor_arg(x_name)], [m.out_tensor],
        params=params, consts=consts, kind="fused_qconv", name=m.anchor.name,
    )


def _build_lut(compiler: "Compiler", m: Match) -> StepDraft:
    """Lower a LUT_PATTERN match onto the exact 256-entry LUT."""
    ga = compiler.analysis
    in_scale, _ = ql_params(ga, m.node("dql"))
    out_scale, out_zp = ql_params(ga, m.node("ql"))
    compute_dtype = "float16" if m.node("to16") is not None else "float32"
    out_dtype = str(np.asarray(out_zp).dtype)
    act = m.node("act").op_type

    lut = build_lut(_NP_ACT[act], float(in_scale), float(out_scale), out_dtype, compute_dtype)
    return StepDraft(
        "qact_lut", [tensor_arg(m.node("dql").inputs[0])], [m.out_tensor],
        params={"act": act, "out_dtype": out_dtype}, consts=(_dev(compiler, lut),),
        kind="fused_lut", name=m.node("act").name,
    )


#: The compiler's fusion table: (declarative pattern, plan-step builder).
#: New fusions plug in here — describe the chain as data, lower in a builder.
FUSIONS = (
    (QLINEAR_PATTERN, _build_qlinear),
    (GEMM_PATTERN, _build_qlinear),
    (LUT_PATTERN, _build_lut),
)


# ---------------------------------------------------------------------------
# fused int8 attention: a DAG region, matched programmatically
# ---------------------------------------------------------------------------
#
# The ~25-node attention region emitted by repro_torch.core.patterns.emit_qattention
# is a DAG, not a single-consumer chain (the mask fans into three nodes, the
# masked scores fan into ReduceMax and Sub, the LUT weights fan into the
# numerator and denominator branches), so the declarative chain matcher
# cannot describe it.  _match_qattention walks the emitted structure
# explicitly, anchored on the score MatMulInteger — the only MatMulInteger
# whose *both* operands are non-const, which is also what keeps it disjoint
# from QLINEAR_PATTERN's constant-weight anchor.


def _f32_scalar(ga: GraphAnalysis, name: str) -> Optional[float]:
    c = ga.const(name)
    if c is None:
        return None
    c = np.asarray(c)
    if c.size != 1 or c.dtype != np.float32:
        return None
    return float(c.reshape(()))


def _scalar_operand(ga: GraphAnalysis, node: Node, data: str) -> Optional[float]:
    """The f32 scalar constant operand of a binary node whose other operand
    is ``data`` (either position)."""
    ins = list(node.inputs)
    if data not in ins:
        return None
    other = ins[1] if ins[0] == data else ins[0]
    return _f32_scalar(ga, other)


def _is_zero_zp_ql(ga: GraphAnalysis, node: Node, scale: Optional[float], dtype: str = "int8") -> bool:
    """QuantizeLinear with the given scalar scale (None = any scalar) and a
    zero zero-point of the given dtype."""
    s, zp = ql_params(ga, node)
    if s is None or zp is None or np.asarray(s).size != 1 or np.asarray(zp).size != 1:
        return False
    if scale is not None and float(np.asarray(s)) != scale:
        return False
    return str(np.asarray(zp).dtype) == dtype and int(np.asarray(zp)) == 0


def _match_qattention(ga: GraphAnalysis, anchor: Node) -> Optional[dict]:
    """Match the codified int8 attention region rooted at its score
    MatMulInteger.  Strict by construction: every internal tensor must be
    consumed only inside the region (single_consumer, or the exact expected
    fan-out for the mask / masked-scores / LUT-weight tensors), every
    epilogue constant must be the expected scalar, and the LUT must satisfy
    ``lut[0] == 0`` — the property zero-padding exactness rests on.  Returns
    the capture dict for :func:`_build_qattention`, or None."""

    def nxt(tensor: str, op: str) -> Optional[Node]:
        n = ga.single_consumer(tensor)
        return n if n is not None and n.op_type == op else None

    if anchor.op_type != "MatMulInteger" or len(anchor.inputs) != 2:
        return None
    q, kt = anchor.inputs
    if ga.is_const(q) or ga.is_const(kt):
        return None
    tr = ga.producers.get(kt)
    if tr is None or tr.op_type != "Transpose" or ga.single_consumer(kt) is not anchor:
        return None
    if list(tr.attrs.get("perm", [])) != [0, 2, 1]:
        return None
    k = tr.inputs[0]
    if ga.dtype(q) != "int8" or ga.dtype(k) != "int8":
        return None

    cast1 = nxt(anchor.outputs[0], "Cast")
    if cast1 is None or cast1.attrs.get("to") != "float32":
        return None
    mul_c = nxt(cast1.outputs[0], "Mul")
    if mul_c is None:
        return None
    qk_scale = _scalar_operand(ga, mul_c, cast1.outputs[0])
    if qk_scale is None:
        return None
    sm = nxt(mul_c.outputs[0], "Mul")
    if sm is None:
        return None
    mask = sm.inputs[1] if sm.inputs[0] == mul_c.outputs[0] else sm.inputs[0]
    if ga.is_const(mask) or ga.dtype(mask) != "float32":
        return None
    masked = nxt(sm.outputs[0], "Add")
    if masked is None:
        return None
    pen_t = masked.inputs[1] if masked.inputs[0] == sm.outputs[0] else masked.inputs[0]
    pen = ga.producers.get(pen_t)
    if pen is None or pen.op_type != "Mul" or ga.single_consumer(pen_t) is not masked:
        return None
    sub1_t = pen.inputs[0] if _f32_scalar(ga, pen.inputs[1]) is not None else pen.inputs[1]
    big = _scalar_operand(ga, pen, sub1_t)
    sub1 = ga.producers.get(sub1_t)
    if big is None or sub1 is None or sub1.op_type != "Sub":
        return None
    if ga.single_consumer(sub1_t) is not pen:
        return None
    if sub1.inputs[0] != mask or _f32_scalar(ga, sub1.inputs[1]) != 1.0:
        return None

    # masked scores fan into exactly {ReduceMax, Sub}
    mt = masked.outputs[0]
    cons = ga.consumers.get(mt, [])
    if mt in ga.out_names or len(cons) != 2:
        return None
    mx = next((n for n in cons if n.op_type == "ReduceMax"), None)
    d = next((n for n in cons if n.op_type == "Sub"), None)
    if mx is None or d is None:
        return None
    if list(mx.attrs.get("axes", [])) != [2] or not mx.attrs.get("keepdims", 1):
        return None
    if ga.single_consumer(mx.outputs[0]) is not d or list(d.inputs) != [mt, mx.outputs[0]]:
        return None

    dq = nxt(d.outputs[0], "QuantizeLinear")
    if dq is None or not _is_zero_zp_ql(ga, dq, None, "int8"):
        return None
    lut_scale = float(np.asarray(ga.const(dq.inputs[1])))
    idx32 = nxt(dq.outputs[0], "Cast")
    if idx32 is None or idx32.attrs.get("to") != "int32":
        return None
    idxadd = nxt(idx32.outputs[0], "Add")
    if idxadd is None:
        return None
    off_t = idxadd.inputs[1] if idxadd.inputs[0] == idx32.outputs[0] else idxadd.inputs[0]
    off = ga.const(off_t)
    if off is None or np.asarray(off).size != 1 or int(np.asarray(off)) != 128:
        return None
    gather = nxt(idxadd.outputs[0], "Gather")
    if gather is None or int(gather.attrs.get("axis", 0)) != 0:
        return None
    lut = ga.const(gather.inputs[0])
    if lut is None or lut.shape != (256,) or lut.dtype != np.uint8 or lut[0] != 0:
        return None

    # LUT weights fan into exactly the int32 (denominator) and f32
    # (numerator) casts
    wt = gather.outputs[0]
    wcons = ga.consumers.get(wt, [])
    if wt in ga.out_names or len(wcons) != 2 or any(n.op_type != "Cast" for n in wcons):
        return None
    wi = next((n for n in wcons if n.attrs.get("to") == "int32"), None)
    wf = next((n for n in wcons if n.attrs.get("to") == "float32"), None)
    if wi is None or wf is None:
        return None
    den = nxt(wi.outputs[0], "ReduceSum")
    if den is None or list(den.attrs.get("axes", [])) != [2] or not den.attrs.get("keepdims", 1):
        return None
    denf = nxt(den.outputs[0], "Cast")
    if denf is None or denf.attrs.get("to") != "float32":
        return None
    p = nxt(wf.outputs[0], "Div")
    if p is None or ga.single_consumer(denf.outputs[0]) is not p:
        return None
    if list(p.inputs) != [wf.outputs[0], denf.outputs[0]]:
        return None
    pmul = nxt(p.outputs[0], "Mul")
    if pmul is None:
        return None
    p_scale = _scalar_operand(ga, pmul, p.outputs[0])
    if p_scale is None:
        return None
    pq = nxt(pmul.outputs[0], "QuantizeLinear")
    if pq is None or not _is_zero_zp_ql(ga, pq, 1.0, "int8"):
        return None

    ctx = nxt(pq.outputs[0], "MatMulInteger")
    if ctx is None or ctx.inputs[0] != pq.outputs[0]:
        return None
    v = ctx.inputs[1]
    if ga.is_const(v) or ga.dtype(v) != "int8":
        return None
    cf = nxt(ctx.outputs[0], "Cast")
    if cf is None or cf.attrs.get("to") != "float32":
        return None
    cmul = nxt(cf.outputs[0], "Mul")
    if cmul is None:
        return None
    rescale = _scalar_operand(ga, cmul, cf.outputs[0])
    if rescale is None:
        return None
    out_ql = ga.single_consumer(cmul.outputs[0])
    if out_ql is None or out_ql.op_type != "QuantizeLinear":
        return None
    s_out, zp_out = ql_params(ga, out_ql)
    if (
        s_out is None or zp_out is None or np.asarray(s_out).size != 1
        or float(np.asarray(s_out)) != 1.0 or int(np.asarray(zp_out)) != 0
    ):
        return None

    sq, sk = ga.shape(q), ga.shape(k)
    if sq is None or sk is None or len(sq) != 3 or len(sk) != 3:
        return None
    if not isinstance(sq[2], int):
        return None
    nodes = (
        tr, anchor, cast1, mul_c, sm, sub1, pen, masked, mx, d, dq, idx32,
        idxadd, gather, wi, den, denf, wf, p, pmul, pq, ctx, cf, cmul, out_ql,
    )
    return {
        "nodes": nodes,
        "q": q, "k": k, "v": v, "mask": mask,
        "out": out_ql.outputs[0],
        "out_dtype": str(np.asarray(zp_out).dtype),
        "qk_scale": qk_scale, "big": big, "lut_scale": lut_scale,
        "p_scale": p_scale, "rescale": rescale, "lut": lut,
        "b": tuple(sq[:1]), "s": sq[1], "t": sk[1], "dh": int(sq[2]),
        "anchor": anchor,
    }


def _qattention_captures(ga: GraphAnalysis) -> List[dict]:
    """Every attention region of the graph, in node order of anchors."""
    return [m for m in (_match_qattention(ga, n) for n in ga.graph.nodes
                        if n.op_type == "MatMulInteger") if m]


def qattention_exempt_nodes(ga: GraphAnalysis) -> frozenset:
    """Names of every node inside a matched attention region: the nodes the
    padding proof exempts (see :data:`REGIONS`)."""
    return frozenset(n.name for m in _qattention_captures(ga) for n in m["nodes"])


def _build_qattention(compiler: "Compiler", m: dict) -> Optional[StepDraft]:
    """Lower a matched attention region onto the fused ``qattention`` kernel.
    Scalar constants ride in ``params``; the LUT is the step's one array
    const.  With dynamic axes the shape record stays open
    (``dynamic_attn``) and is bound per bucket by ``specialize_plan``; a
    static compile with symbolic dims falls back unfused instead."""
    shape = {"b": m["b"], "s": m["s"], "t": m["t"], "dh": m["dh"]}
    params = {
        "out_dtype": m["out_dtype"],
        "qk_scale": m["qk_scale"], "big": m["big"],
        "lut_scale": m["lut_scale"], "p_scale": m["p_scale"],
        "rescale": m["rescale"],
    }
    if compiler.batch == "dynamic":
        params["shape"] = shape
        params["dynamic_attn"] = True
    else:
        dims = list(m["b"]) + [m["s"], m["t"]]
        if not all(isinstance(d, int) for d in dims):
            return None  # symbolic dims without dynamic axes: stay unfused
        params["shape"] = kops.bind_qattention_axes(shape, {})
    return StepDraft(
        "qattention",
        [tensor_arg(m["q"]), tensor_arg(m["k"]), tensor_arg(m["v"]), tensor_arg(m["mask"])],
        [m["out"]],
        params=params, consts=(_dev(compiler, m["lut"]),),
        kind="fused_qattention", name=m["anchor"].name,
    )


def _match_kv_write(ga: GraphAnalysis, add: Node, states: frozenset) -> Optional[dict]:
    """Match the codified KV update ``Add(Mul(S, Sub(1, H)), Mul(X, H))``
    at its Add, on structure only: ``S`` a declared state input, int8
    ``(N, R, W)``; ``H`` int8 ``(N, R, 1)``; ``X`` int8 ``(N, 1, W)``; the
    constant an int8 1; each Mul and the Sub read by the region alone
    (either operand order of a Mul or the Add).  Returns the capture for
    :func:`_build_kv_write`, or None."""
    if add.op_type != "Add" or len(add.inputs) != 2:
        return None
    muls = [ga.producers.get(t) for t in add.inputs]
    if any(m is None or m.op_type != "Mul" or ga.single_consumer(t) is not add
           for m, t in zip(muls, add.inputs)):
        return None
    for kept, put in (muls, muls[::-1]):
        for s, keep in (kept.inputs, kept.inputs[::-1]):
            sub = ga.producers.get(keep)
            if s not in states or sub is None or sub.op_type != "Sub" \
                    or ga.single_consumer(keep) is not kept:
                continue
            one, h = sub.inputs
            c = ga.const(one)
            if c is None or c.dtype != np.int8 or c.size != 1 or int(c.reshape(())) != 1 \
                    or h not in put.inputs:
                continue
            x = put.inputs[1] if put.inputs[0] == h else put.inputs[0]
            shape = ga.shape(s)
            if any(ga.dtype(t) != "int8" for t in (s, h, x)) or shape is None or len(shape) != 3:
                continue
            n, r, w = shape
            if tuple(ga.shape(h) or ()) != (n, r, 1) or tuple(ga.shape(x) or ()) != (n, 1, w):
                continue
            return {"s": s, "h": h, "x": x, "out": add.outputs[0], "nodes": (sub, kept, put, add),
                    "anchor": add}
    return None


def _kv_write_captures(ga: GraphAnalysis) -> List[dict]:
    """Every codified KV update of a declared state, in node order."""
    states = frozenset(s.input for s in ga.graph.states)
    return [m for m in (_match_kv_write(ga, n, states) for n in ga.graph.nodes) if m]


def _build_kv_write(compiler: "Compiler", m: dict) -> StepDraft:
    """Lower a matched KV update onto one ``kv_write`` step
    (``backend/fused.py``); it needs no per-bucket binding."""
    return StepDraft(
        "kv_write", [tensor_arg(m["s"]), tensor_arg(m["h"]), tensor_arg(m["x"])], [m["out"]],
        kind="fused_kv_write", name=m["anchor"].name,
    )


def _build_qmoe(compiler: "Compiler", m: dict) -> StepDraft:
    """Lower a matched routed-expert region (:mod:`repro_torch.core.moe`)
    onto one ``qmoe`` step: the weights laid out once on the device
    (:func:`repro_torch.kernels.qmoe.prepare`), the exp and SiLU tables as
    the last two consts, the scalars in ``params["moe"]``.  The step reads
    the token count from its input, so it needs no per-bucket binding."""
    wr, gu, wd = _kqmoe.prepare(*(_dev(compiler, m[k]) for k in ("router", "gate", "up", "down")))
    moe = {
        "top_k": m["top_k"], "router_scale": m["router_scale"], "lut_scale": m["lut_scale"],
        "p_scale": m["p_scale"], "gate": tuple(m["gate_scales"]), "up": tuple(m["up_scales"]),
        "down": tuple(m["down_scales"]), "h_scale": m["h_scale"], "out_rescale": m["out_rescale"],
    }
    return StepDraft(
        "qmoe", [tensor_arg(m["x"])], [m["out"]],
        params={"moe": moe},
        consts=(wr, gu, wd, _dev(compiler, m["exp_lut"]), _dev(compiler, m["silu"])),
        kind="fused_qmoe", name=m["anchor"].name,
    )


#: The compiler's region table: multi-node DAG regions, each lowered to one
#: step.  An entry is (provenance pattern name, finder returning every
#: capture in node order, plan-step builder, exempt from the padding proof).
#: Every capture carries its ``nodes``, its ``out`` tensor and its
#: ``anchor``; the step is emitted at the member that produces ``out``.
#: Exempt regions make zero padding exact along any axis by their own
#: semantics, which the per-op proof
#: (:func:`repro_torch.passes.analysis.axis_mixing_nodes`) cannot see: a
#: padded key carries a zero mask, its score is driven to −big and its LUT
#: weight is exactly ``lut[0] == 0`` (the matcher checks this), so it adds
#: nothing to the softmax denominator or the context, and padded query rows
#: give finite garbage (the denominator is never 0) that slicing discards;
#: the experts work token by token, reducing over the expert axis only.
REGIONS = (
    ("qattention", _qattention_captures, _build_qattention, True),
    ("qmoe", qmoe_regions, _build_qmoe, True),
    ("kv_write", _kv_write_captures, _build_kv_write, False),
)


class Compiler:
    def __init__(
        self,
        model: Model,
        *,
        backend: str = "cuda",
        device=None,
        fuse: bool = True,
        optimize: bool = True,
        verify_passes: bool = False,
        batch: str = "static",
        dynamic_axes: Optional[Dict[str, object]] = None,
        plan_cache_capacity: int = PlanCache.DEFAULT_CAPACITY,
        plan_cache: Optional[PlanCache] = None,
        autotune=None,
    ) -> None:
        if backend not in BACKENDS:
            raise ValueError(f"backend must be one of {BACKENDS}, got {backend!r}")
        self.device = resolve_device(device)
        self.autotuner = _resolve_autotuner(autotune)
        model.validate()
        if batch not in ("static", "dynamic"):
            raise ValueError(f"batch must be 'static' or 'dynamic', got {batch!r}")
        if batch == "dynamic" and dynamic_axes is None:
            # PR 4 sugar: dynamic over the (implicit or named) batch axis
            dynamic_axes = {BATCH_AXIS: None}
        if dynamic_axes:
            batch = "dynamic"
        available = graph_axes(model.graph)
        if batch == "dynamic":
            missing = sorted(set(dynamic_axes) - set(available))
            if missing:
                raise ValueError(
                    f"dynamic axes {missing} are not symbolic in any graph input "
                    f"signature (available: {list(available) or 'none'}) — "
                    "declare them as named dims, e.g. ('N', 'S', 64), or use a "
                    "(None, ...) leading dim for the implicit batch axis"
                )
            # an axis may appear at several positions of one signature (an
            # attention mask is ("N", "S", "S")): run-time padding/slicing
            # handles every occurrence (axis_input_positions below)
        if optimize:
            model, self.pass_report = PassManager(verify=verify_passes).run(model)
        else:
            self.pass_report = PipelineReport(
                nodes_before=len(model.graph.nodes), nodes_after=len(model.graph.nodes)
            )
        # provenance: the how-this-plan-came-to-be record the plan will carry
        tracer = _trace.current()
        self.provenance = PlanProvenance(
            nodes_before=self.pass_report.nodes_before,
            nodes_after=self.pass_report.nodes_after,
            pass_iterations=self.pass_report.iterations,
            trace_id=tracer.trace_id if tracer is not None else None,
        )
        for e in self.pass_report.entries:
            if e.changed:
                self.provenance.add_pass(e.iteration, e.name, e.counters)
        self.model = model
        self.graph = model.graph
        self.backend = backend
        self.fuse = fuse
        self.batch = batch
        # preserve the graph's axis declaration order for stable plan axes
        if batch == "dynamic":
            self.dynamic_axes = {
                a: resolve_bucketing(dynamic_axes.get(a)) for a in available if a in dynamic_axes
            }
            # raw (pre-resolution) bucketing specs: what an AOT artifact
            # serializes, since the resolved policies are callables
            self.axis_specs = {
                a: dynamic_axes.get(a) for a in available if a in dynamic_axes
            }
        else:
            self.dynamic_axes = {}
            self.axis_specs = {}
        self.plan_cache_capacity = plan_cache_capacity
        self.plan_cache = plan_cache
        self.inits = {k: v for k, v in self.graph.initializers.items()}
        self.analysis = GraphAnalysis(self.graph)
        # every region is matched once, here: the fuse loop lowers the
        # captures, and the padding proof below exempts the exempt ones
        self.regions = [
            (pattern, build, exempt, m) for pattern, find, build, exempt in REGIONS
            if fuse or (batch == "dynamic" and exempt) for m in find(self.analysis)
        ]
        if batch == "dynamic":
            # zero padding along a dynamic axis is only exact when no op
            # mixes information across it — prove each requested axis
            # independently and reject (rather than silently mis-serve)
            # graphs with e.g. a global ReduceMean or an axis-folding Reshape
            # (the exempt regions aside: see REGIONS).
            implicit = implicit_batch_graph(self.graph)
            exempt = frozenset(n.name for _, _, ex, m in self.regions if ex for n in m["nodes"])
            for axis in self.dynamic_axes:
                problems = axis_mixing_nodes(
                    self.analysis, axis, implicit=implicit, exempt=exempt
                )
                if problems:
                    raise ValueError(
                        f"dynamic axis {axis!r} needs every op to be "
                        "batch-elementwise along it; cannot prove that for:\n  "
                        + "\n  ".join(problems)
                        + "\ncompile with batch='static' instead"
                    )
        self.stats = {
            "fused_qlinear": 0,
            "fused_qconv": 0,
            "fused_lut": 0,
            "lut_epilogues": 0,
            "fused_qattention": 0,
            "fused_qmoe": 0,
            "fused_kv_write": 0,
            "generic": 0,
            "folded": self.pass_report.total("folded"),
            "eliminated": self.pass_report.total("eliminated"),
        }

    # -- main ---------------------------------------------------------------
    def compile(self) -> "CompiledModel":
        order = self.graph.toposorted()
        consumed = set()
        drafts: List[StepDraft] = []
        # a region is a DAG whose members straddle its anchor in topo order
        # (the K-Transpose precedes the attention's anchor, V may be produced
        # after it): skip members as they stream past, and emit the fused step
        # at the region's sink — the one position where every region input is
        # guaranteed already produced
        region_emit: Dict[int, StepDraft] = {}
        region_skip: set = set()
        for pattern, build, _, m in (self.regions if self.fuse else ()):
            draft = build(self, m)
            if draft is None:
                continue  # e.g. attention over symbolic dims in a static compile
            sink = next(n for n in m["nodes"] if m["out"] in n.outputs)
            region_emit[id(sink)] = draft
            region_skip.update(id(n) for n in m["nodes"] if n is not sink)
            self.provenance.add_fusion(pattern, m["anchor"].name,
                                       tuple(n.name for n in m["nodes"]), m["out"])
        with _trace.span("compile.fuse", nodes=len(order)) as fuse_span:
            for node in order:
                if id(node) in consumed or id(node) in region_skip:
                    continue
                if id(node) in region_emit:
                    draft = region_emit[id(node)]
                else:
                    draft = self._fused_draft(node, consumed) if self.fuse else None
                    if draft is None:
                        draft = self._generic_draft(node)
                drafts.append(draft)
                self.stats[draft.kind] += 1
            fuse_span.set(
                fused=len(self.provenance.fusions),
                generic=self.stats["generic"],
            )
        if self.backend == "cuda":
            drafts = self._fold_lut_epilogues(drafts)
        for d in drafts:
            lookup(self.backend, d.kernel)  # an unported kernel fails here, not mid-run
        with _trace.span("compile.lower", steps=len(drafts)) as lower_span:
            plan = build_plan(
                self.graph, self.analysis, drafts, self.backend,
                batch=self.batch, axes=tuple(self.dynamic_axes),
                provenance=self.provenance,
            )
            lower_span.set(slots=plan.num_slots)
        self.stats["plan_slots"] = plan.num_slots
        return CompiledModel(
            self.model, plan, self.stats, self.pass_report,
            plan_cache_capacity=self.plan_cache_capacity,
            plan_cache=self.plan_cache,
            dynamic_axes=self.dynamic_axes,
            axis_specs=self.axis_specs,
            autotuner=self.autotuner,
            device=self.device,
        )

    def _fold_lut_epilogues(self, drafts: List[StepDraft]) -> List[StepDraft]:
        """Fold each ``qact_lut`` draft into the ``qlinear_matmul`` draft
        that produces its input, where nothing else reads that input and it
        is neither a graph output nor a state: the matmul takes the table as
        its fifth const and writes the LUT's output, and ``params["lut"]``
        names the activation.  Where the table is uint8 and every reader of
        the LUT's output is a matmul with ``x_uint8`` (the Sigmoid → FC of
        the paper's Fig 6 flow), and that output is neither a graph output
        nor a state, the table is stored shifted (``u - 128`` as int8, the
        value typed int8) and those readers drop ``x_uint8``: their bias
        already holds the fold for ``u - 128``, so they launch no shift.
        ``stats["fused_lut"]`` keeps counting LUT matches;
        ``stats["lut_epilogues"]`` counts folds.  A matmul folds one table
        at most (of a LUT → LUT chain only the first LUT folds), and conv
        steps do not fold."""
        pinned = {t.name for t in self.graph.outputs}
        pinned.update(n for st in self.graph.states for n in (st.input, st.output))
        readers: Dict[str, List[StepDraft]] = {}
        producer: Dict[str, StepDraft] = {}
        for d in drafts:
            for kind, val in d.args:
                if kind == "tensor":
                    readers.setdefault(val, []).append(d)
            producer.update((o, d) for o in d.outputs)
        folded = set()
        for lut in drafts:
            if lut.kernel != "qact_lut":
                continue
            x, y = lut.args[0][1], lut.outputs[0]
            mm = producer.get(x)
            if (mm is None or mm.kernel != "qlinear_matmul" or "lut" in mm.params
                    or x in pinned or len(readers[x]) != 1):
                continue  # a matmul that already carries a table takes no second
            (table,) = lut.consts
            record = lut.params["act"]
            users = readers.get(y, [])
            if table.dtype == torch.uint8:
                if users and y not in pinned and all(
                        r.kernel == "qlinear_matmul" and r.params.get("x_uint8") for r in users):
                    table = kops.shift_uint8(table)
                    record += ",u8-128"
                    mm.out_dtypes = ("int8",)
                    for r in users:
                        r.params = {k: v for k, v in r.params.items() if k != "x_uint8"}
                else:
                    record += ",u8"
            mm.consts = tuple(mm.consts) + (table,)
            mm.outputs = [y]
            mm.params = {**mm.params, "lut": record}
            producer[y] = mm
            folded.add(id(lut))
            self.stats["lut_epilogues"] += 1
            self.provenance.add_fusion("lut_epilogue", mm.name, (mm.name, lut.name), y)
        return [d for d in drafts if id(d) not in folded]

    def _fused_draft(self, node: Node, consumed: set) -> Optional[StepDraft]:
        for pattern, builder in FUSIONS:
            if node.op_type not in pattern.anchor_ops:
                continue
            m = match_chain(self.analysis, node, pattern)
            if m is None:
                continue
            draft = builder(self, m)
            if draft is None:
                continue
            consumed.update(id(n) for n in m.nodes)
            self.provenance.add_fusion(
                pattern.name, m.anchor.name,
                tuple(n.name for n in m.nodes), m.out_tensor,
            )
            return draft
        return None

    def _generic_draft(self, node: Node) -> StepDraft:
        if node.op_type not in _TOPS:
            raise NotImplementedError(f"compiler has no lowering for op {node.op_type!r}")
        shape_operands = SHAPE_OPERANDS.get(node.op_type, ())
        args = []
        for i, name in enumerate(node.inputs):
            if not name:
                args.append(none_arg())
            elif name in self.inits:
                value = np.asarray(self.inits[name])
                args.append(const_arg(value if i in shape_operands else _dev(self, value)))
            else:
                args.append(tensor_arg(name))
        return StepDraft(
            f"op.{node.op_type}", args, list(node.outputs),
            params={"attrs": node.attrs}, kind="generic", name=node.name,
        )


class CompiledModel:
    """A compiled artifact: typed ExecutionPlan on a device + fusion report.
    ``print(cm.plan)`` shows the full lowering.  :meth:`run` takes numpy
    arrays or tensors and returns tensors on the plan's device.

    With dynamic axes the held plan is a shape-generic *template*:
    :meth:`run` reads each dynamic axis's true extent off the feeds, pads
    every axis-carrying feed to that axis's bucket (per-axis bucketing
    policy — power-of-two by default), binds the template to the bucket
    combination through a bounded :class:`~repro_torch.backend.plan.PlanCache`
    keyed on the sorted bindings (at most one specialization per resident
    combination), executes, and slices results back to
    the true extents along every axis position they carry.  Zero padding is
    exact because dynamic compilation *proves* it per axis: the compiler
    rejects any graph with an op it cannot show to be elementwise along each
    requested axis (:func:`repro_torch.passes.analysis.axis_mixing_nodes`), and
    the conformance sweep pins dynamic == per-shape-static == reference,
    bit for bit, over the whole bucket grid."""

    def __init__(
        self,
        model: Model,
        plan: ExecutionPlan,
        stats: Dict[str, int],
        pass_report: Optional[PipelineReport] = None,
        *,
        plan_cache_capacity: int = PlanCache.DEFAULT_CAPACITY,
        plan_cache: Optional[PlanCache] = None,
        dynamic_axes: Optional[Dict[str, object]] = None,
        axis_specs: Optional[Dict[str, object]] = None,
        autotuner=None,
        device=None,
    ) -> None:
        self.model = model
        self.plan = plan
        self.device = resolve_device(device)
        self.plan_cache_capacity = plan_cache_capacity
        #: per-axis raw bucketing specs (None / int / callable) as declared at
        #: compile time — the serializable counterpart of ``dynamic_axes``,
        #: whose values are already-resolved policy callables
        if plan.batch == "dynamic":
            self.axis_specs: Dict[str, object] = (
                dict(axis_specs) if axis_specs is not None else {a: None for a in plan.axes}
            )
        else:
            self.axis_specs = {}
        #: optional repro_torch.backend.autotune.Autotuner — when set, every
        #: lazy specialization routes its tiling through the measured search
        self.autotuner = autotuner
        self.steps = plan.steps
        self.stats = stats
        self.pass_report = pass_report if pass_report is not None else PipelineReport()
        self.input_names = [t.name for t in model.graph.inputs]
        self.output_names = [t.name for t in model.graph.outputs]
        if plan.batch == "dynamic":
            # a shared cache (plan_cache=) pools specializations across
            # several artifacts (e.g. a prefill and a decode plan serving one
            # token path); cache_key() then prefixes the graph name so the
            # artifacts never collide on identical bindings
            self._shared_cache = plan_cache is not None
            self.plan_cache: Optional[PlanCache] = (
                plan_cache if plan_cache is not None
                else PlanCache(plan_cache_capacity, scope="plan")
            )
            self.dynamic_axes: Dict[str, object] = {
                a: resolve_bucketing(None) for a in plan.axes
            }
            if dynamic_axes:
                self.dynamic_axes.update(dynamic_axes)
            implicit = implicit_batch_graph(model.graph)
            # where each dynamic axis sits in each input: axis -> {input:
            # (pos, ...)} — every occurrence (a mask signature like
            # ("N", "S", "S") carries an axis twice and every position must
            # be padded)
            self.axis_input_positions: Dict[str, Dict[str, tuple]] = {}
            for axis in self.dynamic_axes:
                by_input = {}
                for t in model.graph.inputs:
                    pos = axis_positions(tuple(t.shape), axis, implicit=implicit)
                    if pos:
                        by_input[t.name] = pos
                self.axis_input_positions[axis] = by_input
            # the first position of each, as the compiled-model server reads it
            self.axis_input_pos: Dict[str, Dict[str, int]] = {
                axis: {name: pos[0] for name, pos in by_input.items()}
                for axis, by_input in self.axis_input_positions.items()
            }
            # axis-carrying outputs get sliced back to the true extents;
            # positions come from the declared signature with the plan's
            # inferred value shapes as fallback, so an output mis-declared
            # with a concrete dim is still recognized as axis-carrying
            inferred = {
                name: info.shape
                for step in plan.steps
                for name, info in zip(step.outputs, step.out_info)
            }
            self.output_axis_positions: Dict[str, Dict[str, tuple]] = {}
            for t in model.graph.outputs:
                by_axis = {}
                for axis in self.dynamic_axes:
                    pos = axis_positions(tuple(t.shape), axis, implicit=implicit)
                    if not pos:
                        pos = axis_positions(inferred.get(t.name), axis, implicit=implicit)
                    if pos:
                        by_axis[axis] = pos
                if by_axis:
                    self.output_axis_positions[t.name] = by_axis
            self.output_axis_pos: Dict[str, Dict[str, int]] = {
                name: {axis: pos[0] for axis, pos in by_axis.items()}
                for name, by_axis in self.output_axis_positions.items()
            }
        else:
            self._shared_cache = False
            self.plan_cache = None
            self.dynamic_axes = {}
            self.axis_input_positions = {}
            self.axis_input_pos = {}
            self.output_axis_positions = {}
            self.output_axis_pos = {}

    @property
    def backend(self) -> str:
        return self.plan.backend

    # -- single-axis views (the batch axis) ---------------------------------
    @property
    def batch_input_names(self) -> List[str]:
        """Inputs carrying the batch axis."""
        return list(self.axis_input_pos.get(BATCH_AXIS, {}))

    @property
    def batch_output_names(self) -> set:
        """Outputs carrying the batch axis."""
        return {k for k, v in self.output_axis_pos.items() if BATCH_AXIS in v}

    @property
    def is_dynamic(self) -> bool:
        return self.plan.batch == "dynamic"

    def _tensor(self, v) -> torch.Tensor:
        """A feed as a tensor on the plan's device (numpy arrays copy once)."""
        if isinstance(v, torch.Tensor):
            return v.to(self.device)
        return host_to_device(np.asarray(v), self.device)

    def run(self, feeds: Dict[str, object]) -> Dict[str, torch.Tensor]:
        if self.is_dynamic:
            return self._run_dynamic(feeds)
        return self.plan.execute({k: self._tensor(v) for k, v in feeds.items()})

    def __call__(self, **feeds) -> Dict[str, torch.Tensor]:
        return self.run(feeds)

    # -- scenario-specialized execution -------------------------------------
    def bucket_for(self, axis: str, extent: int) -> int:
        """The padded bucket for a true extent along ``axis`` under that
        axis's bucketing policy."""
        return int(self.dynamic_axes[axis](int(extent)))

    def cache_key(self, bindings) -> tuple:
        """The plan-cache key for a bucket combination.  On a private cache
        this is exactly :func:`~repro_torch.backend.plan.bindings_key` (existing
        keys, artifacts and tests stay valid); on a shared cache the graph
        name is prefixed so two artifacts pooling one cache (prefill +
        decode) never collide on identical bindings."""
        if not isinstance(bindings, dict):
            bindings = {BATCH_AXIS: int(bindings)}
        key = bindings_key(bindings)
        return (self.model.graph.name, key) if self._shared_cache else key

    def specialized(self, bindings):
        """The (plan, executor) pair for a bucket combination,
        specializing lazily through the bounded plan cache.  ``bindings`` is
        an axis→bucket dict (a bare int is sugar for the batch axis).
        ``cache_stats`` counts a miss (== one specialization) only on first
        use of a resident combination; binding order never splits cache
        entries (keys are the sorted bindings)."""
        if not self.is_dynamic:
            raise ValueError("specialized() is only meaningful on a dynamic compile")
        if not isinstance(bindings, dict):
            bindings = {BATCH_AXIS: int(bindings)}
        unknown = sorted(set(bindings) - set(self.dynamic_axes))
        if unknown:
            raise ValueError(
                f"unknown dynamic axes {unknown}: this artifact is open over "
                f"{list(self.dynamic_axes)}"
            )
        entry = self.plan_cache.get(self.cache_key(bindings))
        return entry if entry is not None else self.install(bindings, self.autotuner)

    def install(self, bindings: Dict[str, int], tuner) -> tuple:
        """Put the ``(plan, executor)`` entry of a bucket combination in the
        plan cache, replacing any it has, and return it: the template
        specialized with ``tuner`` (None: heuristic tiles) and the executor
        :func:`~repro_torch.backend.graph.executor_for` picks, counting into
        the cache's ``graph_stats``.  The only maker of entries; it counts
        no hit and no miss."""
        plan = specialize_plan(self.plan, bindings, tuner=tuner)
        entry = (plan, executor_for(plan, self.device, self.plan_cache.graph_stats))
        self.plan_cache.put(self.cache_key(bindings), entry)
        return entry

    @property
    def cache_stats(self) -> Dict[str, int]:
        """Plan-cache counters (size/capacity/hits/misses/evictions/
        hit_rate); misses double as the number of specializations.  These
        legacy flat keys stay for one release — the canonical scheme is
        ``cache.plan.<field>`` in a :class:`~repro_torch.obs.metrics.
        MetricsRegistry` (see :meth:`attach_metrics`)."""
        if self.plan_cache is None:
            return {}
        return self.plan_cache.stats

    def attach_metrics(self, registry: MetricsRegistry) -> None:
        """Publish this artifact's plan-cache stats into ``registry`` under
        the canonical ``cache.plan.*`` keys (live callback gauges)."""
        if self.plan_cache is not None:
            self.plan_cache.attach_metrics(registry)

    def _run_dynamic(self, feeds: Dict[str, object]) -> Dict[str, torch.Tensor]:
        extents: Dict[str, int] = {}
        for axis, by_input in self.axis_input_positions.items():
            vals = {
                int(feeds[name].shape[pos])
                for name, positions in by_input.items()
                if name in feeds
                for pos in positions
            }
            if len(vals) != 1:
                raise ValueError(
                    f"inputs {sorted(by_input)} carrying dynamic axis {axis!r} "
                    f"must all be fed with one common extent, got {sorted(vals)}"
                )
            extents[axis] = vals.pop()
        bindings = {axis: self.bucket_for(axis, ext) for axis, ext in extents.items()}
        _, fn = self.specialized(bindings)
        with _trace.span("run.pad"):
            padded: Dict[str, torch.Tensor] = {}
            for name, v in feeds.items():
                v = self._tensor(v)
                shape = list(v.shape)
                for axis, by_input in self.axis_input_positions.items():
                    for pos in by_input.get(name, ()):
                        # zero slabs are exact: dynamic compilation proved
                        # every op elementwise along the axis (or the
                        # region's masking makes padding inert), and the
                        # padding is sliced away below
                        shape[pos] = bindings[axis]
                if shape != list(v.shape):
                    grown = torch.zeros(shape, dtype=v.dtype, device=v.device)
                    grown[tuple(slice(0, d) for d in v.shape)] = v
                    v = grown
                padded[name] = v
        res = fn(padded)
        with _trace.span("run.slice"):
            out: Dict[str, torch.Tensor] = {}
            for k, v in res.items():
                by_axis = self.output_axis_positions.get(k)
                if by_axis:
                    slicer = [slice(None)] * v.ndim
                    for axis, positions in by_axis.items():
                        for pos in positions:
                            slicer[pos] = slice(0, extents[axis])
                    v = v[tuple(slicer)]
                out[k] = v
            return out


def _resolve_autotuner(autotune):
    """Normalize the ``compile_model(autotune=...)`` sugar to an Autotuner
    (or None): True → in-memory session, a path → persistent tile cache,
    a tuner instance → as-is.  Tuners are duck-typed on the ``tune_step``
    contract (not ``isinstance``) so injected test doubles — and the module
    run under ``python -m``, where the class exists twice — both work."""
    if not autotune:
        return None
    from ..backend.autotune import Autotuner

    if autotune is True:
        return Autotuner()
    if hasattr(autotune, "tune_step"):
        return autotune
    return Autotuner(cache=str(autotune))


def compile_model(
    model: Model,
    *,
    backend: str = "cuda",
    device=None,
    fuse: bool = True,
    optimize: bool = True,
    verify_passes: bool = False,
    batch: str = "static",
    dynamic_axes: Optional[Dict[str, object]] = None,
    plan_cache_capacity: int = PlanCache.DEFAULT_CAPACITY,
    plan_cache: Optional[PlanCache] = None,
    autotune=None,
) -> CompiledModel:
    """Compile a PQ-IR artifact for a torch device.

    backend:       "cuda" (the planned path: padded, laid-out, int4-packed
                   parameters and the hand-written CUDA kernels, whose
                   wrappers run their plain version on CPU tensors) or "ref"
                   (plain torch oracles on unpadded parameters).
    device:        where the plan runs; None means the CUDA card, and raises
                   when there is none — pass "cpu" for the CPU.
    optimize:      run the :mod:`repro_torch.passes` pipeline first (the caller's
                   artifact is cloned, never mutated).
    verify_passes: turn on the pipeline's reference-runtime conformance hook
                   (asserts each pass is semantics-preserving on probe
                   inputs before the backend ever sees the graph).
    batch:         "static" specializes shapes once at plan time (classic
                   behavior); "dynamic" is single-axis sugar for
                   ``dynamic_axes={"N": None}`` — a batch-polymorphic plan
                   *template* bound lazily to power-of-two batch buckets at
                   run time.
    dynamic_axes:  named symbolic axes to leave open in the plan template,
                   mapped to per-axis bucketing specs: ``None`` →
                   power-of-two buckets, an int g → round up to multiples of
                   g (sequence-length style), a callable → custom policy.
                   Axes must appear in the graph's input signatures (named
                   dims like ``("N", "S", 64)``; a legacy ``(None, …)``
                   leading dim is the implicit batch axis ``"N"``).  One
                   artifact then serves the whole scenario grid with at most
                   one specialization per visited bucket combination.
    plan_cache_capacity:
                   bound on resident per-bucket specializations (dynamic
                   mode; LRU-evicted beyond this).
    plan_cache:    an existing :class:`~repro_torch.backend.plan.PlanCache` to
                   share across artifacts (e.g. one cache serving a prefill
                   and a decode plan of the same token path).  Keys are then
                   prefixed with the graph name (``cm.cache_key``), so pooled
                   artifacts never collide; capacity/accounting are the
                   shared cache's.
    autotune:      measured per-cell tile search (dynamic mode, ``cuda``
                   backend): ``True`` → an in-memory
                   :class:`repro_torch.backend.autotune.Autotuner` session,
                   a path → a session persisted to that JSON tile cache
                   (warm starts perform zero measurements), an Autotuner
                   instance → shared/injected (tests pass one with a
                   deterministic ``measure_fn``).  Each lazy specialization
                   then measures a budgeted, cost-model-seeded candidate
                   list of qmatmul ``(bm, splits)`` and qattention cluster
                   sizes on the card, and the plan provenance tags every
                   cell's tile source.  A CPU plan has no kernel to time:
                   its real measurement raises unless ``measure_fn`` is
                   injected.
    """
    with _trace.span(
        "compile", graph=model.graph.name, backend=backend,
        batch="dynamic" if (dynamic_axes or batch == "dynamic") else batch,
    ):
        return Compiler(
            model, backend=backend, device=device, fuse=fuse, optimize=optimize,
            verify_passes=verify_passes, batch=batch, dynamic_axes=dynamic_axes,
            plan_cache_capacity=plan_cache_capacity, plan_cache=plan_cache,
            autotune=autotune,
        ).compile()
