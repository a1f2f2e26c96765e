"""Builders for the paper's canonical pre-quantized ONNX patterns (Figs 1–6).

Each builder emits exactly the operator sequence shown in the paper into a
:class:`repro.core.pqir.GraphBuilder`:

* Fig 1 — FC, rescale as **two** Mul ops (integer Quant_scale + 2**-N shift)
* Fig 2 — FC + ReLU, rescale as **one** Mul op
* Fig 3 — Conv2D, rescale as one Mul op
* Fig 4 — FC + int8 Tanh (rescale maps accumulator onto tanh's input range,
  y_scale maps int8 onto tanh's output range)
* Fig 5 — FC + fp16 Tanh (mixed int8/fp16 flow)
* Fig 6 — FC + fp16 Sigmoid (output uint8, sigmoid ≥ 0)

The rounding/clipping stage is always ``QuantizeLinear(scale=1, zero_point=0)``
whose *zero_point dtype selects the output dtype* — exactly the paper's usage.
"""
from __future__ import annotations

from typing import Optional

import numpy as np

from .pqir import GraphBuilder
from .quant import QuantizedLinearParams, Rescale

# Default activation-range conventions for the Fig.4–6 patterns.
TANH_INPUT_ABSMAX = 4.0  # |tanh(4)| ≈ 0.9993: "full input range of tanh"
SIGMOID_INPUT_ABSMAX = 8.0

# Attention-region codification constants, shared by the emitter below, the
# kernel oracle (repro.kernels.ref.qattention_ref), the Pallas kernel and the
# compiler's region matcher.  The chain is bit-exact only because all four
# agree on these values and on the op order.
ATTN_BIG = 30000.0  # additive penalty driving masked scores below any real one
ATTN_LUT_SCALE = 0.125  # score-delta quantization step; must keep lut[0] == 0
ATTN_P_SCALE = 127.0  # probability quantization scale


def build_exp_lut(lut_scale: float = ATTN_LUT_SCALE) -> np.ndarray:
    """The 256-entry uint8 exp table the attention region gathers from:
    ``lut[i] = round(exp((i - 128) · lut_scale) · 255)`` clipped to uint8.
    Index 128 (score delta 0, the row max) maps to 255.  Index 0 (a delta
    clipped at −128 steps — masked or far-off keys) must map to exactly 0:
    that is what makes zero-padded keys contribute nothing to the softmax
    denominator, i.e. what makes bucket padding bit-exact."""
    i = np.arange(256, dtype=np.float64)
    vals = np.rint(np.exp(np.minimum(i - 128.0, 0.0) * float(lut_scale)) * 255.0)
    lut = np.clip(vals, 0, 255).astype(np.uint8)
    if lut[0] != 0:
        raise ValueError(
            f"lut_scale={lut_scale} too small: lut[0]={lut[0]} != 0 breaks "
            "zero-padding exactness (need exp(-128*scale)*255 < 0.5)"
        )
    return lut


def emit_qattention(
    gb: GraphBuilder,
    q: str,  # ("N", S, dh) int8 per-head queries
    k: str,  # ("N", T, dh) int8 per-head keys
    v: str,  # ("N", T, dh) int8 per-head values
    mask: str,  # ("N", S, T) f32 {0, 1} validity/causality mask
    prefix: str,
    *,
    qk_scale: float,  # s_q * s_k / sqrt(dh)
    rescale: float,  # s_v / (p_scale * s_out)
    big: float = ATTN_BIG,
    lut_scale: float = ATTN_LUT_SCALE,
    p_scale: float = ATTN_P_SCALE,
    out_dtype: str = "int8",
) -> str:
    """The codified int8 attention region: MatMulInteger score accumulation,
    additive {0, −big} masking, max-shifted LUT-softmax (exp as a 256-entry
    uint8 Gather — no transcendentals anywhere in the artifact), integer
    renormalization, and a second MatMulInteger against V.  Every op is
    integer or IEEE-exact f32 elementwise, so the region evaluates bit-
    identically on the numpy reference runtime, the jnp oracle and the fused
    Pallas kernel — which is what lets the compiler collapse all ~25 nodes
    into one ``qattention`` kernel step without a tolerance budget.

    Returns the int8 per-head context tensor name."""
    kt = gb.op("Transpose", [k], out_hint=f"{prefix}_kT", perm=[0, 2, 1])
    acc = gb.op("MatMulInteger", [q, kt], out_hint=f"{prefix}_scores_acc")
    f = gb.op("Cast", [acc], out_hint=f"{prefix}_scores_f32", to="float32")
    c = gb.add_initializer(f"{prefix}_qk_scale", np.float32(qk_scale))
    f = gb.op("Mul", [f, c], out_hint=f"{prefix}_scores")
    sm = gb.op("Mul", [f, mask], out_hint=f"{prefix}_scores_masked")
    one = gb.add_initializer(f"{prefix}_one", np.float32(1.0))
    big_c = gb.add_initializer(f"{prefix}_big", np.float32(big))
    pen = gb.op("Sub", [mask, one], out_hint=f"{prefix}_mask_m1")
    pen = gb.op("Mul", [pen, big_c], out_hint=f"{prefix}_penalty")
    masked = gb.op("Add", [sm, pen], out_hint=f"{prefix}_masked")
    mx = gb.op("ReduceMax", [masked], out_hint=f"{prefix}_rowmax", axes=[2], keepdims=1)
    d = gb.op("Sub", [masked, mx], out_hint=f"{prefix}_delta")
    ls = gb.add_initializer(f"{prefix}_lut_scale", np.float32(lut_scale))
    zp8 = gb.add_initializer(f"{prefix}_zp_i8", np.zeros((), dtype="int8"))
    dq = gb.op("QuantizeLinear", [d, ls, zp8], out_hint=f"{prefix}_delta_q")
    idx = gb.op("Cast", [dq], out_hint=f"{prefix}_idx32", to="int32")
    off = gb.add_initializer(f"{prefix}_idx_off", np.int32(128))
    idx = gb.op("Add", [idx, off], out_hint=f"{prefix}_idx")
    lut = gb.add_initializer(f"{prefix}_exp_lut", build_exp_lut(lut_scale))
    w = gb.op("Gather", [lut, idx], out_hint=f"{prefix}_w", axis=0)
    wi = gb.op("Cast", [w], out_hint=f"{prefix}_w_i32", to="int32")
    den = gb.op("ReduceSum", [wi], out_hint=f"{prefix}_den", axes=[2], keepdims=1)
    denf = gb.op("Cast", [den], out_hint=f"{prefix}_den_f32", to="float32")
    wf = gb.op("Cast", [w], out_hint=f"{prefix}_w_f32", to="float32")
    p = gb.op("Div", [wf, denf], out_hint=f"{prefix}_p")
    ps = gb.add_initializer(f"{prefix}_p_scale", np.float32(p_scale))
    pf = gb.op("Mul", [p, ps], out_hint=f"{prefix}_p_scaled")
    one_q = gb.add_initializer(f"{prefix}_pq_scale", np.float32(1.0))
    pq = gb.op("QuantizeLinear", [pf, one_q, zp8], out_hint=f"{prefix}_p_q")
    ctx = gb.op("MatMulInteger", [pq, v], out_hint=f"{prefix}_ctx_acc")
    cf = gb.op("Cast", [ctx], out_hint=f"{prefix}_ctx_f32", to="float32")
    r = gb.add_initializer(f"{prefix}_att_rescale", np.float32(rescale))
    cf = gb.op("Mul", [cf, r], out_hint=f"{prefix}_ctx_scaled")
    out_zp = gb.add_initializer(f"{prefix}_out_zp", np.zeros((), dtype=out_dtype))
    return gb.op("QuantizeLinear", [cf, one_q, out_zp], out_hint=f"{prefix}_ctx_q")


def _codify_scale(value, channel_tail: int) -> np.ndarray:
    """A rescale constant as codified in the artifact: a f32 scalar, or — per
    channel — a f32 vector reshaped to broadcast along the output-feature
    axis (``channel_tail`` trailing singleton dims: 0 for FC's (..., N)
    accumulators, 2 for conv's NCHW)."""
    v = np.asarray(value, np.float32)
    if v.ndim == 0:
        return v
    return v.reshape((-1,) + (1,) * channel_tail)


def emit_rescale(
    gb: GraphBuilder,
    x: str,
    rescale: Rescale,
    prefix: str,
    *,
    two_mul: bool = True,
    channel_tail: int = 0,
) -> str:
    """Cast(int32→f32) then the §3.1 codification: 2 Muls (integer scale +
    right-shift) or 1 Mul (plain fp32 multiplier).

    ``rescale`` may be a per-channel :class:`repro.core.quant.RescaleVector`,
    in which case the Mul constants are vectors along the output-feature axis
    (``channel_tail`` positions the channel axis for conv's NCHW layout)."""
    f = gb.op("Cast", [x], out_hint=f"{prefix}_f32", to="float32")
    if two_mul:
        qs = gb.add_initializer(f"{prefix}_quant_scale", _codify_scale(rescale.quant_scale, channel_tail))
        sh = gb.add_initializer(f"{prefix}_quant_shift", _codify_scale(rescale.quant_shift, channel_tail))
        f = gb.op("Mul", [f, qs], out_hint=f"{prefix}_scaled")
        f = gb.op("Mul", [f, sh], out_hint=f"{prefix}_shifted")
    else:
        m = gb.add_initializer(f"{prefix}_quant_multiplier", _codify_scale(rescale.multiplier, channel_tail))
        f = gb.op("Mul", [f, m], out_hint=f"{prefix}_scaled")
    return f


def emit_round_clip(gb: GraphBuilder, x: str, prefix: str, out_dtype: str = "int8") -> str:
    """QuantizeLinear(scale=1, zp=0) — pure rounding+clipping; zp dtype picks
    the output dtype (int8 vs uint8), per the paper."""
    one = gb.add_initializer(f"{prefix}_ql_scale", np.float32(1.0))
    zp = gb.add_initializer(f"{prefix}_ql_zp", np.zeros((), dtype=out_dtype))
    return gb.op("QuantizeLinear", [x, one, zp], out_hint=f"{prefix}_q")


def fc_layer(
    gb: GraphBuilder,
    x: str,
    p: QuantizedLinearParams,
    prefix: str,
    *,
    two_mul: bool = True,
    activation: Optional[str] = None,
) -> str:
    """Fig 1 (activation=None, two_mul=True) / Fig 2 (activation="Relu",
    two_mul=False) fully-connected pattern.  Returns the int8/uint8 output
    tensor name.

    Sub-8-bit weights (``p.bits == 4``) codify QONNX-style: the weight
    initializer stays an (unpacked) int8 tensor with values in [-8, 7] and
    the bitwidth rides as a ``weight_bits`` attribute on the integer-matmul
    node — the reference runtime ignores it, the compiler packs on it."""
    w = gb.add_initializer(f"{prefix}_weight_q", p.weight_q)
    attrs = {"weight_bits": p.bits} if p.bits != 8 else {}
    acc = gb.op("MatMulInteger", [x, w], out_hint=f"{prefix}_acc", **attrs)
    if p.bias_q is not None:
        b = gb.add_initializer(f"{prefix}_bias_q", p.bias_q)
        acc = gb.op("Add", [acc, b], out_hint=f"{prefix}_biased")
    f = emit_rescale(gb, acc, p.rescale, prefix, two_mul=two_mul)
    if activation is not None:
        f = gb.op(activation, [f], out_hint=f"{prefix}_{activation.lower()}")
    return emit_round_clip(gb, f, prefix, p.out_dtype)


def fc_layer_gemm(
    gb: GraphBuilder,
    x: str,
    p: QuantizedLinearParams,
    prefix: str,
    *,
    two_mul: bool = True,
    activation: Optional[str] = None,
    trans_b: bool = False,
) -> str:
    """The Fig 1/2 pattern as some MLP exporters codify it: one integer
    ``Gemm`` (X @ W [+ B], int32 accumulation, alpha = beta = 1) instead of
    MatMulInteger + Add.  Compiles onto the same fused qlinear kernel."""
    w_q = p.weight_q.T if trans_b else p.weight_q
    w = gb.add_initializer(f"{prefix}_weight_q", np.ascontiguousarray(w_q))
    ins = [x, w]
    if p.bias_q is not None:
        ins.append(gb.add_initializer(f"{prefix}_bias_q", p.bias_q))
    attrs = {"transB": 1} if trans_b else {}
    if p.bits != 8:
        attrs["weight_bits"] = p.bits
    acc = gb.op("Gemm", ins, out_hint=f"{prefix}_acc", **attrs)
    f = emit_rescale(gb, acc, p.rescale, prefix, two_mul=two_mul)
    if activation is not None:
        f = gb.op(activation, [f], out_hint=f"{prefix}_{activation.lower()}")
    return emit_round_clip(gb, f, prefix, p.out_dtype)


def conv_layer(
    gb: GraphBuilder,
    x: str,
    weight_q: np.ndarray,
    bias_q: Optional[np.ndarray],
    rescale: Rescale,
    prefix: str,
    *,
    strides=(1, 1),
    pads=(0, 0, 0, 0),
    two_mul: bool = False,
    activation: Optional[str] = None,
    out_dtype: str = "int8",
    weight_bits: int = 8,
) -> str:
    """Fig 3 convolution pattern.  ``weight_q`` is (M, C, kH, kW) int8;
    ``bias_q`` is int32 (M,), added broadcast as (1, M, 1, 1).  ``rescale``
    may be per-channel (one multiplier per output channel M).  ``weight_bits``
    rides as a node attribute like the FC builders (conv stays unpacked —
    only the matmul lane has a packed kernel today)."""
    w = gb.add_initializer(f"{prefix}_weight_q", weight_q)
    attrs = {"weight_bits": weight_bits} if weight_bits != 8 else {}
    acc = gb.op(
        "ConvInteger", [x, w], out_hint=f"{prefix}_acc",
        strides=list(strides), pads=list(pads), **attrs,
    )
    if bias_q is not None:
        b = gb.add_initializer(f"{prefix}_bias_q", bias_q.reshape(1, -1, 1, 1).astype(np.int32))
        acc = gb.op("Add", [acc, b], out_hint=f"{prefix}_biased")
    f = emit_rescale(gb, acc, rescale, prefix, two_mul=two_mul, channel_tail=2)
    if activation is not None:
        f = gb.op(activation, [f], out_hint=f"{prefix}_{activation.lower()}")
    return emit_round_clip(gb, f, prefix, out_dtype)


def _dql(gb: GraphBuilder, x: str, scale: float, prefix: str) -> str:
    s = gb.add_initializer(f"{prefix}_dq_scale", np.float32(scale))
    zp = gb.add_initializer(f"{prefix}_dq_zp", np.zeros((), dtype="int8"))
    return gb.op("DequantizeLinear", [x, s, zp], out_hint=f"{prefix}_deq")


def _ql(gb: GraphBuilder, x: str, scale: float, prefix: str, out_dtype: str) -> str:
    s = gb.add_initializer(f"{prefix}_q_scale", np.float32(scale))
    zp = gb.add_initializer(f"{prefix}_q_zp", np.zeros((), dtype=out_dtype))
    return gb.op("QuantizeLinear", [x, s, zp], out_hint=f"{prefix}_req")


def fc_int8_tanh(
    gb: GraphBuilder,
    x: str,
    p: QuantizedLinearParams,
    prefix: str,
    *,
    input_absmax: float = TANH_INPUT_ABSMAX,
) -> str:
    """Fig 4: int8 tanh.  The FC rescale maps the accumulator onto the full
    int8-quantized tanh input range [−input_absmax, +input_absmax]; y_scale
    maps int8 onto tanh's output range (−1, 1)."""
    q = fc_layer(gb, x, p, prefix, two_mul=True)
    deq = _dql(gb, q, input_absmax / 127.0, prefix)
    t = gb.op("Tanh", [deq], out_hint=f"{prefix}_tanh")
    return _ql(gb, t, 1.0 / 127.0, prefix, "int8")


def fc_fp16_tanh(
    gb: GraphBuilder,
    x: str,
    p: QuantizedLinearParams,
    prefix: str,
    *,
    input_absmax: float = TANH_INPUT_ABSMAX,
) -> str:
    """Fig 5: mixed int8/fp16 tanh flow (Cast→f16, Tanh in f16, Cast→f32)."""
    q = fc_layer(gb, x, p, prefix, two_mul=True)
    deq = _dql(gb, q, input_absmax / 127.0, prefix)
    h = gb.op("Cast", [deq], out_hint=f"{prefix}_f16", to="float16")
    t = gb.op("Tanh", [h], out_hint=f"{prefix}_tanh16")
    f = gb.op("Cast", [t], out_hint=f"{prefix}_back32", to="float32")
    return _ql(gb, f, 1.0 / 127.0, prefix, "int8")


def fc_fp16_sigmoid(
    gb: GraphBuilder,
    x: str,
    p: QuantizedLinearParams,
    prefix: str,
    *,
    input_absmax: float = SIGMOID_INPUT_ABSMAX,
) -> str:
    """Fig 6: mixed int8/fp16 sigmoid; single-Mul rescale; **uint8** output
    (sigmoid is always positive)."""
    q = fc_layer(gb, x, p, prefix, two_mul=False)
    deq = _dql(gb, q, input_absmax / 127.0, prefix)
    h = gb.op("Cast", [deq], out_hint=f"{prefix}_f16", to="float16")
    s = gb.op("Sigmoid", [h], out_hint=f"{prefix}_sig16")
    f = gb.op("Cast", [s], out_hint=f"{prefix}_back32", to="float32")
    return _ql(gb, f, 1.0 / 255.0, prefix, "uint8")
