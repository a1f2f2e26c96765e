"""Reference interpreter for PQ-IR — the "standard ONNX tool" of paper goal 2.

Executes a :class:`repro.core.pqir.Model` op-by-op with numpy, following ONNX
operator semantics (round-half-even QuantizeLinear, int32 accumulation in
MatMulInteger/ConvInteger, dtype-preserving activations so fp16 sections stay
fp16).  Every compiled backend (the JAX/Pallas TPU path in
:mod:`repro.core.compile`) is conformance-tested against this interpreter —
bit-exactly on integer paths.
"""
from __future__ import annotations

import math
from typing import Callable, Dict, List

import numpy as np

from .pqir import DTYPES, Graph, Model, Node

_OPS: Dict[str, Callable] = {}


def op(name: str):
    def deco(fn):
        _OPS[name] = fn
        return fn

    return deco


def _zp(inputs: List[np.ndarray], idx: int) -> np.ndarray:
    """Optional zero-point input (defaults to 0)."""
    if len(inputs) > idx and inputs[idx] is not None:
        return inputs[idx].astype(np.int32)
    return np.int32(0)


# -- quantized compute -------------------------------------------------------


@op("MatMulInteger")
def _matmul_integer(node: Node, inputs):
    a, b = inputs[0], inputs[1]
    a32 = a.astype(np.int32) - _zp(inputs, 2)
    b32 = b.astype(np.int32) - _zp(inputs, 3)
    return [a32 @ b32]


@op("ConvInteger")
def _conv_integer(node: Node, inputs):
    x, w = inputs[0], inputs[1]
    x32 = x.astype(np.int32) - _zp(inputs, 2)
    w32 = w.astype(np.int32) - _zp(inputs, 3)
    return [_conv2d_int32(x32, w32, node.attrs)]


def _conv2d_int32(x: np.ndarray, w: np.ndarray, attrs) -> np.ndarray:
    """NCHW int32 convolution (zero-padded; symmetric quantization ⇒ zp=0
    padding is exact)."""
    strides = tuple(attrs.get("strides", (1, 1)))
    pads = tuple(attrs.get("pads", (0, 0, 0, 0)))  # (top, left, bottom, right)
    dil = tuple(attrs.get("dilations", (1, 1)))
    group = int(attrs.get("group", 1))
    n, c, h, wd = x.shape
    m, cg, kh, kw = w.shape
    assert c == cg * group, f"channel mismatch: {c} vs {cg}*{group}"
    xp = np.pad(x, ((0, 0), (0, 0), (pads[0], pads[2]), (pads[1], pads[3])))
    oh = (xp.shape[2] - (dil[0] * (kh - 1) + 1)) // strides[0] + 1
    ow = (xp.shape[3] - (dil[1] * (kw - 1) + 1)) // strides[1] + 1
    out = np.zeros((n, m, oh, ow), dtype=np.int64)
    mg = m // group
    for g in range(group):
        xg = xp[:, g * cg : (g + 1) * cg]
        wg = w[g * mg : (g + 1) * mg]
        for i in range(kh):
            for j in range(kw):
                patch = xg[
                    :,
                    :,
                    i * dil[0] : i * dil[0] + oh * strides[0] : strides[0],
                    j * dil[1] : j * dil[1] + ow * strides[1] : strides[1],
                ]
                # (n, cg, oh, ow) x (mg, cg) -> (n, mg, oh, ow)
                out[:, g * mg : (g + 1) * mg] += np.einsum(
                    "nchw,mc->nmhw", patch.astype(np.int64), wg[:, :, i, j].astype(np.int64)
                )
    return out.astype(np.int32)


# -- quantize / dequantize ---------------------------------------------------


@op("QuantizeLinear")
def _quantize_linear(node: Node, inputs):
    x, y_scale = inputs[0], inputs[1]
    y_zp = inputs[2] if len(inputs) > 2 else np.zeros((), dtype=np.int8)
    out_dtype = y_zp.dtype
    info = np.iinfo(out_dtype)
    y = np.rint(x.astype(np.float32) / y_scale.astype(np.float32)) + y_zp.astype(np.float32)
    return [np.clip(y, info.min, info.max).astype(out_dtype)]


@op("DequantizeLinear")
def _dequantize_linear(node: Node, inputs):
    x, x_scale = inputs[0], inputs[1]
    x_zp = inputs[2].astype(np.int32) if len(inputs) > 2 else np.int32(0)
    return [((x.astype(np.int32) - x_zp).astype(np.float32) * x_scale.astype(np.float32))]


@op("Cast")
def _cast(node: Node, inputs):
    to = node.attrs["to"]
    return [inputs[0].astype(DTYPES[to])]


# -- elementwise -------------------------------------------------------------


@op("Mul")
def _mul(node: Node, inputs):
    return [inputs[0] * inputs[1]]


@op("Add")
def _add(node: Node, inputs):
    return [inputs[0] + inputs[1]]


@op("Sub")
def _sub(node: Node, inputs):
    return [inputs[0] - inputs[1]]


@op("Div")
def _div(node: Node, inputs):
    a, b = inputs
    if np.issubdtype(a.dtype, np.integer):
        return [a // b]
    return [a / b]


@op("Relu")
def _relu(node: Node, inputs):
    x = inputs[0]
    return [np.maximum(x, np.zeros((), dtype=x.dtype))]


@op("Tanh")
def _tanh(node: Node, inputs):
    x = inputs[0]
    return [np.tanh(x).astype(x.dtype)]


def stable_sigmoid(x: np.ndarray) -> np.ndarray:
    """Numerically stable logistic in float32, cast back to ``x.dtype``.

    The naive ``1/(1+exp(-x))`` overflows ``exp`` for large-magnitude
    negative inputs (int-dequantized activations easily reach them).  The
    two-branch form only ever exponentiates ``-|x|`` ∈ (-inf, 0], which
    cannot overflow; both branches are algebraically identical to the naive
    form.  The LUT fusion bakes this exact function (see
    ``repro.core.compile._NP_ACT``), so compiled LUTs stay bit-exact
    against this reference."""
    x = np.asarray(x)
    z = x.astype(np.float32)
    e = np.exp(-np.abs(z))
    y = np.where(z >= 0, 1.0 / (1.0 + e), e / (1.0 + e))
    return y.astype(x.dtype)


@op("Sigmoid")
def _sigmoid(node: Node, inputs):
    return [stable_sigmoid(inputs[0])]


@op("Erf")
def _erf(node: Node, inputs):
    x = inputs[0]
    return [np.vectorize(math.erf, otypes=[np.float64])(x.astype(np.float64)).astype(x.dtype)]


@op("Sqrt")
def _sqrt(node: Node, inputs):
    return [np.sqrt(inputs[0]).astype(inputs[0].dtype)]


@op("Pow")
def _pow(node: Node, inputs):
    return [np.power(inputs[0], inputs[1]).astype(inputs[0].dtype)]


@op("Clip")
def _clip(node: Node, inputs):
    x = inputs[0]
    lo = inputs[1] if len(inputs) > 1 else None
    hi = inputs[2] if len(inputs) > 2 else None
    return [np.clip(x, lo, hi).astype(x.dtype)]


@op("Softmax")
def _softmax(node: Node, inputs):
    x = inputs[0].astype(np.float32)
    axis = int(node.attrs.get("axis", -1))
    m = x - x.max(axis=axis, keepdims=True)
    e = np.exp(m)
    return [(e / e.sum(axis=axis, keepdims=True)).astype(inputs[0].dtype)]


# -- float compute -----------------------------------------------------------


@op("MatMul")
def _matmul(node: Node, inputs):
    return [inputs[0] @ inputs[1]]


@op("Gemm")
def _gemm(node: Node, inputs):
    a, b = inputs[0], inputs[1]
    alpha = float(node.attrs.get("alpha", 1.0))
    beta = float(node.attrs.get("beta", 1.0))
    if node.attrs.get("transA", 0):
        a = a.T
    if node.attrs.get("transB", 0):
        b = b.T
    if np.issubdtype(a.dtype, np.integer):
        # Integer Gemm (the form quantized MLP exporters emit in place of
        # MatMulInteger + Add): accumulate in int32; alpha/beta must be the
        # default 1 so the op stays exact.
        if alpha != 1.0 or beta != 1.0:
            raise NotImplementedError("integer Gemm requires alpha == beta == 1")
        y = a.astype(np.int32) @ b.astype(np.int32)
        if len(inputs) > 2 and inputs[2] is not None:
            y = y + inputs[2].astype(np.int32)
        return [y]
    y = alpha * (a @ b)
    if len(inputs) > 2 and inputs[2] is not None:
        y = y + beta * inputs[2]
    return [y.astype(inputs[0].dtype)]


@op("Conv")
def _conv(node: Node, inputs):
    x, w = inputs[0], inputs[1]
    acc = _conv2d_f32(x.astype(np.float32), w.astype(np.float32), node.attrs)
    if len(inputs) > 2 and inputs[2] is not None:
        acc = acc + inputs[2].reshape(1, -1, 1, 1)
    return [acc.astype(x.dtype)]


def _conv2d_f32(x, w, attrs):
    strides = tuple(attrs.get("strides", (1, 1)))
    pads = tuple(attrs.get("pads", (0, 0, 0, 0)))
    dil = tuple(attrs.get("dilations", (1, 1)))
    group = int(attrs.get("group", 1))
    n, c, h, wd = x.shape
    m, cg, kh, kw = w.shape
    xp = np.pad(x, ((0, 0), (0, 0), (pads[0], pads[2]), (pads[1], pads[3])))
    oh = (xp.shape[2] - (dil[0] * (kh - 1) + 1)) // strides[0] + 1
    ow = (xp.shape[3] - (dil[1] * (kw - 1) + 1)) // strides[1] + 1
    out = np.zeros((n, m, oh, ow), dtype=np.float32)
    mg = m // group
    for g in range(group):
        xg = xp[:, g * cg : (g + 1) * cg]
        wg = w[g * mg : (g + 1) * mg]
        for i in range(kh):
            for j in range(kw):
                patch = xg[
                    :,
                    :,
                    i * dil[0] : i * dil[0] + oh * strides[0] : strides[0],
                    j * dil[1] : j * dil[1] + ow * strides[1] : strides[1],
                ]
                out[:, g * mg : (g + 1) * mg] += np.einsum("nchw,mc->nmhw", patch, wg[:, :, i, j])
    return out


# -- shape plumbing ----------------------------------------------------------


@op("Reshape")
def _reshape(node: Node, inputs):
    shape = [int(s) for s in inputs[1]]
    return [inputs[0].reshape(shape)]


@op("Transpose")
def _transpose(node: Node, inputs):
    perm = node.attrs.get("perm")
    return [np.transpose(inputs[0], perm)]


@op("Flatten")
def _flatten(node: Node, inputs):
    axis = int(node.attrs.get("axis", 1))
    x = inputs[0]
    lead = int(np.prod(x.shape[:axis])) if axis else 1
    return [x.reshape(lead, -1)]


@op("Concat")
def _concat(node: Node, inputs):
    return [np.concatenate(inputs, axis=int(node.attrs["axis"]))]


@op("Slice")
def _slice(node: Node, inputs):
    x = inputs[0]
    starts, ends = inputs[1], inputs[2]
    axes = inputs[3] if len(inputs) > 3 else np.arange(len(starts))
    steps = inputs[4] if len(inputs) > 4 else np.ones(len(starts), dtype=np.int64)
    sl = [slice(None)] * x.ndim
    for s, e, a, st in zip(starts, ends, axes, steps):
        sl[int(a)] = slice(int(s), int(e), int(st))
    return [x[tuple(sl)]]


@op("Gather")
def _gather(node: Node, inputs):
    axis = int(node.attrs.get("axis", 0))
    return [np.take(inputs[0], inputs[1].astype(np.int64), axis=axis)]


@op("Squeeze")
def _squeeze(node: Node, inputs):
    axes = tuple(int(a) for a in inputs[1]) if len(inputs) > 1 else None
    return [np.squeeze(inputs[0], axis=axes)]


@op("Unsqueeze")
def _unsqueeze(node: Node, inputs):
    x = inputs[0]
    for a in sorted(int(a) for a in inputs[1]):
        x = np.expand_dims(x, a)
    return [x]


# -- pooling / reductions ----------------------------------------------------


def _pool2d(x: np.ndarray, attrs, reducer) -> np.ndarray:
    kh, kw = attrs["kernel_shape"]
    strides = tuple(attrs.get("strides", (kh, kw)))
    pads = tuple(attrs.get("pads", (0, 0, 0, 0)))
    if any(pads):
        fill = -np.inf if reducer is np.max else 0.0
        x = np.pad(x, ((0, 0), (0, 0), (pads[0], pads[2]), (pads[1], pads[3])), constant_values=fill)
    n, c, h, w = x.shape
    oh = (h - kh) // strides[0] + 1
    ow = (w - kw) // strides[1] + 1
    windows = np.empty((n, c, oh, ow, kh * kw), dtype=np.float32)
    for i in range(kh):
        for j in range(kw):
            windows[..., i * kw + j] = x[:, :, i : i + oh * strides[0] : strides[0], j : j + ow * strides[1] : strides[1]]
    return reducer(windows, axis=-1)


@op("MaxPool")
def _maxpool(node: Node, inputs):
    x = inputs[0]
    return [_pool2d(x.astype(np.float32), node.attrs, np.max).astype(x.dtype)]


@op("AveragePool")
def _avgpool(node: Node, inputs):
    x = inputs[0]
    return [_pool2d(x.astype(np.float32), node.attrs, np.mean).astype(x.dtype)]


@op("GlobalAveragePool")
def _gap(node: Node, inputs):
    x = inputs[0]
    return [x.mean(axis=(2, 3), keepdims=True).astype(x.dtype)]


@op("ReduceMean")
def _reduce_mean(node: Node, inputs):
    axes = tuple(node.attrs.get("axes", None) or range(inputs[0].ndim))
    keep = bool(node.attrs.get("keepdims", 1))
    x = inputs[0]
    return [x.mean(axis=axes, keepdims=keep).astype(x.dtype)]


@op("ReduceMax")
def _reduce_max(node: Node, inputs):
    axes = tuple(node.attrs.get("axes", None) or range(inputs[0].ndim))
    keep = bool(node.attrs.get("keepdims", 1))
    x = inputs[0]
    return [x.max(axis=axes, keepdims=keep).astype(x.dtype)]


@op("ReduceSum")
def _reduce_sum(node: Node, inputs):
    axes = tuple(node.attrs.get("axes", None) or range(inputs[0].ndim))
    keep = bool(node.attrs.get("keepdims", 1))
    x = inputs[0]
    # accumulate in the input dtype (int32 sums stay int32, exact)
    return [x.sum(axis=axes, keepdims=keep, dtype=x.dtype)]


# ---------------------------------------------------------------------------


class ReferenceRuntime:
    """Op-by-op executor with ONNX semantics (the conformance oracle)."""

    def __init__(self, model: Model, *, validate: bool = True) -> None:
        if validate:
            model.validate()
        self.model = model
        self._order = model.graph.toposorted()

    def run(self, feeds: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
        g = self.model.graph
        env: Dict[str, np.ndarray] = {}
        for t in g.inputs:
            if t.name not in feeds:
                raise KeyError(f"missing feed for graph input {t.name!r}")
            arr = np.asarray(feeds[t.name])
            if arr.dtype != DTYPES[t.dtype]:
                raise TypeError(f"feed {t.name!r} dtype {arr.dtype} != declared {t.dtype}")
            env[t.name] = arr
        env.update(g.initializers)
        for node in self._order:
            fn = _OPS.get(node.op_type)
            if fn is None:
                raise NotImplementedError(f"reference runtime has no op {node.op_type!r}")
            ins = [env[i] if i else None for i in node.inputs]
            outs = fn(node, ins)
            for name, val in zip(node.outputs, outs):
                env[name] = val
        return {t.name: env[t.name] for t in g.outputs}

    def __call__(self, **feeds: np.ndarray) -> Dict[str, np.ndarray]:
        return self.run(feeds)


def run_model(model: Model, feeds: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
    return ReferenceRuntime(model).run(feeds)
