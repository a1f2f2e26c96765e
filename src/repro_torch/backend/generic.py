"""Generic torch op table — the fallback lowering for every standard op.

Each entry implements one ONNX-dialect operator as eager torch operations
with the semantics of :mod:`repro_torch.core.runtime` (the conformance
oracle): exact on integer paths, allclose on float paths.  The table is
registered wholesale under kernel ids ``op.<OpType>`` for the shared ``"*"``
backend, so any op the fusion patterns do not consume runs on every backend
and device.

Implementations take ``(attrs, ins)`` — the node's attribute dict and its
operand list (``None`` for absent optional inputs).  Shape-parameter
operands (Reshape target, Slice starts/ends/axes/steps, Squeeze/Unsqueeze
axes) are compile-time constants that stay on the host as numpy arrays;
:func:`_static_ints` rejects a tensor computed at run time.

Two dialect rules need care in torch:

* binary elementwise ops promote both operands by the array rule (a 0-d
  constant is as strongly typed as any tensor, as in numpy), not torch's
  scalar rule that lets a 0-d operand take the other's dtype;
* integer contractions (MatMulInteger, integer Gemm, ConvInteger) run in
  float64 — PyTorch has no integer matmul on CUDA, and a float64 sum of
  int8 products is exact far beyond the int32 range these ops produce.
"""
from __future__ import annotations

from typing import Callable, Dict, List

import numpy as np
import torch

from ..kernels.ref import int_conv2d, int_matmul
from .registry import register

#: PQ-IR dtype names → torch dtypes.
TORCH_DTYPES = {
    "float32": torch.float32,
    "float16": torch.float16,
    "int8": torch.int8,
    "uint8": torch.uint8,
    "int32": torch.int32,
    "int64": torch.int64,
    "bool": torch.bool,
}

_TOPS: Dict[str, Callable] = {}


def _top(name):
    def deco(fn):
        _TOPS[name] = fn
        return fn

    return deco


def _static_ints(v, op: str, what: str) -> List[int]:
    """Concrete int list from a shape-parameter operand; rejects tensors
    computed at run time."""
    if isinstance(v, torch.Tensor):
        raise NotImplementedError(
            f"compiler requires a constant {what} for {op} (got a run-time tensor); "
            "the reference runtime supports the dynamic form"
        )
    return [int(s) for s in np.asarray(v).reshape(-1)]


def _binary(fn):
    """Elementwise binary op under the array promotion rule."""

    def impl(attrs, ins):
        a, b = ins[0], ins[1]
        dt = torch.promote_types(a.dtype, b.dtype)
        return [fn(a.to(dt), b.to(dt))]

    return impl


def _is_int(x: torch.Tensor) -> bool:
    return not (x.is_floating_point() or x.is_complex() or x.dtype == torch.bool)


def _zp32(ins, idx):
    return ins[idx].to(torch.int32) if len(ins) > idx and ins[idx] is not None else 0


@_top("MatMulInteger")
def _t_matmuli(attrs, ins):
    a = ins[0].to(torch.int32) - _zp32(ins, 2)
    b = ins[1].to(torch.int32) - _zp32(ins, 3)
    return [int_matmul(a, b)]


@_top("ConvInteger")
def _t_convi(attrs, ins):
    x = ins[0].to(torch.int32) - _zp32(ins, 2)
    w = ins[1].to(torch.int32) - _zp32(ins, 3)
    return [int_conv2d(
        x, w, strides=tuple(attrs.get("strides", (1, 1))),
        pads=tuple(attrs.get("pads", (0, 0, 0, 0))),
        dilations=tuple(attrs.get("dilations", (1, 1))), groups=int(attrs.get("group", 1)),
    )]


@_top("QuantizeLinear")
def _t_ql(attrs, ins):
    x, scale = ins[0], ins[1]
    zp = ins[2] if len(ins) > 2 and ins[2] is not None else torch.zeros((), dtype=torch.int8, device=x.device)
    info = torch.iinfo(zp.dtype)
    y = torch.round(x.to(torch.float32) / scale.to(torch.float32)) + zp.to(torch.float32)
    return [torch.clamp(y, info.min, info.max).to(zp.dtype)]


@_top("DequantizeLinear")
def _t_dql(attrs, ins):
    x, scale = ins[0], ins[1]
    return [(x.to(torch.int32) - _zp32(ins, 2)).to(torch.float32) * scale.to(torch.float32)]


@_top("Cast")
def _t_cast(attrs, ins):
    return [ins[0].to(TORCH_DTYPES[attrs["to"]])]


@_top("Reshape")
def _t_reshape(attrs, ins):
    return [ins[0].reshape(tuple(_static_ints(ins[1], "Reshape", "target shape")))]


@_top("Slice")
def _t_slice(attrs, ins):
    x = ins[0]
    starts = _static_ints(ins[1], "Slice", "starts")
    ends = _static_ints(ins[2], "Slice", "ends")
    axes = _static_ints(ins[3], "Slice", "axes") if len(ins) > 3 and ins[3] is not None else list(range(len(starts)))
    steps = _static_ints(ins[4], "Slice", "steps") if len(ins) > 4 and ins[4] is not None else [1] * len(starts)
    if any(st < 1 for st in steps):
        raise NotImplementedError("Slice with a non-positive step is not supported by the torch backend")
    sl = [slice(None)] * x.ndim
    for s, e, a, st in zip(starts, ends, axes, steps):
        sl[a] = slice(s, e, st)
    return [x[tuple(sl)]]  # a strided view: fused kernels copy it contiguous


@_top("Squeeze")
def _t_squeeze(attrs, ins):
    if len(ins) > 1 and ins[1] is not None:
        return [torch.squeeze(ins[0], dim=tuple(_static_ints(ins[1], "Squeeze", "axes")))]
    return [torch.squeeze(ins[0])]


@_top("Unsqueeze")
def _t_unsqueeze(attrs, ins):
    x = ins[0]
    for a in sorted(_static_ints(ins[1], "Unsqueeze", "axes")):
        x = torch.unsqueeze(x, a)
    return [x]


def _axes(attrs, x):
    axes = attrs.get("axes")
    return tuple(int(a) for a in axes) if axes else tuple(range(x.ndim))


def _keep(attrs) -> bool:
    return bool(attrs.get("keepdims", 1))


def _mean(x, dim, keepdim):
    if _is_int(x):  # numpy averages integers in float64, then casts back
        return x.to(torch.float64).mean(dim=dim, keepdim=keepdim).to(x.dtype)
    return x.mean(dim=dim, keepdim=keepdim)


def _div(a, b):
    return torch.div(a, b, rounding_mode="floor") if _is_int(a) else a / b


for _name, _fn in {
    "Mul": _binary(torch.mul),
    "Add": _binary(torch.add),
    "Sub": _binary(torch.sub),
    "Div": _binary(_div),
    "Pow": lambda attrs, ins: [torch.pow(ins[0], ins[1]).to(ins[0].dtype)],
    "Relu": lambda attrs, ins: [torch.clamp_min(ins[0], 0)],
    "Tanh": lambda attrs, ins: [torch.tanh(ins[0]).to(ins[0].dtype)],
    "Sigmoid": lambda attrs, ins: [torch.sigmoid(ins[0].to(torch.float32)).to(ins[0].dtype)],
    "Erf": lambda attrs, ins: [torch.erf(ins[0].to(torch.float32)).to(ins[0].dtype)],
    "Sqrt": lambda attrs, ins: [torch.sqrt(ins[0])],
    "Clip": lambda attrs, ins: [torch.clamp(
        ins[0], ins[1] if len(ins) > 1 else None, ins[2] if len(ins) > 2 else None
    ).to(ins[0].dtype)],
    "Softmax": lambda attrs, ins: [torch.softmax(
        ins[0].to(torch.float32), dim=int(attrs.get("axis", -1))
    ).to(ins[0].dtype)],
    "MatMul": lambda attrs, ins: [ins[0] @ ins[1]],
    "Transpose": lambda attrs, ins: [ins[0].permute(
        *(attrs.get("perm") or range(ins[0].ndim - 1, -1, -1))
    )],
    "Flatten": lambda attrs, ins: [ins[0].reshape(
        (int(np.prod(ins[0].shape[: int(attrs.get("axis", 1))])) if int(attrs.get("axis", 1)) else 1, -1)
    )],
    "Concat": lambda attrs, ins: [torch.cat(ins, dim=int(attrs["axis"]))],
    "GlobalAveragePool": lambda attrs, ins: [_mean(ins[0], (2, 3), True)],
    "ReduceMean": lambda attrs, ins: [_mean(ins[0], _axes(attrs, ins[0]), _keep(attrs))],
    "ReduceMax": lambda attrs, ins: [torch.amax(ins[0], dim=_axes(attrs, ins[0]), keepdim=_keep(attrs))],
    "ReduceSum": lambda attrs, ins: [torch.sum(
        ins[0], dim=_axes(attrs, ins[0]), keepdim=_keep(attrs), dtype=ins[0].dtype
    )],
}.items():
    _TOPS[_name] = _fn


@_top("Gather")
def _t_gather(attrs, ins):
    table, idx = ins[0], ins[1].to(torch.int64)
    axis = int(attrs.get("axis", 0)) % table.ndim
    idx = torch.where(idx < 0, idx + table.shape[axis], idx)  # numpy wraps negatives
    out = torch.index_select(table, axis, idx.reshape(-1))
    return [out.reshape(tuple(table.shape[:axis]) + tuple(idx.shape) + tuple(table.shape[axis + 1:]))]


@_top("Gemm")
def _t_gemm(attrs, ins):
    a, b = ins[0], ins[1]
    if attrs.get("transA", 0):
        a = a.t()
    if attrs.get("transB", 0):
        b = b.t()
    if _is_int(a):
        # integer Gemm: int32 accumulation, alpha/beta fixed at 1 (dialect rule)
        if float(attrs.get("alpha", 1.0)) != 1.0 or float(attrs.get("beta", 1.0)) != 1.0:
            raise NotImplementedError("integer Gemm requires alpha == beta == 1")
        y = int_matmul(a, b)
        if len(ins) > 2 and ins[2] is not None:
            y = y + ins[2].to(torch.int32)
        return [y]
    y = float(attrs.get("alpha", 1.0)) * (a @ b)
    if len(ins) > 2 and ins[2] is not None:
        y = y + float(attrs.get("beta", 1.0)) * ins[2]
    return [y.to(ins[0].dtype)]


#: Operand positions that are shape parameters: they stay host numpy arrays
#: when the compiler bakes a constant in (every other constant goes to the
#: plan's device as a tensor).
SHAPE_OPERANDS = {
    "Reshape": (1,),
    "Slice": (1, 2, 3, 4),
    "Squeeze": (1,),
    "Unsqueeze": (1,),
}


# ---------------------------------------------------------------------------
# registry hookup: every generic op is a shared-backend kernel "op.<Name>"
# ---------------------------------------------------------------------------


def _make_impl(fn):
    def impl(step, args):
        return fn(step.params.get("attrs", {}), args)

    return impl


for _name, _fn in _TOPS.items():
    register(f"op.{_name}")(_make_impl(_fn))
