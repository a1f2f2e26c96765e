"""Plain PyTorch oracles for the fused kernels (the ``ref`` backend).

These implement the artifact's op chain exactly — int32 accumulation, f32
rescale in codified order, round half to even, clip — on any device, so
that ``reference runtime == ref == CUDA kernel`` bit for bit.

PyTorch has no integer matmul on CUDA, so every integer contraction here
runs in float64: each product of two int8 codes is exact (|p| <= 2**14) and
every partial sum stays below 2**53, so the float64 sum *is* the int32 sum
in any order, on the CPU and on the card alike.  Each f32 step is a separate
eager operation, so nothing contracts into an FMA.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F


def int_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Exact integer ``a @ b`` (broadcasting like ``torch.matmul``) as int32,
    through float64 (see the module docstring for why it is exact)."""
    return torch.matmul(a.to(torch.float64), b.to(torch.float64)).to(torch.int32)


def int_conv2d(x: torch.Tensor, w: torch.Tensor, *, strides=(1, 1), pads=(0, 0, 0, 0),
               dilations=(1, 1), groups: int = 1) -> torch.Tensor:
    """Exact integer NCHW convolution as int32, through float64 (zero
    padding, ``pads`` = (top, left, bottom, right) as ONNX writes them)."""
    xf = F.pad(x.to(torch.float64), (pads[1], pads[3], pads[0], pads[2]))
    acc = F.conv2d(xf, w.to(torch.float64), stride=tuple(strides),
                   dilation=tuple(dilations), groups=int(groups))
    return acc.to(torch.int32)


def _per_channel(v: torch.Tensor, ndim: int) -> torch.Tensor:
    return v.reshape((1,) * (ndim - 1) + (-1,)) if v.ndim else v


def requantize(f: torch.Tensor, out_dtype: torch.dtype) -> torch.Tensor:
    """QuantizeLinear(scale=1, zp=0): round half to even, clip, cast."""
    info = torch.iinfo(out_dtype)
    return torch.clamp(torch.round(f), info.min, info.max).to(out_dtype)


def qmatmul_ref(
    x_q: torch.Tensor,  # (..., K) int8/uint8
    w_q: torch.Tensor,  # (K, N) int8
    bias_q: Optional[torch.Tensor],  # (N,) or (1, N) int32
    quant_scale: torch.Tensor,  # scalar or (N,) f32
    quant_shift: torch.Tensor,  # scalar or (N,) f32
    *,
    out_dtype: torch.dtype = torch.int8,
    relu: bool = False,
    two_mul: bool = True,
) -> torch.Tensor:
    """MatMulInteger → Add → Cast → Mul(→Mul) → [Relu] → QuantizeLinear."""
    acc = int_matmul(x_q, w_q)
    if bias_q is not None:
        acc = acc + _per_channel(bias_q.reshape(-1), acc.ndim).to(torch.int32)
    f = acc.to(torch.float32) * _per_channel(quant_scale, acc.ndim)
    if two_mul:
        f = f * _per_channel(quant_shift, acc.ndim)
    if relu:
        f = torch.clamp_min(f, 0.0)
    return requantize(f, out_dtype)


def qconv2d_ref(
    x_q: torch.Tensor,  # (N, C, H, W) int8/uint8
    w_q: torch.Tensor,  # (M, C, kH, kW) int8
    bias_q: Optional[torch.Tensor],  # (M,) int32
    quant_scale: torch.Tensor,  # scalar or (M,) f32
    quant_shift: torch.Tensor,  # scalar or (M,) f32
    *,
    strides=(1, 1),
    pads=(0, 0, 0, 0),
    out_dtype: torch.dtype = torch.int8,
    relu: bool = False,
    two_mul: bool = True,
) -> torch.Tensor:
    """ConvInteger → Add → Cast → Mul(→Mul) → [Relu] → QuantizeLinear, with
    per-channel constants along the output-channel axis.  A uint8 input
    convolves as is: its codes are exact in float64."""
    chan = lambda v: v.reshape(1, -1, 1, 1) if v.ndim else v  # noqa: E731
    acc = int_conv2d(x_q, w_q, strides=strides, pads=pads)
    if bias_q is not None:
        acc = acc + chan(bias_q.reshape(-1)).to(torch.int32)
    f = acc.to(torch.float32) * chan(quant_scale)
    if two_mul:
        f = f * chan(quant_shift)
    if relu:
        f = torch.clamp_min(f, 0.0)
    return requantize(f, out_dtype)


def qact_lut_ref(x_q: torch.Tensor, lut: torch.Tensor) -> torch.Tensor:
    """256-entry LUT gather oracle."""
    return lut[x_q.to(torch.int64) + 128]


def qattention_ref(
    q_q: torch.Tensor,  # (..., S, dh) int8
    k_q: torch.Tensor,  # (..., T, dh) int8
    v_q: torch.Tensor,  # (..., T, dh) int8
    mask: torch.Tensor,  # (..., S, T) f32 {0, 1} validity/causality mask
    qk_scale: float,  # s_q * s_k / sqrt(dh)
    big: float,  # the additive mask penalty
    lut_scale: float,  # score-delta quantization step
    lut: torch.Tensor,  # (256,) uint8 exp table (lut[0] must be 0)
    p_scale: float,  # probability quantization (127.0)
    rescale: float,  # s_v / (p_scale * s_out)
    *,
    out_dtype: torch.dtype = torch.int8,
) -> torch.Tensor:
    """Fused int8 attention oracle: the exact op chain the PQ-IR attention
    region codifies (``repro_torch.core.patterns.emit_qattention``).  The
    scalars are rounded to float32 once, as the kernel receives them; a
    float32 times a float32-representable double rounds exactly as a
    float32 product does.

        MatMulInteger(Q, Kᵀ) → ×qk_scale → additive {0, −big} mask →
        ReduceMax/Sub → QuantizeLinear(lut_scale) → exp via LUT gather →
        ReduceSum (int32) → Div → ×p_scale → QuantizeLinear →
        MatMulInteger(P, V) → ×rescale → QuantizeLinear(out_dtype)
    """
    qk_scale, big, lut_scale, p_scale, rescale = (
        float(np.float32(c)) for c in (qk_scale, big, lut_scale, p_scale, rescale)
    )
    acc = int_matmul(q_q, k_q.transpose(-1, -2))
    s_f = acc.to(torch.float32) * qk_scale
    masked = s_f * mask + (mask - 1.0) * big
    mx = torch.amax(masked, dim=-1, keepdim=True)
    d_q = torch.clamp(torch.round((masked - mx) / lut_scale), -128, 127).to(torch.int64)
    w = lut[d_q + 128]  # uint8 weights; masked positions hit lut[0] == 0
    den = torch.sum(w.to(torch.int32), dim=-1, keepdim=True, dtype=torch.int32)
    p = w.to(torch.float32) / den.to(torch.float32)
    p_q = torch.clamp(torch.round(p * p_scale), -128, 127).to(torch.int32)
    ctx = int_matmul(p_q, v_q)
    return requantize(ctx.to(torch.float32) * rescale, out_dtype)
