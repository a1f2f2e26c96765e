"""W8A8 serving-side quantized layers for the model zoo, as
``repro.core.qlayers``.

``QuantizedLinear`` holds exactly what the artifact embeds (int8 weights,
int32 bias, integer scale + shift) and computes with the same integer
semantics as the compiled kernels: on ``backend="cuda"`` through the qmatmul
kernel, on ``backend="ref"`` through its plain version.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from ..kernels import ops as kops
from .compile import resolve_device
from .quant import decompose_multiplier


@dataclasses.dataclass
class QuantizedLinear:
    """Static (pre-quantized) linear: y_q = requant(x_q @ W_q + B_q)."""

    weight_q: torch.Tensor  # (in, out) int8
    bias_q: Optional[torch.Tensor]  # (out,) int32
    quant_scale: torch.Tensor  # (out,) f32 integer-valued
    quant_shift: torch.Tensor  # (out,) f32 = 2^-N
    scale_x: float
    scale_y: float
    out_dtype: str = "int8"

    def __call__(self, x_q: torch.Tensor, *, backend: str = "ref") -> torch.Tensor:
        return kops.quantized_matmul(
            x_q, self.weight_q, self.bias_q, self.quant_scale, self.quant_shift,
            out_dtype=torch.int8 if self.out_dtype == "int8" else torch.uint8,
            backend=backend,
        )


def prepare_quantized_linear(
    w: np.ndarray,  # (in, out) f32
    b: Optional[np.ndarray],
    scale_x: float,
    scale_y: float,
    *,
    per_channel: bool = True,
    device=None,
) -> QuantizedLinear:
    """Quantizer-side preparation (per-channel §3 math + §3.1 decomposition),
    in numpy; the layer's tensors land on ``device`` (``None``: the card)."""
    dev = resolve_device(device)
    w = np.asarray(w, np.float32)
    if per_channel:
        absmax = np.maximum(np.abs(w).max(axis=0), 1e-12)
        scale_w = absmax / 127.0
    else:
        scale_w = np.full((w.shape[1],), max(float(np.abs(w).max()), 1e-12) / 127.0, np.float32)
    w_q = np.clip(np.rint(w / scale_w), -128, 127).astype(np.int8)
    b_q = None
    if b is not None:
        b_q = np.clip(np.rint(b / (scale_w * scale_x)), -(2**31), 2**31 - 1).astype(np.int32)
    mults = scale_w * scale_x / scale_y
    resc = [decompose_multiplier(float(m)) for m in mults]
    qs = np.array([r.quant_scale for r in resc], np.float32)
    qsh = np.array([r.quant_shift for r in resc], np.float32)

    def put(a):
        return torch.from_numpy(a).to(dev)

    return QuantizedLinear(
        weight_q=put(w_q),
        bias_q=None if b_q is None else put(b_q),
        quant_scale=put(qs),
        quant_shift=put(qsh),
        scale_x=float(scale_x),
        scale_y=float(scale_y),
    )


def div127(t: torch.Tensor) -> torch.Tensor:
    """``t / 127`` as one IEEE division on every device.  CUDA divides by a
    host scalar as a multiply by its reciprocal, which can land one
    rounding away from the quotient ``repro`` (and the CPU) computes, and a
    scale one ulp off moves int8 codes; a divisor tensor on ``t``'s device
    (a fill, no host copy) takes the true division."""
    return t / t.new_full((), 127.0)


def dynamic_quantize(x: torch.Tensor):
    """Per-tensor dynamic activation quantization (the serving fallback when
    no static calibration is available): int8 codes and the f32 scale."""
    absmax = x.to(torch.float32).abs().max()
    s = torch.clamp_min(div127(absmax), 1e-12)
    q = torch.clamp(torch.round(x.to(torch.float32) / s), -128, 127).to(torch.int8)
    return q, s
