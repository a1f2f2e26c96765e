"""Quantization-aware training: fake-quant with straight-through estimator.

The co-design loop: train with fake-quant → calibrate → export a
pre-quantized artifact → the hardware compiler consumes it.  The fake-quant
forward matches the artifact semantics (symmetric, round-half-even,
saturate) so QAT "sees" serving-time numerics.

The straight-through estimator keeps ``repro.core.qat``'s exact form —
``x * gate + (deq - x * gate).detach()`` and ``w + (deq - w).detach()``,
with the detached operands taken before the subtraction so no graph is
built for it — so forward values and gradients match ``repro`` expression
for expression.
Every scale divides as a device tensor (:func:`~repro_torch.core.qlayers.
div127`): CUDA divides by a host scalar as a multiply by its reciprocal,
which can move a code.
"""
from __future__ import annotations

from typing import Optional

import torch

from .qlayers import div127


def fake_quant(x: torch.Tensor, scale, *, qmin: int = -128, qmax: int = 127,
               axis: Optional[int] = None) -> torch.Tensor:
    """quantize→dequantize with STE gradients (identity inside the clip range)."""
    s = torch.as_tensor(scale, dtype=torch.float32, device=x.device)
    if axis is not None and s.ndim:
        shape = [1] * x.ndim
        shape[axis] = -1
        s = s.reshape(shape)
    xf = x.detach().to(torch.float32)
    q = torch.clamp(torch.round(xf / s), qmin, qmax)
    deq = (q * s).to(x.dtype)
    # STE: forward = deq, backward = identity (with clip-range gating)
    gate = ((xf >= qmin * s) & (xf <= qmax * s)).to(x.dtype)
    xg = x * gate
    return xg + (deq - xg.detach())


def weight_codes_per_channel(w: torch.Tensor, *, axis: int = -1):
    """The int8 codes (as float32) and per-channel scales that
    :func:`fake_quant_weight_per_channel` dequantizes; no gradient."""
    red = tuple(i for i in range(w.ndim) if i != (axis % w.ndim))
    xf = w.detach().to(torch.float32)
    absmax = xf.abs().amax(dim=red, keepdim=True)
    s = torch.clamp_min(div127(absmax), 1e-12)
    return torch.clamp(torch.round(xf / s), -128, 127), s


def fake_quant_weight_per_channel(w: torch.Tensor, *, axis: int = -1) -> torch.Tensor:
    """Per-output-channel symmetric weight fake-quant (scale from |w|max)."""
    q, s = weight_codes_per_channel(w, axis=axis)
    deq = (q * s).to(w.dtype)
    return w + (deq - w.detach())


def fake_quant_activation(x: torch.Tensor) -> torch.Tensor:
    """Dynamic per-tensor activation fake-quant (absmax scale)."""
    absmax = x.detach().to(torch.float32).abs().amax()
    s = torch.clamp_min(div127(absmax), 1e-12)
    return fake_quant(x, s)


def qat_matmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """A linear layer as QAT sees it: int8-faithful weights and activations."""
    return fake_quant_activation(x) @ fake_quant_weight_per_channel(w)
