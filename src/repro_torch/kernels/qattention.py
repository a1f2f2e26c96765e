"""Fused int8 attention: the hand-written CUDA kernel
(``csrc/qattention.cu``), its plain PyTorch version and its launch counter.

Replaces ``repro/kernels/qattention.py::qattention``.  It computes the PQ-IR
attention region over a stacked batch of heads:

    int8 Q·Kᵀ → int32 → ×qk_scale → s·mask + (mask−1)·big → row max →
    clip(rint((masked − max) / lut_scale)) → uint8 exp-LUT → int32 den →
    p_q = clip(rint(w / den · p_scale)) → int8 P·V → ×rescale → rint → clip

on unpadded contiguous ``q (B, S, dh)``, ``k``/``v (B, T, dh)`` int8 and
``mask (B, S, T)`` f32.  The kernel needs no padding at all (one block per
query row, keys masked by their count), so neither does its plain version.

What bounds the kernel on an H100 and what its design does about it is in
the note at the top of ``csrc/qattention.cu``.  For CUDA tensors the wrapper
launches the kernel or raises; the plain version runs only for CPU tensors.
"""
from __future__ import annotations

import ctypes
from typing import Dict

import numpy as np
import torch

from . import _build
from . import ref as _ref

#: Kernel launches since the last reset.
LAUNCHES: Dict[str, int] = {"qattention": 0}

#: Shared memory a block can use on Hopper, less the kernel's static 1 KB
#: (the LUT and reduction slots).  The dynamic part holds 4 bytes per key,
#: the query row, and 16 warps' partial contexts (4 bytes per head dim each).
SMEM_BYTES = 232448 - 2048
_WARPS = 16


def max_keys(dh: int) -> int:
    """Most keys a query row may attend at head width ``dh``."""
    return SMEM_BYTES // 4 - dh // 4 - _WARPS * dh


_ARGTYPES = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 4 + [ctypes.c_float] * 5 + [
    ctypes.c_int, ctypes.c_void_p,
]


def qattention_plain(q_q, k_q, v_q, mask, lut, *, qk_scale: float, big: float,
                     lut_scale: float, p_scale: float, rescale: float,
                     out_dtype: torch.dtype = torch.int8) -> torch.Tensor:
    """The plain PyTorch version of :func:`qattention`: same operands,
    same result ``(B, S, dh)``."""
    return _ref.qattention_ref(
        q_q, k_q, v_q, mask, qk_scale, big, lut_scale, lut, p_scale, rescale,
        out_dtype=out_dtype,
    )


def qattention(q_q, k_q, v_q, mask, lut, *, qk_scale: float, big: float,
               lut_scale: float, p_scale: float, rescale: float,
               out_dtype: torch.dtype = torch.int8) -> torch.Tensor:
    """Fused int8 attention: the CUDA kernel on the card, the plain
    version on the CPU.  Scalars are rounded to float32 once, here."""
    if q_q.device.type == "cpu":
        return qattention_plain(
            q_q, k_q, v_q, mask, lut, qk_scale=qk_scale, big=big, lut_scale=lut_scale,
            p_scale=p_scale, rescale=rescale, out_dtype=out_dtype,
        )
    if q_q.device.type != "cuda":
        raise ValueError(f"qattention: tensors must be on a CUDA device or the CPU, got {q_q.device}")
    b, s, dh = q_q.shape
    t = k_q.shape[1]
    if k_q.shape != (b, t, dh) or v_q.shape != (b, t, dh) or mask.shape != (b, s, t):
        raise ValueError(
            f"qattention: shapes q {tuple(q_q.shape)}, k {tuple(k_q.shape)}, "
            f"v {tuple(v_q.shape)}, mask {tuple(mask.shape)} do not agree"
        )
    if (q_q.dtype, k_q.dtype, v_q.dtype, mask.dtype, lut.dtype) != (
        torch.int8, torch.int8, torch.int8, torch.float32, torch.uint8
    ) or lut.numel() != 256:
        raise ValueError("qattention: want int8 q/k/v, f32 mask and a (256,) uint8 lut")
    if out_dtype not in (torch.int8, torch.uint8):
        raise ValueError(f"qattention: out_dtype must be int8 or uint8, got {out_dtype}")
    if dh % 4 or t < 1 or t > max_keys(dh):
        raise ValueError(
            f"qattention: needs dh % 4 == 0 and 1 <= T <= {max_keys(dh)}, got dh={dh}, T={t}"
        )
    ops = (q_q, k_q, v_q, mask, lut)
    if any(x.device != q_q.device or not x.is_contiguous() for x in ops):
        raise ValueError(
            "qattention: operands must be contiguous and on one device "
            "(call .contiguous() on strided head slices)"
        )
    if any(x.data_ptr() % 4 for x in (q_q, k_q, v_q)):
        raise ValueError("qattention: q, k and v must be 4-byte aligned")
    out = torch.empty((b, s, dh), dtype=out_dtype, device=q_q.device)
    fn = _build.function("qattention", "repro_qattention", _ARGTYPES)
    rc = fn(
        q_q.data_ptr(), k_q.data_ptr(), v_q.data_ptr(), mask.data_ptr(), lut.data_ptr(),
        out.data_ptr(), b, s, t, dh,
        *(float(np.float32(c)) for c in (qk_scale, big, lut_scale, p_scale, rescale)),
        int(out_dtype == torch.uint8), torch.cuda.current_stream(q_q.device).cuda_stream,
    )
    _build.check(rc, "qattention")
    LAUNCHES["qattention"] += 1
    return out
