"""int8 activation as an exact 256-entry table (the paper's tanh/sigmoid
flows): the plan-time table builder, the hand-written CUDA kernel
(``csrc/qact_lut.cu``), its plain PyTorch version and its launch counter.

Replaces ``repro/kernels/qact_lut.py::qact_lut``.  The artifact codifies
``DequantizeLinear → [Cast f16] → Tanh/Sigmoid → [Cast f32] →
QuantizeLinear``; since the chain's input is int8 it is a pure function of
256 codes, so the compiler evaluates it once with reference-runtime
semantics (:func:`build_lut`) and the kernel is a byte gather
``out = table[x + 128]`` — bit-exact against the reference by construction.

On the main path the table does not run here: where a LUT reads a fused
matmul's output and nothing else does, the plan hands the table to that
matmul's epilogue (:mod:`repro_torch.kernels.qmatmul`, ``lut=``).  This
kernel serves every LUT the plan does not fold.

The kernel takes a contiguous tensor of any shape as a flat byte array, at
any alignment, with no padding.  What bounds it on an H100 and what its
design does about it is in the note at the top of ``csrc/qact_lut.cu``.
For CUDA tensors the wrapper launches the kernel or raises; the plain
version runs only for CPU tensors.  :data:`LAUNCHES` counts kernel
launches, nothing else.
"""
from __future__ import annotations

import ctypes
from typing import Dict

import numpy as np
import torch

from . import _build
from . import ref as _ref

#: Kernel launches since the last reset.
LAUNCHES: Dict[str, int] = {"qact_lut": 0}

#: Resident blocks per SM the grid-stride loop is sized for (256 threads
#: each: 2048 threads, Hopper's limit per SM).
BLOCKS_PER_SM = 8

_ARGTYPES = [ctypes.c_void_p] * 3 + [ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p]


def build_lut(fn, in_scale: float, out_scale: float, out_dtype: str = "int8", compute_dtype: str = "float32") -> np.ndarray:
    """Evaluate DQL→[cast]→fn→[cast]→QL over all 256 int8 codes with numpy
    reference semantics.  ``fn`` maps a float array to a float array."""
    codes = np.arange(-128, 128, dtype=np.int32)
    x = codes.astype(np.float32) * np.float32(in_scale)
    if compute_dtype == "float16":
        y = fn(x.astype(np.float16)).astype(np.float16).astype(np.float32)
    else:
        y = fn(x.astype(np.float32)).astype(np.float32)
    q = np.rint(y / np.float32(out_scale))
    info = np.iinfo(out_dtype)
    return np.clip(q, info.min, info.max).astype(out_dtype)


def qact_lut_plain(x_q: torch.Tensor, lut: torch.Tensor) -> torch.Tensor:
    """The plain PyTorch version of :func:`qact_lut`: the same gather as
    ``ref.qact_lut_ref``, same shape as ``x_q``, ``lut``'s dtype."""
    return _ref.qact_lut_ref(x_q, lut)


def qact_lut(x_q: torch.Tensor, lut: torch.Tensor) -> torch.Tensor:
    """``lut[x_q + 128]`` elementwise over an int8 tensor of any shape: the
    CUDA kernel on the card, the plain version on the CPU."""
    if x_q.device.type == "cpu":
        return qact_lut_plain(x_q, lut)
    if x_q.device.type != "cuda":
        raise ValueError(f"qact_lut: tensors must be on a CUDA device or the CPU, got {x_q.device}")
    if x_q.dtype != torch.int8 or lut.dtype not in (torch.int8, torch.uint8) or lut.shape != (256,):
        raise ValueError(
            f"qact_lut: want an int8 x and a (256,) int8/uint8 lut, got {x_q.dtype} and "
            f"{lut.dtype}{tuple(lut.shape)}"
        )
    if lut.device != x_q.device or not x_q.is_contiguous() or not lut.is_contiguous():
        raise ValueError("qact_lut: x and lut must be contiguous and on one device")
    out = torch.empty(x_q.shape, dtype=lut.dtype, device=x_q.device)
    sms = torch.cuda.get_device_properties(x_q.device).multi_processor_count
    fn = _build.function("qact_lut", "repro_qact_lut", _ARGTYPES)
    rc = fn(
        x_q.data_ptr(), lut.data_ptr(), out.data_ptr(), x_q.numel(), sms * BLOCKS_PER_SM,
        torch.cuda.current_stream(x_q.device).cuda_stream,
    )
    _build.check(rc, "qact_lut")
    LAUNCHES["qact_lut"] += 1
    return out
