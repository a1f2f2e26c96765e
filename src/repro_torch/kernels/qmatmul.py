"""Fused pre-quantized matmul: the hand-written CUDA kernel
(``csrc/qmatmul.cu``), its plain PyTorch version and its launch counters.

Replaces ``repro/kernels/qmatmul.py::qmatmul`` (int8 weights) and
``::qmatmul_packed`` (int4 weights, two nibbles per byte).  Both compute

    int8 x · W → int32 → + bias → f32 → × quant_scale [→ × quant_shift]
    → [ReLU] → round half to even → clip to int8 / uint8

on operands the plan template prepared once: the weight stored K-contiguous
as ``(Np, Kp)`` int8 — or ``(Np, Kp // 2)`` uint8 nibble pairs, byte
``[n, r]`` holding k = 2r in its low and k = 2r + 1 in its high nibble — and
bias / scales as ``(1, Np)`` rows.  Only ``Kp`` and ``Np`` are padded (to the
kernel's 64-byte K stage and 64-column tile); the activation ``x`` arrives
unpadded ``(M, K)`` and the kernel masks the ragged M and K edges itself.

What bounds the kernel on an H100 and what its design does about it is in
the note at the top of ``csrc/qmatmul.cu``.

A wrapper runs the plain version only for tensors on the CPU (that is how
the CPU tests reach the planned path); for CUDA tensors it launches the
kernel or raises.  :data:`LAUNCHES` counts kernel launches, nothing else.
"""
from __future__ import annotations

import ctypes
from typing import Dict

import torch

from . import _build
from . import ref as _ref

#: The kernel's compile-time tiles: Kp and Np pad to multiples of BK / BN;
#: bm (the rows per block) is one of SUPPORTED_BM, chosen per bucket.
BK, BN = 64, 64
SUPPORTED_BM = (16, 64)
BM = 64

#: Kernel launches since the last reset, by kernel name.
LAUNCHES: Dict[str, int] = {"qmatmul": 0, "qmatmul_packed": 0}

_ARGTYPES = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 10 + [ctypes.c_void_p]


def choose_bm(m) -> int:
    """Per-bucket row tile: a 16-row block for decode-sized M (so a handful
    of rows does not pay 64-row work per weight byte), else 64.  ``m`` may
    be None/0 (unknown) — the default then stands."""
    if not m:
        return BM
    return SUPPORTED_BM[0] if int(m) <= SUPPORTED_BM[0] else BM


def choose_tiles(m, k: int, n: int):
    """(bm, bk, bn) for a problem shape at plan time.  bk and bn are the
    kernel's fixed stage and tile widths; only bm depends on M."""
    return choose_bm(m), BK, BN


def unpack_int4_nk(w_p: torch.Tensor) -> torch.Tensor:
    """``(Np, Kp // 2)`` uint8 nibble pairs → ``(Np, Kp)`` int8: the low
    nibble of byte r is k = 2r, the high nibble k = 2r + 1, both
    sign-extended by shifts (``int8(p << 4) >> 4`` and ``int8(p) >> 4``)."""
    lo = torch.bitwise_left_shift(w_p, 4).view(torch.int8) >> 4
    hi = w_p.view(torch.int8) >> 4
    return torch.stack([lo, hi], dim=-1).reshape(w_p.shape[0], 2 * w_p.shape[1])


def qmatmul_plain(
    x_q: torch.Tensor,  # (M, K) int8
    w_q: torch.Tensor,  # (Np, Kp) int8, K-contiguous
    bias_q: torch.Tensor,  # (1, Np) int32
    quant_scale: torch.Tensor,  # (1, Np) f32
    quant_shift: torch.Tensor,  # (1, Np) f32
    *,
    n: int,
    out_dtype: torch.dtype = torch.int8,
    relu: bool = False,
    two_mul: bool = True,
    bm: int = BM,
) -> torch.Tensor:
    """The plain PyTorch version of :func:`qmatmul`: same operands, same
    result ``(M, n)``."""
    k = x_q.shape[1]
    return _ref.qmatmul_ref(
        x_q, w_q[:n, :k].t(), bias_q[0, :n], quant_scale[0, :n], quant_shift[0, :n],
        out_dtype=out_dtype, relu=relu, two_mul=two_mul,
    )


def qmatmul_packed_plain(
    x_q: torch.Tensor,  # (M, K) int8
    w_p: torch.Tensor,  # (Np, Kp // 2) uint8 nibble pairs
    bias_q: torch.Tensor,
    quant_scale: torch.Tensor,
    quant_shift: torch.Tensor,
    *,
    n: int,
    out_dtype: torch.dtype = torch.int8,
    relu: bool = False,
    two_mul: bool = True,
    bm: int = BM,
) -> torch.Tensor:
    """The plain PyTorch version of :func:`qmatmul_packed`."""
    return qmatmul_plain(
        x_q, unpack_int4_nk(w_p), bias_q, quant_scale, quant_shift,
        n=n, out_dtype=out_dtype, relu=relu, two_mul=two_mul, bm=bm,
    )


def _launch(name, packed, x_q, w, bias_q, quant_scale, quant_shift, *, n, out_dtype, relu, two_mul, bm):
    if x_q.device.type != "cuda":
        raise ValueError(f"{name}: tensors must be on a CUDA device or the CPU, got {x_q.device}")
    m, k = x_q.shape
    np_, kcols = w.shape
    kp = 2 * kcols if packed else kcols
    want_w = torch.uint8 if packed else torch.int8
    if x_q.dtype != torch.int8 or w.dtype != want_w:
        raise ValueError(f"{name}: want int8 x and {want_w} w, got {x_q.dtype} and {w.dtype}")
    if out_dtype not in (torch.int8, torch.uint8):
        raise ValueError(f"{name}: out_dtype must be int8 or uint8, got {out_dtype}")
    if kp % BK or np_ % BN or k % 4 or k > kp or n > np_ or bm not in SUPPORTED_BM:
        raise ValueError(
            f"{name}: shapes the kernel does not take: x {tuple(x_q.shape)}, w "
            f"{tuple(w.shape)}, n={n}, bm={bm} (need Kp % {BK} == 0, Np % {BN} == 0, "
            f"K % 4 == 0, bm in {SUPPORTED_BM})"
        )
    ops = (x_q, w, bias_q, quant_scale, quant_shift)
    if any(t.device != x_q.device or not t.is_contiguous() for t in ops):
        raise ValueError(f"{name}: operands must be contiguous and on one device")
    if x_q.data_ptr() % 4:
        raise ValueError(f"{name}: x must be 4-byte aligned")
    if bias_q.dtype != torch.int32 or bias_q.numel() != np_ or quant_scale.numel() != np_ \
            or quant_shift.numel() != np_:
        raise ValueError(f"{name}: bias/scales must be ({np_},) rows, bias int32")
    out = torch.empty((m, n), dtype=out_dtype, device=x_q.device)
    fn = _build.function("qmatmul", "repro_qmatmul", _ARGTYPES)
    rc = fn(
        x_q.data_ptr(), w.data_ptr(), bias_q.data_ptr(), quant_scale.data_ptr(),
        quant_shift.data_ptr(), out.data_ptr(), m, k, n, kp, np_, bm, int(packed),
        int(relu), int(two_mul), int(out_dtype == torch.uint8),
        torch.cuda.current_stream(x_q.device).cuda_stream,
    )
    _build.check(rc, name)
    LAUNCHES[name] += 1
    return out


def qmatmul(x_q, w_q, bias_q, quant_scale, quant_shift, *, n: int,
            out_dtype: torch.dtype = torch.int8, relu: bool = False,
            two_mul: bool = True, bm: int = BM) -> torch.Tensor:
    """Fused int8 matmul ``(M, K) × (Np, Kp)ᵀ → (M, n)`` (operands as
    :func:`qmatmul_plain` takes them): the CUDA kernel on the card, the
    plain version on the CPU."""
    if x_q.device.type == "cpu":
        return qmatmul_plain(x_q, w_q, bias_q, quant_scale, quant_shift, n=n,
                             out_dtype=out_dtype, relu=relu, two_mul=two_mul, bm=bm)
    return _launch("qmatmul", False, x_q, w_q, bias_q, quant_scale, quant_shift, n=n,
                   out_dtype=out_dtype, relu=relu, two_mul=two_mul, bm=bm)


def qmatmul_packed(x_q, w_p, bias_q, quant_scale, quant_shift, *, n: int,
                   out_dtype: torch.dtype = torch.int8, relu: bool = False,
                   two_mul: bool = True, bm: int = BM) -> torch.Tensor:
    """Fused packed-int4 matmul ``(M, K) × (Np, Kp // 2)`` nibble pairs →
    ``(M, n)``: the CUDA kernel on the card, the plain version on the CPU."""
    if x_q.device.type == "cpu":
        return qmatmul_packed_plain(x_q, w_p, bias_q, quant_scale, quant_shift, n=n,
                                    out_dtype=out_dtype, relu=relu, two_mul=two_mul, bm=bm)
    return _launch("qmatmul_packed", True, x_q, w_p, bias_q, quant_scale, quant_shift, n=n,
                   out_dtype=out_dtype, relu=relu, two_mul=two_mul, bm=bm)
