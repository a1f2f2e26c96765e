"""Int4 weight packing: 2 nibbles per byte along the contraction (K) axis.

Layout contract (shared by the numpy pre-packer here and the in-kernel
unpack in :mod:`repro.kernels.qmatmul`):

* input is an *unpacked* int4 weight — an int8 array with every value in
  [-8, 7] and an **even** K (rows).  Plan-time pre-padding guarantees even
  K for free: padded ``kp`` is always a multiple of the K tile ``bk``,
  itself a multiple of 128.
* ``packed[r, c]`` holds rows ``2r`` (low nibble) and ``2r + 1`` (high
  nibble) of column ``c``:  ``packed = (w[2r] & 0xF) | (w[2r+1] << 4)``,
  stored uint8 with shape ``(K // 2, N)``.
* unpacking is pure shift arithmetic (no table): the low nibble
  sign-extends via ``int8(p << 4) >> 4``, the high nibble via
  ``int8(p) >> 4`` — both lane-parallel on the VPU, which is why the
  packed Pallas kernel can unpack per tile at register speed.

Pairing along K (not N) keeps the packed tile ``(bk // 2, bn)`` an exact
sub-block of the packed array whenever ``bk`` divides ``kp``, so the tuned
tile lattice shares one packed const zero-copy, exactly like int8.
"""
from __future__ import annotations

import numpy as np

INT4_MIN, INT4_MAX = -8, 7


def pack_int4(w: np.ndarray) -> np.ndarray:
    """Pack an unpacked-int4 ``(K, N)`` int8 array to uint8 ``(K // 2, N)``.

    Raises on odd K or values outside [-8, 7] — packing silently wrapping
    an out-of-range weight would corrupt the model, not just lose accuracy.
    """
    w = np.asarray(w)
    if w.dtype != np.int8:
        raise ValueError(f"pack_int4 expects an int8 container, got {w.dtype}")
    if w.ndim != 2 or w.shape[0] % 2 != 0:
        raise ValueError(f"pack_int4 expects a 2-D even-K array, got shape {w.shape}")
    if w.size and (w.min() < INT4_MIN or w.max() > INT4_MAX):
        raise ValueError(
            f"pack_int4 values out of int4 range [{INT4_MIN}, {INT4_MAX}]: "
            f"[{w.min()}, {w.max()}]"
        )
    lo = w[0::2, :].astype(np.uint8) & 0xF
    hi = w[1::2, :].astype(np.uint8) & 0xF
    return (lo | (hi << 4)).astype(np.uint8)


def unpack_int4(packed: np.ndarray, k: int = None) -> np.ndarray:
    """Inverse of :func:`pack_int4`: uint8 ``(K//2, N)`` → int8 ``(K, N)``.

    ``k`` optionally trims the result back to an original row count (the
    unpacked row count is always even; callers that padded before packing
    pass the pre-padding K).
    """
    p = np.asarray(packed)
    if p.dtype != np.uint8 or p.ndim != 2:
        raise ValueError(f"unpack_int4 expects a 2-D uint8 array, got {p.dtype} {p.shape}")
    lo = np.left_shift(p, 4).view(np.int8) >> 4  # sign-extend low nibble
    hi = p.view(np.int8) >> 4  # arithmetic shift sign-extends the high nibble
    out = np.empty((2 * p.shape[0], p.shape[1]), np.int8)
    out[0::2, :] = lo
    out[1::2, :] = hi
    if k is not None:
        if not 0 < k <= 2 * p.shape[0]:
            raise ValueError(f"k={k} inconsistent with packed rows {p.shape[0]}")
        out = out[:k]
    return out
