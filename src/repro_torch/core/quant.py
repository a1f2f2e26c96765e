"""Symmetric quantization math (paper §3) and integer rescale decomposition (§3.1).

The paper codifies symmetric (zero_point = 0) quantization:

    X = scale_X * X_q                                  (eq. 1)
    Y_intermediate = W_q · X_q + B_q   (int32)         (eq. 5)
    B_q = B / (scale_W * scale_X)      (int32)         (eq. 6)
    Y_q = rescale(Y_intermediate, (scale_W*scale_X)/scale_Y)   (eq. 3/4)

and, for hardware expressiveness (§3.1), decomposes the floating-point rescale
multiplier ``M`` into an integer ``Quant_scale`` (stored as FLOAT, hence exact
only up to 2**24) and a right bit-shift ``Quant_shift = 2**-N``::

    M ≈ Quant_scale * 2**-N

Paper anchors reproduced by :func:`decompose_multiplier` and asserted in tests:

* ``M = 0.25   -> (Quant_scale=1,        N=2)``   (reduced form)
* ``M = 1/3    -> (Quant_scale=11184810, N=25)``  (unreduced floor form)
* largest exactly-representable integer in FLOAT: ``2**24 = 16_777_216``
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple, Union

import numpy as np

# Largest integer exactly representable in IEEE-754 binary32 (paper §3.1).
MAX_EXACT_FLOAT_INT = 2**24  # 16_777_216

_INT_RANGES = {
    "int4": (-8, 7),
    "int8": (-128, 127),
    "uint8": (0, 255),
    "int16": (-32768, 32767),
    "int32": (-(2**31), 2**31 - 1),
}

#: Sub-byte dtypes have no numpy representation; on the numpy side they are
#: stored *unpacked* in the narrowest container that holds their range
#: (QONNX-style: the bitwidth is metadata, the container is int8).
_STORAGE_DTYPES = {"int4": "int8"}

#: Weight bitwidths with a first-class lowering lane.
SUPPORTED_WEIGHT_BITS = (4, 8)


def qrange(dtype: str) -> Tuple[int, int]:
    """(qmin, qmax) for a quantized dtype name."""
    try:
        return _INT_RANGES[dtype]
    except KeyError:
        raise ValueError(f"unsupported quantized dtype: {dtype!r}") from None


def storage_dtype(dtype: str) -> str:
    """The numpy container dtype for a quantized dtype name (int4 → int8)."""
    qrange(dtype)  # validate
    return _STORAGE_DTYPES.get(dtype, dtype)


def weight_dtype_for_bits(bits: int) -> str:
    """The quantized weight dtype name for a signed weight bitwidth."""
    if bits == 8:
        return "int8"
    if bits == 4:
        return "int4"
    raise ValueError(f"unsupported weight bitwidth: {bits!r} (supported: {SUPPORTED_WEIGHT_BITS})")


def round_half_even(x: np.ndarray) -> np.ndarray:
    """ONNX QuantizeLinear rounding: round half to even (numpy rint)."""
    return np.rint(x)


def saturate(x: np.ndarray, dtype: str) -> np.ndarray:
    qmin, qmax = qrange(dtype)
    return np.clip(x, qmin, qmax).astype(storage_dtype(dtype))


def choose_scale(absmax: float, dtype: str = "int8") -> float:
    """Map the profiled numerical range symmetrically onto the integer range.

    For int8 the full range [-absmax, absmax] maps onto [-127, 127] (we use the
    symmetric 127 rather than 128 so that +/- ranges are balanced, matching
    common accelerator practice).  For uint8 (non-negative data, e.g. post-ReLU
    or sigmoid outputs) [0, absmax] maps onto [0, 255].
    """
    if absmax <= 0.0 or not math.isfinite(absmax):
        return 1.0
    if dtype == "uint8":
        return absmax / 255.0
    qmin, qmax = qrange(dtype)
    return absmax / float(qmax)


def choose_scales(absmax: np.ndarray, dtype: str = "int8") -> np.ndarray:
    """Vector form of :func:`choose_scale`: one scale per channel, with the
    same degenerate-range guard (non-positive / non-finite absmax → 1.0)."""
    absmax = np.asarray(absmax, np.float64)
    qmax = float(qrange(dtype)[1])  # symmetric qmax for int8, full 255 for uint8
    ok = np.isfinite(absmax) & (absmax > 0.0)
    return np.where(ok, absmax / qmax, 1.0).astype(np.float32)


def quantize(x: np.ndarray, scale: Union[float, np.ndarray], dtype: str = "int8") -> np.ndarray:
    """X_q = saturate(round(X / scale)) — eq. (1) inverted, with round+clip."""
    scale = np.asarray(scale, dtype=np.float32)
    q = round_half_even(np.asarray(x, dtype=np.float32) / scale)
    return saturate(q, dtype)


def dequantize(x_q: np.ndarray, scale: Union[float, np.ndarray]) -> np.ndarray:
    """X = scale_X * X_q — eq. (1)."""
    return np.asarray(x_q, dtype=np.float32) * np.asarray(scale, dtype=np.float32)


def quantize_bias(b: np.ndarray, scale_w: Union[float, np.ndarray], scale_x: float) -> np.ndarray:
    """B_q = B / (scale_W * scale_X), stored as int32 — eq. (6).

    ``scale_w`` may be per-output-channel (vector); the bias then inherits the
    per-channel scale of the MatMulInteger/ConvInteger accumulator.
    """
    denom = np.asarray(scale_w, dtype=np.float64) * float(scale_x)
    q = np.rint(np.asarray(b, dtype=np.float64) / denom)
    return saturate(q, "int32")


@dataclasses.dataclass(frozen=True)
class Rescale:
    """The §3.1 hardware rescale: ``multiplier ≈ quant_scale * 2**-shift``.

    ``quant_scale`` is an integer stored as FLOAT in the artifact (hence the
    2**24 exactness bound); ``shift`` is the right bit-shift N.  ``multiplier``
    retains the original fp32 value for the 1-Mul codification mode.
    """

    quant_scale: int
    shift: int
    multiplier: float

    @property
    def quant_shift(self) -> float:
        """The FLOAT constant codified in the second Mul operator: 2**-shift."""
        return float(2.0 ** (-self.shift))

    @property
    def realized(self) -> float:
        """The multiplier value actually realized by (quant_scale, shift)."""
        return float(self.quant_scale) * self.quant_shift

    @property
    def per_channel(self) -> bool:
        return False


@dataclasses.dataclass(frozen=True)
class RescaleVector:
    """Per-channel §3.1 rescale: one (quant_scale, shift) pair per output
    channel, codified as two *vector* Mul constants along the output-feature
    axis.  Same exactness contract as :class:`Rescale`, applied elementwise:
    every ``quant_scale`` is an integer ≤ 2**24 (exact as FLOAT) and every
    ``quant_shift`` is a power of two."""

    quant_scale: np.ndarray  # int64 (C,) — integer values, stored as FLOAT in the artifact
    shift: np.ndarray  # int64 (C,) — per-channel right bit-shift N
    multiplier: np.ndarray  # float32 (C,) — original fp32 multipliers

    @property
    def quant_shift(self) -> np.ndarray:
        """The FLOAT vector codified in the second Mul: 2**-shift per channel."""
        return (2.0 ** (-self.shift.astype(np.float64))).astype(np.float32)

    @property
    def realized(self) -> np.ndarray:
        return self.quant_scale.astype(np.float64) * 2.0 ** (-self.shift.astype(np.float64))

    @property
    def per_channel(self) -> bool:
        return True

    def __len__(self) -> int:
        return int(self.quant_scale.shape[0])


def decompose_multipliers(
    multipliers: np.ndarray,
    *,
    max_scale_bits: int = 24,
    reduce: bool = False,
    max_shift: int = 62,
) -> RescaleVector:
    """Per-channel §3.1 decomposition: apply :func:`decompose_multiplier` to
    each channel's multiplier independently (each channel gets its own shift,
    maximizing per-channel precision)."""
    ms = np.asarray(multipliers, dtype=np.float64).reshape(-1)
    parts = [
        decompose_multiplier(float(m), max_scale_bits=max_scale_bits, reduce=reduce, max_shift=max_shift)
        for m in ms
    ]
    return RescaleVector(
        quant_scale=np.asarray([p.quant_scale for p in parts], np.int64),
        shift=np.asarray([p.shift for p in parts], np.int64),
        multiplier=ms.astype(np.float32),
    )


def decompose_multiplier(
    multiplier: float,
    *,
    max_scale_bits: int = 24,
    reduce: bool = False,
    max_shift: int = 62,
) -> Rescale:
    """Decompose a positive fp32 rescale multiplier into (quant_scale, shift).

    Picks the largest shift N (≤ ``max_shift``) such that
    ``floor(multiplier * 2**N) < 2**max_scale_bits`` — i.e. maximal precision
    while the integer quant_scale stays exactly representable as FLOAT —
    then ``quant_scale = floor(multiplier * 2**N)`` (floor matches the paper's
    1/3 → 11184810 example; round would give 11184811).

    With ``reduce=True`` the pair is canonicalized losslessly by halving even
    quant_scales (0.25 → (1, 2) as in the paper's first example, instead of
    the unreduced (8388608, 25)).
    """
    if not (multiplier > 0.0 and math.isfinite(multiplier)):
        raise ValueError(f"rescale multiplier must be positive finite, got {multiplier}")
    limit = 1 << max_scale_bits
    # Largest N with multiplier * 2**N < limit  =>  N < log2(limit / multiplier).
    n = int(math.floor(math.log2(limit / multiplier)))
    # Guard against float log edge cases.
    while multiplier * (2.0**n) >= limit:
        n -= 1
    while n + 1 <= max_shift and multiplier * (2.0 ** (n + 1)) < limit:
        n += 1
    n = min(n, max_shift)
    if n < 0:
        # Multiplier too large to gain fractional precision; clamp shift at 0.
        n = 0
    qs = int(math.floor(multiplier * (2.0**n)))
    qs = max(qs, 1)
    if reduce:
        while qs % 2 == 0 and n > 0:
            qs //= 2
            n -= 1
    return Rescale(quant_scale=qs, shift=n, multiplier=float(multiplier))


def apply_rescale_reference(
    acc_i32: np.ndarray,
    rescale: Rescale,
    out_dtype: str = "int8",
    *,
    two_mul: bool = True,
) -> np.ndarray:
    """Reference (numpy) semantics of the codified rescale + round + clip.

    Follows the artifact op-for-op so compiled backends can be checked for
    bit-exactness: Cast(int32→f32) → Mul(quant_scale as f32) → Mul(2**-N) →
    QuantizeLinear(scale=1, zp=0) ≡ round-half-even + saturate.
    With ``two_mul=False`` a single Mul by the fp32 multiplier is used
    (the paper's 1-Mul codification).

    ``rescale`` may be a per-channel :class:`RescaleVector`; its vectors
    broadcast along the accumulator's last (output-feature) axis.
    """
    x = acc_i32.astype(np.float32)
    if two_mul:
        x = x * np.asarray(rescale.quant_scale, np.float32)
        x = x * np.asarray(rescale.quant_shift, np.float32)
    else:
        x = x * np.asarray(rescale.multiplier, np.float32)
    return saturate(round_half_even(x), out_dtype)


@dataclasses.dataclass(frozen=True)
class QuantizedLinearParams:
    """Everything the artifact embeds for one pre-quantized linear layer."""

    weight_q: np.ndarray  # int8 container, shape (in, out) for MatMulInteger(X, W)
    bias_q: Optional[np.ndarray]  # int32, shape (out,)
    scale_x: float
    scale_w: np.ndarray  # scalar or per-channel (out,)
    scale_y: float
    rescale: Union[Rescale, RescaleVector]  # RescaleVector iff per_channel
    in_dtype: str = "int8"  # int8 or uint8 activations
    out_dtype: str = "int8"
    bits: int = 8  # weight bitwidth; 4 ⇒ weight_q values in [-8, 7], still int8-stored

    @property
    def per_channel(self) -> bool:
        return np.ndim(self.scale_w) > 0


def quantize_linear_layer(
    w: np.ndarray,
    b: Optional[np.ndarray],
    scale_x: float,
    scale_y: float,
    *,
    per_channel: bool = False,
    in_dtype: str = "int8",
    out_dtype: str = "int8",
    reduce: bool = False,
    bits: int = 8,
) -> QuantizedLinearParams:
    """Quantizer-side preparation of one FC layer (eqs. 2–6).

    ``w`` has shape (in, out) — MatMulInteger computes X(…,in) @ W(in,out).
    Per-channel scales are along the output-feature axis.

    ``bits=4`` quantizes weights onto [-8, 7] (scale chosen against qmax=7);
    the §3.1 rescale decomposition is elementwise on the int32 accumulator,
    so it is untouched by the weight bitwidth — only the multiplier value
    changes through the coarser ``scale_w``.
    """
    w_dtype = weight_dtype_for_bits(bits)
    w = np.asarray(w, dtype=np.float32)
    if per_channel:
        scale_w = choose_scales(np.abs(w).max(axis=0), w_dtype)
    else:
        scale_w = np.float32(choose_scale(float(np.abs(w).max()), w_dtype))
    w_q = quantize(w, scale_w, w_dtype)
    b_q = None if b is None else quantize_bias(b, scale_w, scale_x)
    if per_channel:
        # True per-channel rescale: every output channel carries its own
        # multiplier M_c = scale_w[c] * scale_x / scale_y, decomposed
        # independently into (quant_scale_c, shift_c).
        rescale = decompose_multipliers(scale_w.astype(np.float64) * scale_x / scale_y, reduce=reduce)
    else:
        rescale = decompose_multiplier(float(scale_w) * scale_x / scale_y, reduce=reduce)
    return QuantizedLinearParams(
        weight_q=w_q,
        bias_q=b_q,
        scale_x=float(scale_x),
        scale_w=np.asarray(scale_w),
        scale_y=float(scale_y),
        rescale=rescale,
        in_dtype=in_dtype,
        out_dtype=out_dtype,
        bits=bits,
    )


def fc_reference(x_q: np.ndarray, p: QuantizedLinearParams, *, two_mul: bool = True) -> np.ndarray:
    """End-to-end reference for the Fig.1 pattern on already-quantized input."""
    acc = x_q.astype(np.int32) @ p.weight_q.astype(np.int32)
    if p.bias_q is not None:
        acc = acc + p.bias_q.astype(np.int32)
    return apply_rescale_reference(acc, p.rescale, p.out_dtype, two_mul=two_mul)
