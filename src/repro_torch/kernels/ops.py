"""Plan-time half of the fused-kernel wrappers: parameter templates, per-axis
binding of the shape records, and the planned matmul call.

Handled here, once per template, so the kernels stay tile-pure:

* uint8 activations fold to int8 by the identity
  ``x_u8 @ W = (x_s8 + 128) @ W = x_s8 @ W + 128·colsum(W)`` — a bias
  correction computed at plan time;
* the weight is padded to the kernel's tiles and stored in the layout the
  CUDA kernel reads best: K-contiguous ``(Np, Kp)`` int8, or ``(Np, Kp // 2)``
  uint8 nibble pairs for 4-bit weights.  The shape record says so
  (``layout=nk``), so ``print(plan)`` shows it;
* scalar vs per-channel rescales broadcast to padded ``(1, Np)`` rows.

Every array lands on the plan's device here, once; a bucket specialization
only binds M and the row tile, sharing these tensors.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from . import pack as _pack
from . import qmatmul as _qmm


def _round_up(x: int, m: int) -> int:
    return (x + m - 1) // m * m


def fold_uint8_input(w_q: np.ndarray, bias_q: Optional[np.ndarray]) -> np.ndarray:
    """The bias correction that turns a uint8-activation matmul into a
    signed-int8 one: ``bias' = bias + 128 · Σ_k W[k, :]``."""
    corr = 128 * np.sum(np.asarray(w_q, np.int32), axis=0, dtype=np.int32)
    return corr if bias_q is None else np.asarray(bias_q, np.int32) + corr


def template_qmatmul_params(
    w_q: np.ndarray,  # (K, N) int8 (unpacked; values in [-8, 7] when weight_bits=4)
    bias_q: Optional[np.ndarray],  # (N,) int32
    quant_scale: np.ndarray,  # scalar or (N,) f32
    quant_shift: np.ndarray,  # scalar or (N,) f32
    *,
    weight_bits: int = 8,
    device="cpu",
):
    """The M-independent half of qmatmul specialization: pad, lay out and
    (for 4-bit weights) pack the parameters once per template.

    Returns ``(consts, shape)``: ``consts = (w2, b2, qs2, qsh2)`` tensors on
    ``device`` — ``w2`` the ``(np, kp)`` int8 weight, K-contiguous, or its
    ``(np, kp // 2)`` uint8 packing; ``b2``/``qs2``/``qsh2`` ``(1, np)`` rows —
    and ``shape`` the M-open record ``{k, n, kp, np, bk, bn, layout}`` (plus
    ``bits: 4`` on the packed lane).  Zero padding is exact for integer
    matmul; scales pad with 1.0 so the padded epilogue stays finite."""
    if weight_bits not in (4, 8):
        raise ValueError(f"unsupported weight_bits: {weight_bits!r}")
    k, n = int(w_q.shape[0]), int(w_q.shape[1])
    _, bk, bn = _qmm.choose_tiles(None, k, n)
    kp, np_ = _round_up(k, bk), _round_up(n, bn)
    w2 = np.zeros((kp, np_), np.int8)
    w2[:k, :n] = np.asarray(w_q, np.int8)
    if weight_bits == 4:
        w2 = _pack.pack_int4(w2)  # (kp // 2, np) uint8, zero rows pack to 0x00
    b2 = np.zeros((1, np_), np.int32)
    if bias_q is not None:
        b2[0, :n] = np.asarray(bias_q, np.int32).reshape(-1)
    qs2 = np.ones((1, np_), np.float32)
    qs2[0, :n] = np.broadcast_to(np.asarray(quant_scale, np.float32).reshape(1, -1), (1, n))
    qsh2 = np.ones((1, np_), np.float32)
    qsh2[0, :n] = np.broadcast_to(np.asarray(quant_shift, np.float32).reshape(1, -1), (1, n))
    consts = tuple(
        torch.from_numpy(np.ascontiguousarray(a)).to(device)
        for a in (w2.T, b2, qs2, qsh2)
    )
    shape = {"k": k, "n": n, "kp": kp, "np": np_, "bk": bk, "bn": bn, "layout": "nk"}
    if weight_bits != 8:
        shape["bits"] = weight_bits  # omitted at 8, as in the reference's records
    return consts, shape


def bind_qmatmul_axes(shape: dict, bindings: Optional[dict], *, partial: bool = False) -> dict:
    """Close a template shape record over concrete per-axis buckets.

    ``shape["lead"]`` holds the activation's leading dims as inferred at
    template-build time: ints, named axes (``"N"``/``"S"``), ``None`` in the
    leading position for the legacy implicit batch, or ``None`` as a whole
    when nothing was known.  The flat M is the product of the lead dims with
    ``bindings`` substituted; only ``m`` and the row tile ``bm`` are
    computed — the parameter tensors are the template's.  ``partial=True``
    substitutes the given axes but keeps the record open."""
    bindings = bindings or {}
    lead = shape.get("lead")
    if partial:
        if lead is None:
            return dict(shape)
        new_lead = []
        for i, d in enumerate(lead):
            if isinstance(d, str) and d in bindings:
                d = int(bindings[d])
            elif d is None and i == 0 and "N" in bindings:
                d = int(bindings["N"])
            new_lead.append(d)
        out = dict(shape)
        out["lead"] = tuple(new_lead)
        return out
    if lead is None:
        m: Optional[int] = None  # inference knew nothing: keep the default bm
    else:
        m = 1
        for i, d in enumerate(lead):
            if isinstance(d, str):
                d = bindings.get(d)
            elif d is None and i == 0:
                d = bindings.get("N")  # legacy implicit batch
            if not isinstance(d, int):
                m = None  # still-unknown dim: fall back to the default bm
                break
            m *= int(d)
    bound = {key: v for key, v in shape.items() if key != "lead"}
    bound["m"] = m
    bound["bm"] = _qmm.choose_bm(m)
    return bound


def with_tiles(shape: dict, *, bm: Optional[int] = None, bk: Optional[int] = None,
               bn: Optional[int] = None) -> dict:
    """A copy of a *bound* qmatmul shape record with tile overrides.  The
    CUDA kernel is compiled for one K stage and column tile (``BK``/``BN``)
    and the row tiles in ``SUPPORTED_BM``, so only those are legal."""
    out = dict(shape)
    if bm is not None:
        if bm not in _qmm.SUPPORTED_BM:
            raise ValueError(f"bm={bm} is not one of the kernel's row tiles {_qmm.SUPPORTED_BM}")
        out["bm"] = int(bm)
    if bk is not None and bk != _qmm.BK:
        raise ValueError(f"bk={bk}: the kernel stages K {_qmm.BK} bytes at a time")
    if bn is not None and bn != _qmm.BN:
        raise ValueError(f"bn={bn}: the kernel's column tile is {_qmm.BN}")
    return out


def _bind_dim(d, bindings: dict):
    if isinstance(d, str) and d in bindings:
        return int(bindings[d])
    return d


def bind_qattention_axes(shape: dict, bindings: Optional[dict], *, partial: bool = False) -> dict:
    """Close a fused-attention template record ``{"b": lead dims, "s", "t",
    "dh"}`` over concrete buckets: substitute the bindings and flatten ``b``
    to its product.  The kernel runs one block per query row, so there is no
    query tile to choose.  ``partial=True`` keeps the record open."""
    bindings = bindings or {}
    out = dict(shape)
    lead = tuple(_bind_dim(d, bindings) for d in shape.get("b", ()))
    out["s"] = _bind_dim(shape.get("s"), bindings)
    out["t"] = _bind_dim(shape.get("t"), bindings)
    if partial:
        out["b"] = lead
        return out
    b = 1
    for d in lead:
        if not isinstance(d, int):
            raise ValueError(f"unbound attention batch dim {d!r} in {shape!r}")
        b *= int(d)
    if not isinstance(out["s"], int) or not isinstance(out["t"], int):
        raise ValueError(f"unbound attention seq dims in {out!r}")
    out["b"] = b
    return out


def specialize_qmatmul_params(w_q, bias_q, quant_scale, quant_shift, *,
                              m: Optional[int] = None, weight_bits: int = 8, device="cpu"):
    """Fully static specialization (the ``batch="static"`` path): template
    plus an immediate bind of M."""
    consts, shape = template_qmatmul_params(
        w_q, bias_q, quant_scale, quant_shift, weight_bits=weight_bits, device=device
    )
    return consts, bind_qmatmul_axes({**shape, "lead": (m,)}, None)


def quantized_matmul_planned(
    x_q: torch.Tensor,  # (..., K) int8 (uint8 already folded at plan time)
    w2: torch.Tensor,  # (np, kp) int8 or (np, kp // 2) uint8 — from the template
    b2: torch.Tensor,  # (1, np) int32
    qs2: torch.Tensor,  # (1, np) f32
    qsh2: torch.Tensor,  # (1, np) f32
    shape: dict,  # the bound record
    *,
    out_dtype: torch.dtype = torch.int8,
    relu: bool = False,
    two_mul: bool = True,
) -> torch.Tensor:
    """Shape-specialized fused matmul over arbitrary leading dims: nothing is
    padded per call (the kernel masks the ragged M and K edges), and
    ``shape["bits"] == 4`` selects the packed-int4 kernel."""
    k, n = shape["k"], shape["n"]
    lead = x_q.shape[:-1]
    if x_q.shape[-1] != k:
        raise ValueError(f"activation has K={x_q.shape[-1]}, the plan expects {k}")
    x2 = x_q.reshape(-1, k)
    kernel = _qmm.qmatmul_packed if shape.get("bits", 8) == 4 else _qmm.qmatmul
    out = kernel(
        x2, w2, b2, qs2, qsh2, n=n, out_dtype=out_dtype, relu=relu, two_mul=two_mul,
        bm=shape["bm"],
    )
    return out.reshape(tuple(lead) + (n,))
