"""Plan-time half of the fused-kernel wrappers: parameter templates, per-axis
binding of the shape records, and the planned matmul, activation and conv
calls.

Handled here, once per template, so the kernels stay tile-pure:

* uint8 activations fold to int8 by the identity
  ``x_u8 @ W = (x_s8 + 128) @ W = x_s8 @ W + 128·colsum(W)`` — a bias
  correction computed at plan time;
* the weight is padded to the kernel's tiles and stored in the layout the
  CUDA kernel reads best: K-contiguous ``(Np, Kp)`` int8, or ``(Np, Kp // 2)``
  uint8 nibble pairs for 4-bit weights.  The shape record says so
  (``layout=nk``), so ``print(plan)`` shows it;
* scalar vs per-channel rescales broadcast to padded ``(1, Np)`` rows;
* a convolution is a matmul over im2col rows: its ``(M, C, kH, kW)`` weight
  is laid out as the ``(K = C·kH·kW, N = M)`` matmul weight, and a uint8
  input's ``128·Σw`` over every tap folds into the bias.  That fold is exact
  only if the padded taps of the *shifted* input read −128 (0 in uint8
  space, as ONNX pads a zero point of 0), so im2col pads with −128 there.

Every array lands on the plan's device here, once; a bucket specialization
only binds M and the row tile, sharing these tensors.  The one call without
a plan, :func:`quantized_matmul` (the model zoo's ``QuantizedLinear``), lays
its weight out the same way on each call.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from . import pack as _pack
from . import qact_lut as _qact
from . import qattention as _qatt
from . import qmatmul as _qmm
from . import ref as _ref


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
    ``bindings`` substituted; only ``m``, the row tile ``bm`` and the number
    of K splits ``splits`` are computed — the parameter tensors are the
    template's.  ``partial=True``
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
    bound["splits"] = _qmm.choose_splits(m, shape["kp"], shape["np"], bound["bm"])
    return bound


def with_tiles(shape: dict, *, bm: Optional[int] = None, bk: Optional[int] = None,
               bn: Optional[int] = None, splits: Optional[int] = None) -> dict:
    """A copy of a *bound* qmatmul shape record with tile overrides.  The
    CUDA kernel is compiled for one K stage and column tile (``BK``/``BN``)
    and the row tiles in ``SUPPORTED_BM``, and each K split holds whole
    stages (``1 <= splits <= kp // BK``), so only those are legal."""
    out = dict(shape)
    if bm is not None:
        if bm not in _qmm.SUPPORTED_BM:
            raise ValueError(f"bm={bm} is not one of the kernel's row tiles {_qmm.SUPPORTED_BM}")
        out["bm"] = int(bm)
    if splits is not None:
        if isinstance(splits, bool) or not isinstance(splits, int) \
                or not 1 <= splits <= out["kp"] // _qmm.BK:
            raise ValueError(f"splits={splits!r}: each K split holds whole {_qmm.BK}-byte "
                             f"stages, so 1 <= splits <= {out['kp'] // _qmm.BK}")
        out["splits"] = int(splits)
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
    "dh"}`` over concrete buckets: substitute the bindings, flatten ``b``
    to its product, and plan ``cluster``, the number of blocks each query
    row's keys are split over (:func:`repro_torch.kernels.qattention
    .choose_cluster` on B·S rows of T keys).  ``partial=True`` keeps the
    record open."""
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
    out["cluster"] = _qatt.choose_cluster(b * out["s"], out["t"], out["dh"])
    return out


def with_cluster(shape: dict, cluster) -> dict:
    """A copy of a *bound* attention record with its cluster size
    overridden; only a size the kernel can launch for the record's T and dh
    is legal (:func:`repro_torch.kernels.qattention.check_cluster`)."""
    return {**shape, "cluster": _qatt.check_cluster(shape["t"], shape["dh"], cluster)}


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
    lut: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Shape-specialized fused matmul over arbitrary leading dims: nothing is
    padded per call (the kernel masks the ragged M and K edges), and
    ``shape["bits"] == 4`` selects the packed-int4 kernel.  ``lut`` is an
    activation table applied in the epilogue (the output takes its dtype)."""
    k, n = shape["k"], shape["n"]
    lead = x_q.shape[:-1]
    if x_q.shape[-1] != k:
        raise ValueError(f"activation has K={x_q.shape[-1]}, the plan expects {k}")
    x2 = x_q.reshape(-1, k)
    kernel = _qmm.qmatmul_packed if shape.get("bits", 8) == 4 else _qmm.qmatmul
    out = kernel(
        x2, w2, b2, qs2, qsh2, n=n, out_dtype=out_dtype, relu=relu, two_mul=two_mul,
        bm=shape["bm"], splits=shape["splits"], lut=lut,
    )
    return out.reshape(tuple(lead) + (n,))


def shift_uint8(x_q: torch.Tensor) -> torch.Tensor:
    """uint8 codes ``u`` as the int8 codes ``u - 128``, in one elementwise
    pass: flipping the top bit and reading the byte as signed is exactly
    that subtraction."""
    return (x_q ^ 128).view(torch.int8)


def quantized_activation(x_q: torch.Tensor, lut: torch.Tensor) -> torch.Tensor:
    """int8 LUT activation over any shape: a contiguous tensor is one flat
    byte array to the kernel, so nothing is padded or reshaped."""
    return _qact.qact_lut(x_q.contiguous(), lut)


def conv_out_hw(h, w, kh: int, kw: int, strides, pads):
    """Output height and width of a convolution; a dim that is not an int
    (a named or unknown axis) stays as it is."""
    oh = (h + pads[0] + pads[2] - kh) // strides[0] + 1 if isinstance(h, int) else h
    ow = (w + pads[1] + pads[3] - kw) // strides[1] + 1 if isinstance(w, int) else w
    return oh, ow


def template_qconv_params(
    w_q: np.ndarray,  # (M, C, kH, kW) int8
    bias_q: Optional[np.ndarray],  # (M,) int32
    quant_scale: np.ndarray,  # scalar or (M,) f32
    quant_shift: np.ndarray,  # scalar or (M,) f32
    *,
    strides=(1, 1),
    pads=(0, 0, 0, 0),
    x_uint8: bool = False,
    device="cpu",
):
    """The batch-independent half of the im2col conv: the weight reshaped to
    ``(M, C·kH·kW)`` and laid out by :func:`template_qmatmul_params` as the
    K-contiguous ``(Np, Kp)`` the qmatmul kernel reads (columns in (c, kh,
    kw) order, as :func:`im2col` builds its rows); per-channel constants lie
    along the output channel, the GEMM's N, and pass through as its
    ``(1, Np)`` rows.  A uint8 input's ``128·Σw`` folds into the bias here,
    once.  Returns ``(consts, shape)``; ``shape`` adds ``kh``, ``kw``,
    ``strides``, ``pads`` and ``x_uint8`` to the matmul record."""
    m, c, kh, kw = (int(d) for d in w_q.shape)
    w2 = np.ascontiguousarray(np.asarray(w_q, np.int8).reshape(m, c * kh * kw).T)  # (K, M)
    if x_uint8:
        bias_q = fold_uint8_input(w2, bias_q)
    consts, shape = template_qmatmul_params(w2, bias_q, quant_scale, quant_shift, device=device)
    shape.update(kh=kh, kw=kw, strides=tuple(int(v) for v in strides),
                 pads=tuple(int(v) for v in pads), x_uint8=bool(x_uint8))
    return consts, shape


def im2col(x: torch.Tensor, kh: int, kw: int, strides, pads, pad_value: int = 0) -> torch.Tensor:
    """``(N, C, H, W)`` int8 → ``(N·OH·OW, C·kH·kW)`` int8 rows: rows in
    (n, oh, ow) order, columns in (c, kh, kw) order.  ``pads`` is ONNX's
    (top, left, bottom, right); the border reads ``pad_value``.  One
    ``F.pad`` copy, a strided view of the patches, one ``.contiguous()``."""
    oh, ow = conv_out_hw(x.shape[2], x.shape[3], kh, kw, strides, pads)
    xp = F.pad(x, (pads[1], pads[3], pads[0], pads[2]), value=pad_value)
    n, c = xp.shape[:2]
    sh, sw = strides
    s_n, s_c, s_h, s_w = xp.stride()
    patches = xp.as_strided((n, oh, ow, c, kh, kw), (s_n, sh * s_h, sw * s_w, s_c, s_h, s_w))
    return patches.contiguous().view(n * oh * ow, c * kh * kw)


def quantized_conv2d_planned(
    x_q: torch.Tensor,  # (N, C, H, W) int8, or uint8 when shape["x_uint8"]
    w2: torch.Tensor,  # (np, kp) int8 — from template_qconv_params
    b2: torch.Tensor,  # (1, np) int32 (uint8 fold included)
    qs2: torch.Tensor,  # (1, np) f32
    qsh2: torch.Tensor,  # (1, np) f32
    shape: dict,  # the bound record
    *,
    out_dtype: torch.dtype = torch.int8,
    relu: bool = False,
    two_mul: bool = True,
) -> torch.Tensor:
    """ConvInteger → epilogue as im2col, then the qmatmul kernel with its
    fused epilogue, then ``(N, OH, OW, M)`` permuted to NCHW (one copy).
    A uint8 input is shifted to int8 and padded with −128, so the plan-time
    ``128·Σw`` fold holds at the borders too."""
    if shape["x_uint8"]:
        x_q = shift_uint8(x_q)
        pad_value = -128
    else:
        pad_value = 0
    n_img = x_q.shape[0]
    cols = im2col(x_q, shape["kh"], shape["kw"], shape["strides"], shape["pads"], pad_value)
    if cols.shape[1] != shape["k"]:
        raise ValueError(f"im2col rows have K={cols.shape[1]}, the plan expects {shape['k']}")
    oh, ow = conv_out_hw(x_q.shape[2], x_q.shape[3], shape["kh"], shape["kw"],
                         shape["strides"], shape["pads"])
    out = _qmm.qmatmul(cols, w2, b2, qs2, qsh2, n=shape["n"], out_dtype=out_dtype,
                       relu=relu, two_mul=two_mul, bm=shape["bm"], splits=shape["splits"])
    return out.view(n_img, oh, ow, shape["n"]).permute(0, 3, 1, 2).contiguous()


def quantized_conv2d(
    x_q: torch.Tensor,  # (N, C, H, W) int8/uint8
    w_q,  # (M, C, kH, kW) int8, tensor or array
    bias_q,  # (M,) int32, or None
    quant_scale,  # float, or (M,)
    quant_shift,  # float, or (M,)
    *,
    strides=(1, 1),
    pads=(0, 0, 0, 0),
    out_dtype: torch.dtype = torch.int8,
    relu: bool = False,
    two_mul: bool = True,
) -> torch.Tensor:
    """ConvInteger + epilogue with no plan, ``repro``'s unplanned conv entry:
    the weight is laid out as a template would lay it out
    (:func:`template_qconv_params`) on every call, the GEMM's M bound to
    this input's N·OH·OW, and the im2col route
    (:func:`quantized_conv2d_planned`) runs the qmatmul kernel (its plain
    version for CPU tensors).  A padded uint8 input reads 0 at its borders,
    as ``ReferenceRuntime`` does (``repro``'s reads 128)."""
    def host(a):
        return None if a is None else np.asarray(a.cpu() if isinstance(a, torch.Tensor) else a)

    consts, shape = template_qconv_params(
        host(w_q), host(bias_q), host(quant_scale), host(quant_shift), strides=strides, pads=pads,
        x_uint8=x_q.dtype == torch.uint8, device=x_q.device)
    oh, ow = conv_out_hw(int(x_q.shape[2]), int(x_q.shape[3]), shape["kh"], shape["kw"],
                         shape["strides"], shape["pads"])
    bound = bind_qmatmul_axes({**shape, "lead": (int(x_q.shape[0]), oh, ow)}, None)
    return quantized_conv2d_planned(x_q.contiguous(), *consts, bound, out_dtype=out_dtype, relu=relu,
                                    two_mul=two_mul)


def bind_qmatmul_batch(shape: dict, batch: Optional[int]) -> dict:
    """Single-axis sugar over :func:`bind_qmatmul_axes`: bind the implicit
    batch axis only."""
    return bind_qmatmul_axes(shape, {} if batch is None else {"N": int(batch)})


def quantized_matmul(
    x_q: torch.Tensor,  # (..., K) int8 or uint8
    w_q: torch.Tensor,  # (K, N) int8
    bias_q: Optional[torch.Tensor],  # (N,) int32
    quant_scale,  # float, or (N,) tensor — integer values as float
    quant_shift,  # float, or (N,) tensor — 2**-N
    *,
    out_dtype: torch.dtype = torch.int8,
    relu: bool = False,
    two_mul: bool = True,
    backend: str = "ref",  # "ref" | "cuda"
) -> torch.Tensor:
    """Fused pre-quantized matmul over arbitrary leading dims, with no plan:
    the entry point ``QuantizedLinear`` calls.

    ``backend="ref"`` is the plain version (:func:`repro_torch.kernels.ref
    .qmatmul_ref`); ``backend="cuda"`` lays the weight out as a template
    would — K-contiguous and padded to the kernel's tiles, scales padded
    with 1.0 — on each call and launches the qmatmul kernel (its plain
    version for CPU tensors, as every wrapper does).  A uint8 input folds to
    int8 first (``bias + 128·Σ_k W``, ``x − 128``)."""
    if backend not in ("ref", "cuda"):
        raise ValueError(f"unknown backend {backend!r}: the port's backends are 'ref' and 'cuda'")
    k, n = w_q.shape
    if x_q.shape[-1] != k:
        raise ValueError(f"activation has K={x_q.shape[-1]}, the weight {tuple(w_q.shape)}")
    dev = x_q.device
    if x_q.dtype == torch.uint8:
        corr = 128 * w_q.to(torch.int32).sum(dim=0, dtype=torch.int32)
        bias_q = corr if bias_q is None else bias_q.to(torch.int32) + corr
        x_q = shift_uint8(x_q)
    qs = torch.as_tensor(quant_scale, dtype=torch.float32, device=dev)
    qsh = torch.as_tensor(quant_shift, dtype=torch.float32, device=dev)
    if backend == "ref":
        return _ref.qmatmul_ref(x_q, w_q, bias_q, qs, qsh, out_dtype=out_dtype, relu=relu,
                                two_mul=two_mul)
    _, bk, bn = _qmm.choose_tiles(None, k, n)
    kp, np_ = _round_up(k, bk), _round_up(n, bn)
    w2 = torch.zeros((np_, kp), dtype=torch.int8, device=dev)
    w2[:n, :k] = w_q.t()
    b2 = torch.zeros((1, np_), dtype=torch.int32, device=dev)
    if bias_q is not None:
        b2[0, :n] = bias_q.reshape(-1)
    qs2 = torch.ones((1, np_), dtype=torch.float32, device=dev)
    qs2[0, :n] = qs.reshape(-1)
    qsh2 = torch.ones((1, np_), dtype=torch.float32, device=dev)
    qsh2[0, :n] = qsh.reshape(-1)
    shape = bind_qmatmul_batch({"k": k, "n": n, "kp": kp, "np": np_, "bk": bk, "bn": bn,
                                "layout": "nk", "lead": (None,)}, x_q.numel() // k)
    return quantized_matmul_planned(x_q.contiguous(), w2, b2, qs2, qsh2, shape,
                                    out_dtype=out_dtype, relu=relu, two_mul=two_mul)
