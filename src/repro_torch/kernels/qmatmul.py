"""Fused pre-quantized matmul: the hand-written CUDA kernel
(``csrc/qmatmul.cu``), its plain PyTorch version, the split-K planner and
the launch counters.

Replaces ``repro/kernels/qmatmul.py::qmatmul`` (int8 weights) and
``::qmatmul_packed`` (int4 weights, two nibbles per byte).  Both compute

    int8 x · W → int32 → + bias → f32 → × quant_scale [→ × quant_shift]
    → [ReLU] → round half to even → clip to int8 / uint8 [→ lut[q + 128]]

on operands the plan template prepared once: the weight stored K-contiguous
as ``(Np, Kp)`` int8 — or ``(Np, Kp // 2)`` uint8 nibble pairs, byte
``[n, r]`` holding k = 2r in its low and k = 2r + 1 in its high nibble — and
bias / scales as ``(1, Np)`` rows.  Only ``Kp`` and ``Np`` are padded (to the
kernel's 64-byte K stage and 64-column tile); the activation ``x`` arrives
unpadded ``(M, K)`` — any K >= 1, at any byte alignment — and the kernel
masks the ragged M and K edges itself.

A launch's route is chosen from its shape and recorded, never because
another route failed: the row tile ``bm`` (16: the decode route, 64: the
tile route) and the number of K splits ``splits`` come from the bound shape
record (:func:`choose_bm`, :func:`choose_splits`); the staging of ``x``
(16-byte ``cp.async`` copies, or bytes staged by the threads) from K and the
pointer at launch (:func:`route`).  Every route runs the same int8
tensor-core mainloop.  What bounds the kernel on an H100 and what its
design does about it is in the note at the top of ``csrc/qmatmul.cu``.

One fused call is one kernel launch and one device kernel, split or not:
the split reduction happens inside it (the last split block of a tile runs
the epilogue).  Its int32 workspace and per-tile tickets are allocated by
the wrapper, once per device and stream, and grown when a call needs more
(the tickets by ``torch.zeros``; each call leaves them zero).

With ``lut`` — a contiguous ``(256,)`` int8 or uint8 table on x's device —
the epilogue computes the int8 code ``q`` as without one and stores
``lut[q + 128]``: the exact activation table of
:mod:`repro_torch.kernels.qact_lut`, applied in registers where the plan
folds a LUT step into the matmul that feeds it (``core/compile.py``).  The
output then has the table's dtype, and ``out_dtype`` must be int8.  A table
the kernel cannot take is refused with a ``ValueError``.

A wrapper runs the plain version only for tensors on the CPU (that is how
the CPU tests reach the planned path); for CUDA tensors it launches the
kernel or raises.  :data:`LAUNCHES` counts kernel launches, nothing else:
each launch under its lane's name, and a launch that carried a table under
``qmatmul_lut`` as well.
"""
from __future__ import annotations

import ctypes
import threading
from typing import Dict, List, Optional, Tuple

import torch

from . import _build
from . import ref as _ref
from .qact_lut import qact_lut_plain

#: The kernel's compile-time tiles: Kp and Np pad to multiples of BK / BN;
#: bm (the rows per block) is one of SUPPORTED_BM, chosen per bucket.
BK, BN = 64, 64
SUPPORTED_BM = (16, 64)
BM = 64
#: Shared-memory ring depth of each route (``csrc/qmatmul.cu``).
STAGES = {16: 6, 64: 4}
#: The tensor-core instruction of every route.
INSTRUCTION = "mma.sync.m16n8k32.s32.s8.s8.s32"
#: Streaming multiprocessors of an H100: the split planner aims for twice
#: as many blocks.
NUM_SMS = 132

#: Kernel launches since the last reset, by kernel name: each lane's, and
#: ``qmatmul_lut`` for the launches (of either lane) that carried a table.
LAUNCHES: Dict[str, int] = {"qmatmul": 0, "qmatmul_packed": 0, "qmatmul_lut": 0}

_ARGTYPES = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 12 + [ctypes.c_void_p]
_ATTR_ARGTYPES = [ctypes.c_int] * 3 + [ctypes.c_void_p] * 2

#: Split-K scratch, (int32 workspace, int32 tickets), by (device, stream).
_SCRATCH: Dict[Tuple[int, int], Tuple[torch.Tensor, torch.Tensor]] = {}
_SCRATCH_LOCK = threading.Lock()


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


def choose_splits(m, kp: int, np_: int, bm: int, bn: int = BN) -> int:
    """The number of K splits for a bound shape: enough that output tiles ×
    splits reaches about ``2 × NUM_SMS`` blocks, each split holding whole
    ``BK`` stages (so at most ``kp // BK`` splits); 1 where the tiles alone
    already fill the card, and 1 when M is unknown."""
    if not m:
        return 1
    tiles = -(-int(m) // bm) * (np_ // bn)
    if tiles >= NUM_SMS:
        return 1
    return max(1, min(kp // BK, -(-2 * NUM_SMS // tiles)))


def split_ranges(kp: int, splits: int) -> List[Tuple[int, int]]:
    """The ``[k0, k1)`` range of each split, as the kernel computes it:
    split z owns stages ``[z·S // splits, (z+1)·S // splits)`` of the
    ``S = kp // BK``."""
    s = kp // BK
    if kp % BK or not 1 <= splits <= s:
        raise ValueError(f"splits={splits} for Kp={kp}: need 1 <= splits <= Kp / {BK}")
    return [(BK * (z * s // splits), BK * ((z + 1) * s // splits)) for z in range(splits)]


def route(x_q: torch.Tensor, bm: int, splits: int) -> Dict[str, object]:
    """The route a launch on ``x_q`` takes: the instruction, the tiles, the
    splits, the ring depth and the staging of x — 16-byte ``cp.async``
    copies when K % 16 == 0 and x is 16-byte aligned, else bytes staged by
    the threads into the same shared-memory layout."""
    k = x_q.shape[-1]
    x16 = k % 16 == 0 and x_q.data_ptr() % 16 == 0
    return {"instruction": INSTRUCTION, "bm": bm, "bn": BN, "splits": splits,
            "stages": STAGES[bm], "staging": "cp.async16" if x16 else "bytes"}


def kernel_attrs(bm: int, packed: bool, x16: bool) -> Dict[str, int]:
    """The static shared memory (bytes) and registers per thread of the
    kernel instance a launch with ``(bm, packed, x16)`` takes, as
    ``cudaFuncGetAttributes`` reports them (needs the card)."""
    shared, regs = ctypes.c_int(0), ctypes.c_int(0)
    fn = _build.function("qmatmul", "repro_qmatmul_attrs", _ATTR_ARGTYPES)
    _build.check(fn(bm, int(packed), int(x16), ctypes.byref(shared), ctypes.byref(regs)),
                 "qmatmul attributes")
    return {"shared_bytes": shared.value, "regs": regs.value}


def check_lut(name: str, x_q: torch.Tensor, lut, out_dtype: torch.dtype) -> None:
    """Refuse a table the epilogue cannot take: it must be a contiguous
    ``(256,)`` int8/uint8 tensor on x's device, applied to int8 codes."""
    if lut is None:
        return
    if not isinstance(lut, torch.Tensor) or lut.shape != (256,) \
            or lut.dtype not in (torch.int8, torch.uint8):
        raise ValueError(f"{name}: lut must be a (256,) int8/uint8 tensor, got "
                         f"{getattr(lut, 'dtype', type(lut).__name__)}"
                         f"{tuple(getattr(lut, 'shape', ()))}")
    if lut.device != x_q.device or not lut.is_contiguous():
        raise ValueError(f"{name}: lut must be contiguous and on x's device {x_q.device}, "
                         f"got {lut.device}")
    if out_dtype != torch.int8:
        raise ValueError(f"{name}: a lut indexes int8 codes, so out_dtype must be int8, "
                         f"got {out_dtype} (the output takes the table's dtype)")


def _scratch(device: torch.device, stream: int, ws_numel: int, tiles: int):
    """The split-K workspace and tickets for one stream, grown to size."""
    key = (device.index, stream)
    with _SCRATCH_LOCK:
        ws, tickets = _SCRATCH.get(key, (None, None))
        if ws is None or ws.numel() < ws_numel:
            ws = torch.empty(ws_numel, dtype=torch.int32, device=device)
        if tickets is None or tickets.numel() < tiles:
            tickets = torch.zeros(tiles, dtype=torch.int32, device=device)
        _SCRATCH[key] = (ws, tickets)
    return ws, tickets


def take_scratch(device: torch.device, stream: int):
    """Hand over the split-K scratch of one stream, or None: the caller
    keeps it alive (a CUDA graph captured on that stream reads it on every
    replay), and a later launch on the stream allocates its own."""
    with _SCRATCH_LOCK:
        return _SCRATCH.pop((device.index, stream), None)


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
    splits: int = 1,
    lut: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """The plain PyTorch version of :func:`qmatmul`: same operands, same
    result ``(M, n)``; the tiles and splits do not change it.  With a table
    it is the matmul and then the plain table gather."""
    check_lut("qmatmul", x_q, lut, out_dtype)
    k = x_q.shape[1]
    out = _ref.qmatmul_ref(
        x_q, w_q[:n, :k].t(), bias_q[0, :n], quant_scale[0, :n], quant_shift[0, :n],
        out_dtype=out_dtype, relu=relu, two_mul=two_mul,
    )
    return out if lut is None else qact_lut_plain(out, lut)


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
    splits: int = 1,
    lut: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """The plain PyTorch version of :func:`qmatmul_packed`."""
    return qmatmul_plain(
        x_q, unpack_int4_nk(w_p), bias_q, quant_scale, quant_shift,
        n=n, out_dtype=out_dtype, relu=relu, two_mul=two_mul, lut=lut,
    )


def _launch(name, packed, x_q, w, bias_q, quant_scale, quant_shift, *, n, out_dtype, relu,
            two_mul, bm, splits, lut):
    if x_q.device.type != "cuda":
        raise ValueError(f"{name}: tensors must be on a CUDA device or the CPU, got {x_q.device}")
    check_lut(name, x_q, lut, out_dtype)
    m, k = x_q.shape
    np_, kcols = w.shape
    kp = 2 * kcols if packed else kcols
    want_w = torch.uint8 if packed else torch.int8
    if x_q.dtype != torch.int8 or w.dtype != want_w:
        raise ValueError(f"{name}: want int8 x and {want_w} w, got {x_q.dtype} and {w.dtype}")
    if out_dtype not in (torch.int8, torch.uint8):
        raise ValueError(f"{name}: out_dtype must be int8 or uint8, got {out_dtype}")
    if kp % BK or np_ % BN or not 1 <= k <= kp or not 1 <= n <= np_ \
            or bm not in SUPPORTED_BM or not 1 <= splits <= kp // BK:
        raise ValueError(
            f"{name}: shapes the kernel does not take: x {tuple(x_q.shape)}, w "
            f"{tuple(w.shape)}, n={n}, bm={bm}, splits={splits} (need Kp % {BK} == 0, "
            f"Np % {BN} == 0, 1 <= K <= Kp, 1 <= n <= Np, bm in {SUPPORTED_BM}, "
            f"1 <= splits <= Kp / {BK})"
        )
    ops = (x_q, w, bias_q, quant_scale, quant_shift)
    if any(t.device != x_q.device or not t.is_contiguous() for t in ops):
        raise ValueError(f"{name}: operands must be contiguous and on one device")
    if w.data_ptr() % 16:
        raise ValueError(f"{name}: the weight must be 16-byte aligned")
    if bias_q.dtype != torch.int32 or bias_q.numel() != np_ or quant_scale.numel() != np_ \
            or quant_shift.numel() != np_:
        raise ValueError(f"{name}: bias/scales must be ({np_},) rows, bias int32")
    out = torch.empty((m, n), dtype=out_dtype if lut is None else lut.dtype, device=x_q.device)
    x16 = route(x_q, bm, splits)["staging"] == "cp.async16"
    stream = torch.cuda.current_stream(x_q.device).cuda_stream
    ws_ptr = tickets_ptr = None
    if splits > 1 and m > 0:
        tiles = -(-m // bm) * (np_ // BN)
        ws, tickets = _scratch(x_q.device, stream, splits * tiles * bm * BN, tiles)
        ws_ptr, tickets_ptr = ws.data_ptr(), tickets.data_ptr()
    fn = _build.function("qmatmul", "repro_qmatmul", _ARGTYPES)
    rc = fn(
        x_q.data_ptr(), w.data_ptr(), bias_q.data_ptr(), quant_scale.data_ptr(),
        quant_shift.data_ptr(), None if lut is None else lut.data_ptr(), out.data_ptr(),
        ws_ptr, tickets_ptr, m, k, n, kp, np_, bm, splits, int(x16), int(packed), int(relu),
        int(two_mul), int(out_dtype == torch.uint8), stream,
    )
    _build.check(rc, name)
    LAUNCHES[name] += 1
    if lut is not None:
        LAUNCHES["qmatmul_lut"] += 1
    return out


def qmatmul(x_q, w_q, bias_q, quant_scale, quant_shift, *, n: int,
            out_dtype: torch.dtype = torch.int8, relu: bool = False,
            two_mul: bool = True, bm: int = BM, splits: int = 1,
            lut: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Fused int8 matmul ``(M, K) × (Np, Kp)ᵀ → (M, n)`` (operands as
    :func:`qmatmul_plain` takes them), with an optional activation table in
    its epilogue: the CUDA kernel on the card, the plain version on the CPU."""
    if x_q.device.type == "cpu":
        return qmatmul_plain(x_q, w_q, bias_q, quant_scale, quant_shift, n=n,
                             out_dtype=out_dtype, relu=relu, two_mul=two_mul, bm=bm, lut=lut)
    return _launch("qmatmul", False, x_q, w_q, bias_q, quant_scale, quant_shift, n=n,
                   out_dtype=out_dtype, relu=relu, two_mul=two_mul, bm=bm, splits=splits,
                   lut=lut)


def qmatmul_packed(x_q, w_p, bias_q, quant_scale, quant_shift, *, n: int,
                   out_dtype: torch.dtype = torch.int8, relu: bool = False,
                   two_mul: bool = True, bm: int = BM, splits: int = 1,
                   lut: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Fused packed-int4 matmul ``(M, K) × (Np, Kp // 2)`` nibble pairs →
    ``(M, n)``, table optional: the CUDA kernel on the card, the plain
    version on the CPU."""
    if x_q.device.type == "cpu":
        return qmatmul_packed_plain(x_q, w_p, bias_q, quant_scale, quant_shift, n=n,
                                    out_dtype=out_dtype, relu=relu, two_mul=two_mul, bm=bm,
                                    lut=lut)
    return _launch("qmatmul_packed", True, x_q, w_p, bias_q, quant_scale, quant_shift, n=n,
                   out_dtype=out_dtype, relu=relu, two_mul=two_mul, bm=bm, splits=splits,
                   lut=lut)
