"""The routed-expert step: the hand-written CUDA kernels
(``csrc/qmoe.cu``), their plain PyTorch version, the weight layout and the
launch counter.

One call computes the codified region of :mod:`repro_torch.core.moe` for
every token of ``x`` (any leading shape, ``D`` last) with only the ``k``
experts the router chose for it:

    router → ranks (ties to the lower id) → exp-table weights of the chosen
    k → int8 codes pq;  per chosen expert: gate → SiLU table, up, their
    product → h;  down → y;  Σ pq · y (int32) → × 1/127 → int8

on operands laid out once by :func:`prepare`: the router ``(E, D)``, the
gate and up weights interleaved into one ``(E, 2F, D)`` tensor (8 gate
rows, then the same 8 features' up rows), the down weight ``(E, D, F)``,
all K-contiguous int8.  The scalars ride in a :class:`MoEScalars`.

For CUDA tensors the wrapper launches the kernels (five launches, counted
under ``qmoe`` in :data:`LAUNCHES`) into scratch it allocates per call, so a
CUDA graph captures the call whole: every grid is fixed by the token count,
and the routing offsets stay on the device.  For CPU tensors it runs
:func:`qmoe_plain`, which groups the routed rows by expert the same way.
"""
from __future__ import annotations

import ctypes
import dataclasses
from typing import Dict

import torch

from . import _build
from .ref import int_matmul, requantize

#: Kernel launches since the last reset: five per call.
LAUNCHES: Dict[str, int] = {"qmoe": 0}
#: Launches one call makes (route, plan, gate|up, down, combine).
LAUNCHES_PER_CALL = 5
MAX_EXPERTS, MAX_TOP_K = 256, 32

_ARGTYPES = ([ctypes.c_void_p] * 15 + [ctypes.c_int] * 6 + [ctypes.c_float] * 11
             + [ctypes.c_void_p])


@dataclasses.dataclass(frozen=True)
class MoEScalars:
    top_k: int
    router_scale: float
    lut_scale: float
    p_scale: float
    gate: tuple  # (quant_scale, quant_shift)
    up: tuple
    down: tuple
    h_scale: float
    out_rescale: float


def prepare(router, gate, up, down):
    """The step's weights from the region's: router ``(D, E)``, gate and up
    ``(E, D, F)``, down ``(E, F, D)`` (int8 tensors) → ``(router (E, D),
    gate|up (E, 2F, D) interleaved by 8 rows, down (E, D, F))``."""
    e, d, f = gate.shape
    if f % 8:
        raise ValueError(f"the expert width {f} is not a multiple of 8")
    g = gate.transpose(1, 2).reshape(e, f // 8, 1, 8, d)
    u = up.transpose(1, 2).reshape(e, f // 8, 1, 8, d)
    gu = torch.cat([g, u], dim=2).reshape(e, 2 * f, d)
    return router.t().contiguous(), gu.contiguous(), down.transpose(1, 2).contiguous()


def split_gate_up(gu: torch.Tensor):
    """The gate and up ``(E, F, D)`` halves of the interleaved weight."""
    e, f2, d = gu.shape
    v = gu.reshape(e, f2 // 16, 2, 8, d)
    return v[:, :, 0].reshape(e, f2 // 2, d), v[:, :, 1].reshape(e, f2 // 2, d)


def _f32(v: float, device) -> torch.Tensor:
    return torch.tensor(v, dtype=torch.float32, device=device)


def _rescaled(acc: torch.Tensor, pair) -> torch.Tensor:
    f = acc.to(torch.float32) * _f32(pair[0], acc.device)
    return requantize(f * _f32(pair[1], acc.device), torch.int8)


def route_plain(x2: torch.Tensor, wr: torch.Tensor, lut: torch.Tensor, s: MoEScalars):
    """``(chosen (T, E) bool, pq (T, E) int32)``: the router's top-k by
    integer comparison and the int8 codes of their weights (0 elsewhere)."""
    acc = int_matmul(x2, wr.t())
    a = acc.to(torch.int64)
    e = a.shape[1]
    lower = torch.ones((e, e), dtype=torch.bool, device=a.device).tril(-1)  # [i, j]: j < i
    beats = (a[:, None, :] > a[:, :, None]) | ((a[:, None, :] == a[:, :, None]) & lower)
    chosen = beats.sum(dim=2) < s.top_k
    dev = x2.device
    f = (acc - acc.amax(dim=1, keepdim=True)).to(torch.float32) * _f32(s.router_scale, dev)
    idx = requantize(f / _f32(s.lut_scale, dev), torch.int8).to(torch.int64) + 128
    w = lut[idx].to(torch.int32) * chosen.to(torch.int32)
    p = w.to(torch.float32) / w.sum(dim=1, keepdim=True).to(torch.float32)
    return chosen, requantize(p * _f32(s.p_scale, dev), torch.int8).to(torch.int32)


def qmoe_plain(x, wr, gu, wd, lut, silu, s: MoEScalars) -> torch.Tensor:
    """The routed step in plain PyTorch (see the module docstring)."""
    d = x.shape[-1]
    x2 = x.reshape(-1, d)
    chosen, pq = route_plain(x2, wr, lut, s)
    gate, up = split_gate_up(gu)
    acc = torch.zeros(x2.shape, dtype=torch.int32, device=x.device)
    silu = silu.to(torch.int8)
    for e in range(wr.shape[0]):
        rows = chosen[:, e].nonzero()[:, 0]
        if rows.numel() == 0:
            continue
        xe = x2[rows]
        g = silu[_rescaled(int_matmul(xe, gate[e].t()), s.gate).to(torch.int64) + 128]
        u = _rescaled(int_matmul(xe, up[e].t()), s.up)
        hf = g.to(torch.float32) * u.to(torch.float32)
        h = requantize(hf * _f32(s.h_scale, x.device), torch.int8)
        y = _rescaled(int_matmul(h, wd[e].t()), s.down)
        acc[rows] += pq[rows, e:e + 1] * y.to(torch.int32)
    out = requantize(acc.to(torch.float32) * _f32(s.out_rescale, x.device), torch.int8)
    return out.reshape(x.shape)


def choose_bm(tokens: int, top_k: int, experts: int) -> int:
    """The row tile: 16 where an expert's mean rows are at most 16, else 64."""
    return 16 if tokens * top_k <= 16 * experts else 64


def qmoe(x, wr, gu, wd, lut, silu, s: MoEScalars) -> torch.Tensor:
    """The routed step: the CUDA kernels for CUDA tensors, the plain
    version for CPU ones."""
    if x.device.type != "cuda":
        return qmoe_plain(x, wr, gu, wd, lut, silu, s)
    e, d = wr.shape
    f = gu.shape[1] // 2
    k = s.top_k
    if d % 64 or f % 64 or not 1 <= k <= min(e, MAX_TOP_K) or e > MAX_EXPERTS:
        raise ValueError(f"qmoe takes D and F multiples of 64, E <= {MAX_EXPERTS} and "
                         f"k <= {MAX_TOP_K}: got D={d}, F={f}, E={e}, k={k}")
    x2 = x.reshape(-1, d).contiguous()
    t = x2.shape[0]
    out = torch.empty_like(x2)
    if t:
        dev = x.device
        i32 = dict(dtype=torch.int32, device=dev)
        top_e, top_q = torch.empty((t, k), **i32), torch.empty((t, k), dtype=torch.int8, device=dev)
        offs, tiles = torch.empty(e + 1, **i32), torch.empty(e + 1, **i32)
        order, slot_of = torch.empty(t * k, **i32), torch.empty(t * k, **i32)
        h = torch.empty((t * k, f), dtype=torch.int8, device=dev)
        y = torch.empty((t * k, d), dtype=torch.int8, device=dev)
        ptr = lambda a: ctypes.c_void_p(a.data_ptr())  # noqa: E731
        fn = _build.function("qmoe", "repro_qmoe", _ARGTYPES)
        rc = fn(ptr(x2), ptr(wr), ptr(gu), ptr(wd), ptr(lut), ptr(silu), ptr(out), ptr(top_e),
                ptr(top_q), ptr(offs), ptr(tiles), ptr(order), ptr(slot_of), ptr(h), ptr(y),
                t, d, f, e, k, choose_bm(t, k, e), s.router_scale, s.lut_scale, s.p_scale,
                *s.gate, *s.up, *s.down, s.h_scale, s.out_rescale,
                ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream))
        _build.check(rc, "qmoe")
        LAUNCHES["qmoe"] += LAUNCHES_PER_CALL
    return out.reshape(x.shape)
