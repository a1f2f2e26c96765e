"""Fused int8 attention: the hand-written CUDA kernel
(``csrc/qattention.cu``), its plain PyTorch version, the cluster planner and
its launch counter.

Replaces ``repro/kernels/qattention.py::qattention``.  It computes the PQ-IR
attention region over a stacked batch of heads:

    int8 Q·Kᵀ → int32 → ×qk_scale → s·mask + (mask−1)·big → row max →
    clip(rint((masked − max) / lut_scale)) → uint8 exp-LUT → int32 den →
    p_q = clip(rint(w / den · p_scale)) → int8 P·V → ×rescale → rint → clip

on unpadded ``q (B, S, dh)``, ``k``/``v (B, T, dh)`` int8 and
``mask (B, S, T)`` f32.  The operands may be strided views — the per-head
slices of the qkv projection and of the KV cache — as long as each one's
last dim is contiguous and q, k and v sit on 4-byte boundaries
(:func:`accepts_view`); the mask may be broadcast over the batch (stride 0).
The kernel needs no padding at all, so neither does its plain version.

A query row's keys are split over a thread-block cluster of ``cluster``
blocks, each sized to the keys it holds (:func:`choose_cluster`,
:func:`threads_for`); the blocks combine their row max, integer den and
context exactly through distributed shared memory.  What bounds the kernel
on an H100 and what its design does about it is in the note at the top of
``csrc/qattention.cu``.  For CUDA tensors the wrapper launches the kernel or
raises; the plain version runs only for CPU tensors.
"""
from __future__ import annotations

import ctypes
import threading
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from . import _build
from . import ref as _ref

#: Kernel launches since the last reset.
LAUNCHES: Dict[str, int] = {"qattention": 0}

#: Legal cluster sizes (16 is beyond the portable 8 and is enabled per device).
CLUSTER_SIZES = (1, 2, 4, 8, 16)
#: The planner keeps at least this many keys in each block of a cluster.
MIN_KEYS = 4
#: Streaming multiprocessors of an H100: the planner aims for one block each.
NUM_SMS = 132
#: Warps in a block (the kernel's blocks have 128 to 512 threads).
MIN_WARPS, MAX_WARPS = 4, 16
#: Warps an SM holds at once, by the kernel's register cap: a lone block per
#: row keeps to 32 registers a thread (``__launch_bounds__(512, 4)``: 2048
#: threads an SM), a cluster's block to 64 (1024 threads).
WARPS_PER_SM = {"solo": 64, "cluster": 32}

#: Shared memory a block can use on Hopper, less 1 KB for the kernel's
#: static part (the LUT, reduction and exchange slots, the barriers).  The
#: dynamic part holds 4 bytes per key of the block, one partial context per
#: warp (4 bytes per head dim) and the context slots the cluster's blocks
#: store into (C · ceil(dh / C) of 4 bytes).
SMEM_BYTES = 232448 - 1024

_ARGTYPES = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 6 + [ctypes.c_float] * 5 + [
    ctypes.c_int, ctypes.c_void_p,
]
_MAX_CLUSTERS_ARGTYPES = [ctypes.c_int] * 4 + [ctypes.c_void_p]

#: cudaOccupancyMaxActiveClusters by (device, T-per-block, dh, cluster, threads).
_SCHEDULABLE: Dict[Tuple[int, int, int, int, int], int] = {}
_SCHEDULABLE_LOCK = threading.Lock()


def keys_per_block(t: int, cluster: int) -> int:
    """The most keys one block of the cluster holds."""
    return -(-int(t) // int(cluster))


def key_ranges(t: int, cluster: int) -> List[Tuple[int, int]]:
    """The ``[k0, k1)`` keys of each block rank, as the kernel computes them:
    rank r owns ``[r·T // C, (r+1)·T // C)``."""
    return [(r * t // cluster, (r + 1) * t // cluster) for r in range(cluster)]


def threads_for(rows: int, t: int, cluster: int) -> int:
    """Threads per block for ``rows`` query rows of ``t`` keys split over
    ``cluster`` blocks: a warp per two keys of the block — a decode row's
    latency falls with every warp that shares its loads — but no more than
    lets all ``rows × cluster`` blocks be resident at once (one wave), and
    between ``MIN_WARPS`` and ``MAX_WARPS`` warps."""
    blocks_per_sm = -(-int(rows) * int(cluster) // NUM_SMS)
    per_sm = WARPS_PER_SM["solo" if cluster == 1 else "cluster"]
    warps = min(MAX_WARPS, -(-keys_per_block(t, cluster) // 2), per_sm // blocks_per_sm)
    return 32 * max(MIN_WARPS, warps)


def max_keys(dh: int, cluster: int = 1) -> int:
    """Most keys a query row may attend at head width ``dh`` when its keys
    are split over ``cluster`` blocks: each block holds 4 bytes per key
    beside at most ``MAX_WARPS`` partial contexts and its context slots."""
    c = int(cluster)
    return c * (SMEM_BYTES // 4 - MAX_WARPS * int(dh) - c * -(-int(dh) // c))


def check_cluster(t: int, dh: int, cluster) -> int:
    """``cluster`` as an int if a row of ``t`` keys at width ``dh`` can be
    split over it, else ValueError: a size in :data:`CLUSTER_SIZES`, at most
    one block per key, and the row within the cluster's shared memory."""
    if isinstance(cluster, bool) or not isinstance(cluster, (int, np.integer)) \
            or int(cluster) not in CLUSTER_SIZES:
        raise ValueError(f"cluster={cluster!r}: must be one of {CLUSTER_SIZES}")
    c = int(cluster)
    if c > t:
        raise ValueError(f"cluster={c}: a row of T={t} keys gives each block at least one key "
                         f"only for cluster <= T")
    if t > max_keys(dh, c):
        raise ValueError(f"cluster={c}: T={t} keys exceed the {max_keys(dh, c)} that "
                         f"{c} block(s) hold at dh={dh}")
    return c


def choose_cluster(rows: int, t: int, dh: Optional[int] = None) -> int:
    """The cluster size for ``rows`` query rows (B·S) of ``t`` keys: the
    smallest that brings ``rows × C`` to about :data:`NUM_SMS` blocks, while
    each block keeps at least :data:`MIN_KEYS` keys — so 1 at prefill,
    where the rows alone fill the card.  Given ``dh``, C is also at least
    the smallest size whose shared memory holds the row."""
    legal = [c for c in CLUSTER_SIZES if c <= t and (dh is None or t <= max_keys(dh, c))]
    if not legal:
        raise ValueError(f"no cluster size holds a row of T={t} keys at dh={dh}")
    best = legal[0]
    for c in legal[1:]:
        if rows * best >= NUM_SMS or t < c * MIN_KEYS:
            break
        best = c
    return best


def accepts_view(x: torch.Tensor) -> bool:
    """Whether the kernel takes ``x`` as it is: a 3-D tensor whose last dim
    is contiguous, whose base and strides (over dims longer than 1) are
    multiples of 4 bytes, and whose row stride is below 2^31 elements.  The
    token path's per-head slices all are."""
    if x.dim() != 3:
        return False
    size, item = x.shape, x.element_size()
    if size[2] > 1 and x.stride(2) != 1:
        return False
    if x.data_ptr() % 4 or x.stride(1) >= 2 ** 31:
        return False
    return all(size[d] <= 1 or (x.stride(d) * item) % 4 == 0 for d in (0, 1))


def _strides(x: torch.Tensor) -> Tuple[int, int]:
    """Batch and row strides in elements; a dim of length 1 strides 0."""
    return tuple(x.stride(d) if x.shape[d] > 1 else 0 for d in (0, 1))


def qattention_plain(q_q, k_q, v_q, mask, lut, *, qk_scale: float, big: float,
                     lut_scale: float, p_scale: float, rescale: float,
                     out_dtype: torch.dtype = torch.int8) -> torch.Tensor:
    """The plain PyTorch version of :func:`qattention`: same operands
    (strided views included), same result ``(B, S, dh)``."""
    return _ref.qattention_ref(
        q_q, k_q, v_q, mask, qk_scale, big, lut_scale, lut, p_scale, rescale,
        out_dtype=out_dtype,
    )


def _schedulable(device: torch.device, t: int, dh: int, cluster: int, threads: int) -> None:
    """Raise unless the card can hold at least one cluster of this launch
    shape (asked once per shape of a device)."""
    key = (device.index or 0, keys_per_block(t, cluster), dh, cluster, threads)
    with _SCHEDULABLE_LOCK:
        n = _SCHEDULABLE.get(key)
        if n is None:
            fn = _build.function("qattention", "repro_qattention_max_clusters",
                                 _MAX_CLUSTERS_ARGTYPES)
            count = ctypes.c_int(0)
            with torch.cuda.device(device):
                _build.check(fn(t, dh, cluster, threads, ctypes.byref(count)),
                             "qattention occupancy query")
            n = _SCHEDULABLE[key] = count.value
    if n < 1:
        raise ValueError(f"qattention: a cluster of {cluster} blocks of {threads} threads "
                         f"at T={t}, dh={dh} cannot be scheduled on {device}")


def qattention(q_q, k_q, v_q, mask, lut, *, qk_scale: float, big: float,
               lut_scale: float, p_scale: float, rescale: float,
               out_dtype: torch.dtype = torch.int8,
               cluster: Optional[int] = None) -> torch.Tensor:
    """Fused int8 attention: the CUDA kernel on the card, the plain
    version on the CPU.  ``cluster`` is the number of blocks a query row's
    keys are split over (the plan's record carries it); None plans it with
    :func:`choose_cluster`.  Scalars are rounded to float32 once, here."""
    if q_q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"qattention: tensors must be on a CUDA device or the CPU, got {q_q.device}")
    b, s, dh = q_q.shape
    t = k_q.shape[1]
    if k_q.shape != (b, t, dh) or v_q.shape != (b, t, dh) or mask.shape != (b, s, t):
        raise ValueError(
            f"qattention: shapes q {tuple(q_q.shape)}, k {tuple(k_q.shape)}, "
            f"v {tuple(v_q.shape)}, mask {tuple(mask.shape)} do not agree"
        )
    if cluster is None:
        cluster = choose_cluster(b * s, t, dh)
    cluster = check_cluster(t, dh, cluster)
    if q_q.device.type == "cpu":
        return qattention_plain(
            q_q, k_q, v_q, mask, lut, qk_scale=qk_scale, big=big, lut_scale=lut_scale,
            p_scale=p_scale, rescale=rescale, out_dtype=out_dtype,
        )
    if (q_q.dtype, k_q.dtype, v_q.dtype, mask.dtype, lut.dtype) != (
        torch.int8, torch.int8, torch.int8, torch.float32, torch.uint8
    ) or lut.numel() != 256:
        raise ValueError("qattention: want int8 q/k/v, f32 mask and a (256,) uint8 lut")
    if out_dtype not in (torch.int8, torch.uint8):
        raise ValueError(f"qattention: out_dtype must be int8 or uint8, got {out_dtype}")
    if dh % 4:
        raise ValueError(f"qattention: needs dh % 4 == 0, got dh={dh}")
    if b > 65535 or s > 65535:
        raise ValueError(f"qattention: B and S must be <= 65535, got B={b}, S={s}")
    if any(x.device != q_q.device for x in (k_q, v_q, mask, lut)):
        raise ValueError("qattention: operands must be on one device")
    bad = [n for n, x in zip("qkvm", (q_q, k_q, v_q, mask)) if not accepts_view(x)]
    if bad:
        raise ValueError(
            f"qattention: operand(s) {bad} need a contiguous last dim and a base and "
            "strides on 4-byte boundaries"
        )
    if not lut.is_contiguous() or lut.data_ptr() % 4:
        raise ValueError("qattention: the lut must be contiguous and 4-byte aligned")
    threads = threads_for(b * s, t, cluster)
    _schedulable(q_q.device, t, dh, cluster, threads)
    out = torch.empty((b, s, dh), dtype=out_dtype, device=q_q.device)
    strides = (ctypes.c_longlong * 10)(*_strides(q_q), *_strides(k_q), *_strides(v_q),
                                       *_strides(mask), *_strides(out))
    fn = _build.function("qattention", "repro_qattention", _ARGTYPES)
    rc = fn(
        q_q.data_ptr(), k_q.data_ptr(), v_q.data_ptr(), mask.data_ptr(), lut.data_ptr(),
        out.data_ptr(), ctypes.cast(strides, ctypes.c_void_p), b, s, t, dh, cluster, threads,
        *(float(np.float32(c)) for c in (qk_scale, big, lut_scale, p_scale, rescale)),
        int(out_dtype == torch.uint8), torch.cuda.current_stream(q_q.device).cuda_stream,
    )
    _build.check(rc, "qattention")
    LAUNCHES["qattention"] += 1
    return out
