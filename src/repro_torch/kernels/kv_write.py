"""The decode step's KV update written in place: the hand-written CUDA
kernel (``csrc/kv_write.cu``), its plain PyTorch version and the launch
counter.

The token path codifies the update of each cache ``S (N, R, W)`` with the
new rows ``X (N, 1, W)`` at the onehot ``H (N, R, 1)`` as
``Add(Mul(S, Sub(1, H)), Mul(X, H))``, all int8.  A row whose ``h`` is 0
comes out as ``S·1 + X·0 = S`` bit for bit, so the update only has to write
the rows whose ``h`` is non-zero, each as ``S·(1−h) + X·h`` with the same
int8 wrap-around; that holds for any int8 ``H``, not just a onehot.

:func:`kv_write` and :func:`kv_write_plain` write into ``s`` and return it:
the plan passes the state's own buffer where its executor owns it, and a
copy otherwise (``backend/fused.py``).  For CUDA tensors :func:`kv_write`
launches the kernel (one launch, counted under ``kv_write`` in
:data:`LAUNCHES`) or raises, also for rows whose width, stride or base is
not a multiple of 16 bytes (every cache the port builds is aligned so:
``W`` is KV heads × head_dim); for CPU tensors it runs the plain version.
"""
from __future__ import annotations

import ctypes
from typing import Dict

import torch

from . import _build

#: Kernel launches since the last reset.
LAUNCHES: Dict[str, int] = {"kv_write": 0}

_ARGTYPES = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3 + [ctypes.c_longlong, ctypes.c_void_p]


def _check(s: torch.Tensor, h: torch.Tensor, x: torch.Tensor) -> None:
    n, r, w = s.shape
    if s.dtype != torch.int8 or h.dtype != torch.int8 or x.dtype != torch.int8:
        raise ValueError(f"kv_write takes int8 operands, got {s.dtype}, {h.dtype}, {x.dtype}")
    if tuple(h.shape) != (n, r, 1) or tuple(x.shape) != (n, 1, w):
        raise ValueError(f"kv_write: cache {tuple(s.shape)} takes a onehot {(n, r, 1)} and rows "
                         f"{(n, 1, w)}, got {tuple(h.shape)} and {tuple(x.shape)}")


def kv_write_plain(s: torch.Tensor, h: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """The plain PyTorch version of :func:`kv_write`: the codified int8
    ops, on the rows whose onehot is non-zero only."""
    _check(s, h, x)
    n, r = h[..., 0].nonzero(as_tuple=True)
    if n.numel():
        hv = h[n, r]
        s[n, r] = s[n, r] * (1 - hv) + x[n, 0] * hv
    return s


def kv_write(s: torch.Tensor, h: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Write the update into ``s`` (module docstring) and return it: the
    kernel for CUDA tensors, the plain version for CPU ones."""
    if s.device.type != "cuda":
        return kv_write_plain(s, h, x)
    _check(s, h, x)
    if not s.is_contiguous():
        raise ValueError("kv_write writes into a contiguous cache")
    if x.stride(2) != 1:
        x = x.contiguous()
    n, r, w = s.shape
    if w % 16 or x.stride(0) % 16 or s.data_ptr() % 16 or x.data_ptr() % 16:
        raise ValueError(f"kv_write takes rows of 16-byte multiples on 16-byte bases, got W={w}, "
                         f"row stride {x.stride(0)}, cache base {s.data_ptr() % 16} and row base "
                         f"{x.data_ptr() % 16} bytes off 16")
    h = h.contiguous()
    fn = _build.function("kv_write", "repro_kv_write", _ARGTYPES)
    rc = fn(ctypes.c_void_p(s.data_ptr()), ctypes.c_void_p(h.data_ptr()),
            ctypes.c_void_p(x.data_ptr()), n, r, w, x.stride(0),
            ctypes.c_void_p(torch.cuda.current_stream(s.device).cuda_stream))
    _build.check(rc, "kv_write")
    LAUNCHES["kv_write"] += 1
    return s
