"""The exact 256-entry int8 activation table (the paper's tanh/sigmoid
flows).  Only the plan-time table builder is ported so far; the TPU kernel
``repro/kernels/qact_lut.py::qact_lut`` has no CUDA counterpart yet, so a
graph that fuses a LUT step compiles only on the ``ref`` backend."""
from __future__ import annotations

import numpy as np


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
