"""Hand-written CUDA kernels for the pre-quantized hot spots, with their
plain PyTorch versions.

qmatmul     — fused int8 / packed-int4 matmul + bias + §3.1 rescale + requant
              [+ an activation table in the epilogue]
qattention  — fused int8 attention region (scores, LUT softmax, context)
qmoe        — the routed-expert step (router, top-k, SwiGLU experts, combine)
qact_lut    — the exact 256-entry activation table: builder and the gather
              kernel for tables the plan does not fold into a matmul
ops         — plan-time templates, per-bucket binding, the planned matmul,
              activation and (im2col) conv calls
ref         — plain PyTorch oracles (the ``ref`` backend)
pack        — int4 nibble packing
_build      — nvcc build + ctypes loading of ``csrc/*.cu``

Nothing here touches CUDA or ``nvcc`` at import time: a kernel builds at
its first launch.
"""
from typing import Dict

from . import ops, pack, qact_lut, qattention, qmatmul, qmoe, ref  # noqa: F401


_COUNTERS = (qmatmul.LAUNCHES, qattention.LAUNCHES, qact_lut.LAUNCHES, qmoe.LAUNCHES)


def launch_counts() -> Dict[str, int]:
    """Kernel launches since the last :func:`reset_launch_counts`, by name."""
    return {**qmatmul.LAUNCHES, **qattention.LAUNCHES, **qact_lut.LAUNCHES, **qmoe.LAUNCHES}


def add_launch_counts(counts: Dict[str, int]) -> None:
    """Add ``counts`` (by name; negative to take back) to the counters: the
    launches a replayed CUDA graph makes without passing through a wrapper."""
    for counters in _COUNTERS:
        for name in counters:
            counters[name] += counts.get(name, 0)


def reset_launch_counts() -> None:
    for counts in _COUNTERS:
        for name in counts:
            counts[name] = 0
