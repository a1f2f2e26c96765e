"""Hand-written CUDA kernels for the pre-quantized hot spots, with their
plain PyTorch versions.

qmatmul     — fused int8 / packed-int4 matmul + bias + §3.1 rescale + requant
qattention  — fused int8 attention region (scores, LUT softmax, context)
ops         — plan-time templates, per-bucket binding, the planned matmul call
ref         — plain PyTorch oracles (the ``ref`` backend)
pack        — int4 nibble packing
qact_lut    — the LUT builder (its kernel is not ported yet)
_build      — nvcc build + ctypes loading of ``csrc/*.cu``

Nothing here touches CUDA or ``nvcc`` at import time: a kernel builds at
its first launch.
"""
from typing import Dict

from . import ops, pack, qattention, qmatmul, ref  # noqa: F401


def launch_counts() -> Dict[str, int]:
    """Kernel launches since the last :func:`reset_launch_counts`, by name."""
    return {**qmatmul.LAUNCHES, **qattention.LAUNCHES}


def reset_launch_counts() -> None:
    for counts in (qmatmul.LAUNCHES, qattention.LAUNCHES):
        for name in counts:
            counts[name] = 0
