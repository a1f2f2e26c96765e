"""Pre-quantized codes drawn on the device from a seed.

An artifact carries int8 (or int4-ranged) weight codes, int32 bias codes and
a rescale per layer or channel: a float32 multiplier ``m`` and its integer
codification ``(quant_scale, shift)`` with ``m ≈ quant_scale · 2**-shift``
and ``quant_scale < 2**24`` (exact as a float32). The configurations draw
the codes here, in a few large calls on the device, and derive ``m`` from
the code ranges so that activations keep a stated spread.
"""
from __future__ import annotations

import math
from typing import Tuple

import numpy as np


def derived_seeds(seed: int, n: int):
    """``n`` independent 63-bit seeds for ``torch.Generator.manual_seed``."""
    state = np.random.SeedSequence(int(seed)).generate_state(n, np.uint64)
    return [int(s) >> 1 for s in state]


def generator(seed: int, device):
    import torch

    g = torch.Generator(device=device)
    g.manual_seed(int(seed))
    return g


def uniform_codes(g, lo: int, hi: int, shape, dtype, device):
    """Integer codes uniform over ``[lo, hi]`` (both ends included)."""
    import torch

    return torch.randint(lo, hi + 1, tuple(shape), generator=g, dtype=dtype, device=device)


def code_std(lo: int, hi: int) -> float:
    """The standard deviation of codes uniform over ``[lo, hi]``."""
    n = hi - lo + 1
    return math.sqrt((n * n - 1) / 12.0)


def rescale_pair(m: float) -> Tuple[int, int]:
    """``(quant_scale, shift)`` of a positive multiplier: the largest shift
    that keeps ``quant_scale = floor(m · 2**shift)`` below ``2**24``."""
    if not m > 0.0:
        raise ValueError(f"multiplier {m} must be positive")
    _, e = math.frexp(m)  # m = f · 2**e, 0.5 <= f < 1
    shift = 24 - e
    return int(math.floor(m * 2.0 ** shift)), shift
