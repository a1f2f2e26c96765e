"""The card's published peaks and the roofline and mfu formulas.

NVIDIA H100 SXM data sheet, dense rates without sparsity, at the 700 W
limit: 1,979 TOP/s int8 on the tensor cores and 3.35 TB/s of HBM3. A share
is stated against these peaks; the card's power limit is printed beside it.
"""
from __future__ import annotations

from typing import Optional

INT8_OPS_PER_S = 1979e12
HBM_BYTES_PER_S = 3.35e12


def bound_s(ops: float, nbytes: float) -> float:
    """The least time the card could take for ``ops`` int8 operations and
    ``nbytes`` moved: the larger of the two terms."""
    return max(ops / INT8_OPS_PER_S, nbytes / HBM_BYTES_PER_S)


def roofline_pct(bound_total_s: float, kernel_s: float) -> Optional[float]:
    """A kernel's share of its roofline over a window: the sum of its
    launches' bounds over the sum of their measured device times, in %.
    None when nothing was measured."""
    if kernel_s <= 0.0 or bound_total_s <= 0.0:
        return None
    return 100.0 * bound_total_s / kernel_s


def mfu_pct(ops: float, window_s: float) -> Optional[float]:
    """The int8 operations the window's work needs over what the card's peak
    could do in the window, in %."""
    if window_s <= 0.0 or ops <= 0.0:
        return None
    return 100.0 * ops / (window_s * INT8_OPS_PER_S)
