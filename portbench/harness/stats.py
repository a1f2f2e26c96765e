"""Percentiles over all samples, window rates and run-to-run spreads."""
from __future__ import annotations

import math
import statistics
from typing import Sequence


def percentile(values: Sequence[float], q: float) -> float:
    """The ``q``-th percentile (0 to 100) of every value, by linear
    interpolation between the two closest ranks (numpy's default method):
    rank ``(n - 1) * q / 100`` of the sorted values."""
    xs = sorted(float(v) for v in values)
    if not xs:
        raise ValueError("percentile of no values")
    if not 0.0 <= q <= 100.0:
        raise ValueError(f"percentile q={q} outside [0, 100]")
    pos = (len(xs) - 1) * q / 100.0
    lo, hi = math.floor(pos), math.ceil(pos)
    return xs[lo] + (xs[hi] - xs[lo]) * (pos - lo)


def median(values: Sequence[float]) -> float:
    return percentile(values, 50.0)


def rate(count: float, seconds: float) -> float:
    """Work per second over a window of ``seconds``."""
    if seconds <= 0.0:
        raise ValueError(f"a rate over a window of {seconds} s")
    return float(count) / float(seconds)


def spread(values: Sequence[float]) -> float:
    """The distance between the first and the third quartile as a share of
    the median, with the quartiles of ``statistics.quantiles(values, n=4)``
    (the benchmark's rule for setting a bound)."""
    q1, _, q3 = statistics.quantiles([float(v) for v in values], n=4)
    return (q3 - q1) / statistics.median(values)
