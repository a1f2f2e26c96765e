"""Calibration observers — the quantizer-side half of the co-design contract.

The paper (§3) notes multiple ways to determine ``scale_X``: profiling the
maximum numerical range, or building profile histograms and saturating the
range before mapping.  Because the quantization process is *separated* from
the hardware compilation stage, the choice of observer is free — these are
three standard ones.  All produce a single symmetric ``absmax`` estimate that
:func:`repro.core.quant.choose_scale` maps onto the integer range.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from .quant import choose_scale, dequantize, quantize


class AbsMaxObserver:
    """Profile the maximum numerical range (paper's first suggested approach)."""

    def __init__(self) -> None:
        self.absmax = 0.0
        self.count = 0

    def observe(self, x: np.ndarray) -> None:
        if x.size:
            self.absmax = max(self.absmax, float(np.abs(x).max()))
            self.count += x.size

    def scale(self, dtype: str = "int8") -> float:
        return choose_scale(self.absmax, dtype)


class PercentileObserver:
    """Histogram-based range saturation (paper's second suggested approach).

    Keeps a fixed-width histogram of |x| and saturates the range at the given
    percentile before mapping onto the integer range.
    """

    def __init__(self, percentile: float = 99.99, bins: int = 2048) -> None:
        if not 0.0 < percentile <= 100.0:
            raise ValueError("percentile must be in (0, 100]")
        self.percentile = percentile
        self.bins = bins
        self._hist = np.zeros(bins, dtype=np.int64)
        self._width: Optional[float] = None

    def observe(self, x: np.ndarray) -> None:
        ax = np.abs(np.asarray(x, dtype=np.float32)).ravel()
        if not ax.size:
            return
        amax = float(ax.max())
        if self._width is None:
            self._width = max(amax, 1e-12) / self.bins
        if amax > self._width * self.bins:
            # Grow the histogram range by an integer factor, rebinning counts.
            factor = int(np.ceil(amax / (self._width * self.bins)))
            idx = np.arange(self.bins) // factor
            new_hist = np.zeros(self.bins, dtype=np.int64)
            np.add.at(new_hist, idx, self._hist)
            self._hist = new_hist
            self._width *= factor
        idx = np.minimum((ax / self._width).astype(np.int64), self.bins - 1)
        np.add.at(self._hist, idx, 1)

    def absmax(self) -> float:
        total = int(self._hist.sum())
        if total == 0 or self._width is None:
            return 0.0
        target = total * (self.percentile / 100.0)
        cum = np.cumsum(self._hist)
        bin_idx = int(np.searchsorted(cum, target))
        return float((bin_idx + 1) * self._width)

    def scale(self, dtype: str = "int8") -> float:
        return choose_scale(self.absmax(), dtype)


class MSEObserver:
    """Grid-search the saturation point that minimizes quantization MSE
    (the paper's "minimize the overall quantization error" approach)."""

    def __init__(self, num_candidates: int = 64, max_samples: int = 1 << 16) -> None:
        self.num_candidates = num_candidates
        self.max_samples = max_samples
        self._samples: list[np.ndarray] = []
        self._absmax = 0.0
        self._held = 0

    def observe(self, x: np.ndarray) -> None:
        x = np.asarray(x, dtype=np.float32).ravel()
        if not x.size:
            return
        self._absmax = max(self._absmax, float(np.abs(x).max()))
        if self._held < self.max_samples:
            take = min(x.size, self.max_samples - self._held)
            # Deterministic stride subsample to stay unbiased w.r.t. layout.
            stride = max(1, x.size // take)
            sub = x[::stride][:take]
            self._samples.append(sub)
            self._held += sub.size

    def absmax(self, dtype: str = "int8") -> float:
        if not self._samples or self._absmax == 0.0:
            return self._absmax
        data = np.concatenate(self._samples)
        best_amax, best_err = self._absmax, np.inf
        for frac in np.linspace(1.0 / self.num_candidates, 1.0, self.num_candidates):
            amax = self._absmax * float(frac)
            s = choose_scale(amax, dtype)
            err = float(np.mean((dequantize(quantize(data, s, dtype), s) - data) ** 2))
            if err < best_err:
                best_err, best_amax = err, amax
        return best_amax

    def scale(self, dtype: str = "int8") -> float:
        return choose_scale(self.absmax(dtype), dtype)


OBSERVERS = {
    "absmax": AbsMaxObserver,
    "percentile": PercentileObserver,
    "mse": MSEObserver,
}


@dataclasses.dataclass
class CalibrationResult:
    """Per-tensor activation scales keyed by tensor name."""

    scales: dict
    dtypes: dict

    def scale(self, name: str) -> float:
        return self.scales[name]


def make_observer(kind: str, **kwargs):
    try:
        return OBSERVERS[kind](**kwargs)
    except KeyError:
        raise ValueError(f"unknown observer kind {kind!r}; have {sorted(OBSERVERS)}") from None
