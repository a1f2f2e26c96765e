"""Unified metrics: one registry of counters / gauges / histograms for the
whole serving stack.

Before this module the system had three ad-hoc, differently-keyed dict
stores (the token engine's ``metrics``, the compiled-model server's
``metrics``/``summary()`` and the per-cache ``stats`` dicts).  They remain
as read-only *aliases*, but every number is now published through a
:class:`MetricsRegistry`:

* **Counter** — monotonically increasing int (``requests``, cache hits).
* **Gauge** — last-written value, or a *callback* gauge whose value is read
  live at snapshot time (cache sizes route through callbacks, so the
  registry never holds a stale copy).
* **Histogram** — log-bucketed distribution with exact count/sum/min/max
  and quantile estimates (p50/p95/p99 within the bucket growth factor).
  Memory is bounded by the number of occupied buckets (≈ ``log(max/min) /
  log(growth)``), never by the number of samples — a long-lived server
  records billions of latencies in a few hundred ints.

Canonical key scheme
====================

Dotted, lowercase: ``<subsystem>.<object>.<field>``.  The cache scheme the
three previously-divergent stores now share:

    cache.<scope>.size | capacity | hits | misses | evictions | hit_rate

with ``scope`` = ``plan`` (PlanCache specializations), ``prefill`` (token
engine's jitted-prefill cache), ...  Serving metrics live under
``serve.*`` (``serve.requests``, ``serve.latency_ms``), engine metrics
under ``engine.*``.

Exports: :meth:`MetricsRegistry.snapshot` (JSON-able dict, deterministic
key order) and :meth:`MetricsRegistry.to_prometheus` (text exposition
format, names sanitized to ``repro_``-prefixed underscores).

Stdlib-only; imports nothing from the rest of :mod:`repro`.
"""
from __future__ import annotations

import math
import threading
from typing import Any, Callable, Dict, List, Optional, Tuple

__all__ = [
    "Counter", "Gauge", "Histogram", "MetricsRegistry",
    "default_registry", "set_default_registry", "CACHE_STAT_FIELDS",
    "cache_key",
]

#: The canonical per-cache stat fields (mirrors ``LruCache.stats``).
CACHE_STAT_FIELDS = ("size", "capacity", "hits", "misses", "evictions", "hit_rate")


def cache_key(scope: str, field: str) -> str:
    """The canonical registry key for one cache stat: ``cache.<scope>.<field>``."""
    return f"cache.{scope}.{field}"


class Counter:
    """Monotonic counter.  ``inc`` is thread-safe."""

    __slots__ = ("_lock", "value")

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self.value = 0

    def inc(self, n: int = 1) -> None:
        with self._lock:
            self.value += n


class Gauge:
    """Last-written value; optionally backed by a live callback."""

    __slots__ = ("_lock", "_value", "_fn")

    def __init__(self, fn: Optional[Callable[[], float]] = None) -> None:
        self._lock = threading.Lock()
        self._value = 0.0
        self._fn = fn

    def set(self, v: float) -> None:
        if self._fn is not None:
            raise ValueError("cannot set() a callback gauge")
        with self._lock:
            self._value = v

    @property
    def value(self) -> float:
        if self._fn is not None:
            return self._fn()
        with self._lock:
            return self._value


class Histogram:
    """Log-bucketed distribution: bounded memory, quantiles within the
    bucket growth factor.

    Samples map to geometric buckets ``[lo * growth^i, lo * growth^(i+1))``;
    only *occupied* buckets are stored.  count/sum/min/max are exact;
    :meth:`quantile` returns the geometric midpoint of the bucket holding
    the requested rank, so its relative error is bounded by ``growth``
    (default 1.15 ⇒ ≤ ~7.5% either side — tighter than the bucket-to-bucket
    variance of any real latency measurement).  Values ≤ ``lo`` (including
    zero) land in a dedicated underflow bucket reported as ``lo``.
    """

    __slots__ = ("_lock", "growth", "lo", "_log_growth", "buckets",
                 "count", "total", "min", "max")

    def __init__(self, growth: float = 1.15, lo: float = 1e-6) -> None:
        if growth <= 1.0:
            raise ValueError(f"growth must be > 1, got {growth}")
        if lo <= 0.0:
            raise ValueError(f"lo must be > 0, got {lo}")
        self._lock = threading.Lock()
        self.growth = growth
        self.lo = lo
        self._log_growth = math.log(growth)
        self.buckets: Dict[int, int] = {}
        self.count = 0
        self.total = 0.0
        self.min = math.inf
        self.max = -math.inf

    def _index(self, v: float) -> int:
        if v <= self.lo:
            return -1  # underflow bucket
        return int(math.log(v / self.lo) / self._log_growth)

    def observe(self, v: float) -> None:
        v = float(v)
        i = self._index(v)
        with self._lock:
            self.buckets[i] = self.buckets.get(i, 0) + 1
            self.count += 1
            self.total += v
            if v < self.min:
                self.min = v
            if v > self.max:
                self.max = v

    def _bucket_value(self, i: int) -> float:
        if i < 0:
            return self.lo
        # geometric midpoint of [lo*g^i, lo*g^(i+1))
        return self.lo * self.growth ** (i + 0.5)

    def quantile(self, q: float) -> Optional[float]:
        """Value at quantile ``q`` ∈ [0, 1]; None when empty.  Exact at the
        extremes (min/max), bucket-midpoint in between."""
        if not 0.0 <= q <= 1.0:
            raise ValueError(f"quantile must be in [0, 1], got {q}")
        with self._lock:
            if self.count == 0:
                return None
            if q <= 0.0:
                return self.min
            if q >= 1.0:
                return self.max
            rank = q * (self.count - 1) + 1  # 1-based rank, linear in q
            seen = 0
            for i in sorted(self.buckets):
                seen += self.buckets[i]
                if seen >= rank:
                    return min(max(self._bucket_value(i), self.min), self.max)
            return self.max

    @property
    def avg(self) -> Optional[float]:
        return (self.total / self.count) if self.count else None

    def stats(self) -> Dict[str, Any]:
        with self._lock:
            count, total = self.count, self.total
        if count == 0:
            return {"count": 0, "sum": 0.0, "avg": None, "min": None,
                    "max": None, "p50": None, "p95": None, "p99": None}
        return {
            "count": count,
            "sum": total,
            "avg": total / count,
            "min": self.min,
            "max": self.max,
            "p50": self.quantile(0.5),
            "p95": self.quantile(0.95),
            "p99": self.quantile(0.99),
        }


class MetricsRegistry:
    """Get-or-create registry of named metrics with deterministic exports.

    One registry per serving component tree: the compiled-model server, the
    token engine and standalone compiled models each own one (injectable
    for sharing/aggregation), and every cache they hold registers its
    canonical ``cache.<scope>.*`` callbacks into it.  ``snapshot()`` and
    ``to_prometheus()`` iterate names sorted, so exports are byte-stable
    for identical state regardless of registration/publish order."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._metrics: Dict[str, Any] = {}

    def _get_or_create(self, name: str, cls, factory):
        with self._lock:
            m = self._metrics.get(name)
            if m is None:
                m = self._metrics[name] = factory()
            elif not isinstance(m, cls):
                raise TypeError(
                    f"metric {name!r} already registered as {type(m).__name__}, "
                    f"requested {cls.__name__}"
                )
            return m

    def counter(self, name: str) -> Counter:
        return self._get_or_create(name, Counter, Counter)

    def gauge(self, name: str) -> Gauge:
        return self._get_or_create(name, Gauge, Gauge)

    def callback_gauge(self, name: str, fn: Callable[[], float]) -> Gauge:
        """(Re-)register a live-read gauge.  Re-registration replaces the
        callback — the registry reflects the *current* instance of whatever
        object backs the name (e.g. the newest attached cache)."""
        with self._lock:
            g = Gauge(fn)
            self._metrics[name] = g
            return g

    def histogram(self, name: str, **kwargs: Any) -> Histogram:
        return self._get_or_create(name, Histogram, lambda: Histogram(**kwargs))

    def attach_cache(self, scope: str, cache: Any) -> None:
        """Register the canonical ``cache.<scope>.*`` callback gauges for an
        :class:`repro.core.cache.LruCache`-shaped object (anything with a
        ``stats`` dict property)."""
        for field in CACHE_STAT_FIELDS:
            self.callback_gauge(
                cache_key(scope, field),
                lambda c=cache, f=field: float(c.stats[f]),
            )

    def names(self) -> List[str]:
        with self._lock:
            return sorted(self._metrics)

    def get(self, name: str) -> Optional[Any]:
        with self._lock:
            return self._metrics.get(name)

    # -- exports ------------------------------------------------------------
    def snapshot(self) -> Dict[str, Any]:
        """JSON-able dict, keys sorted.  Counters → int, gauges → float,
        histograms → their stats dict."""
        out: Dict[str, Any] = {}
        for name in self.names():
            m = self.get(name)
            if isinstance(m, Counter):
                out[name] = m.value
            elif isinstance(m, Gauge):
                out[name] = m.value
            elif isinstance(m, Histogram):
                out[name] = m.stats()
        return out

    def to_prometheus(self) -> str:
        """Prometheus text exposition format (0.0.4).  Dotted names become
        ``repro_``-prefixed underscore names; histograms render as
        summaries with p50/p95/p99 quantiles."""
        lines: List[str] = []
        for name in self.names():
            m = self.get(name)
            pname = "repro_" + "".join(
                ch if (ch.isalnum() or ch == "_") else "_" for ch in name
            )
            if isinstance(m, Counter):
                lines.append(f"# TYPE {pname} counter")
                lines.append(f"{pname} {m.value}")
            elif isinstance(m, Gauge):
                lines.append(f"# TYPE {pname} gauge")
                lines.append(f"{pname} {_prom_num(m.value)}")
            elif isinstance(m, Histogram):
                s = m.stats()
                lines.append(f"# TYPE {pname} summary")
                for q, key in ((0.5, "p50"), (0.95, "p95"), (0.99, "p99")):
                    if s[key] is not None:
                        lines.append(f'{pname}{{quantile="{q}"}} {_prom_num(s[key])}')
                lines.append(f"{pname}_sum {_prom_num(s['sum'])}")
                lines.append(f"{pname}_count {s['count']}")
        return "\n".join(lines) + "\n"


def _prom_num(v: float) -> str:
    f = float(v)
    return repr(int(f)) if f == int(f) else repr(f)


_DEFAULT = MetricsRegistry()


def default_registry() -> MetricsRegistry:
    """The process-default registry: what components publish into when no
    explicit registry is injected, and what ``benchmarks/run.py --metrics``
    snapshots."""
    return _DEFAULT


def set_default_registry(reg: MetricsRegistry) -> MetricsRegistry:
    """Swap the process-default registry (tests use this for isolation).
    Returns the previous one."""
    global _DEFAULT
    prev, _DEFAULT = _DEFAULT, reg
    return prev
