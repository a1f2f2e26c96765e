"""Small bounded LRU cache shared by the serving layers and the plan cache.

Both per-shape caches in the system — the serving engine's prefill-function
cache (keyed by prompt bucket) and the backend's :class:`~repro.backend.plan.
PlanCache` (keyed by sorted per-axis bucket bindings) — used to be plain
dicts that grew without bound under adversarial/long-tail traffic.  This is
the one eviction policy they share: least-recently-used, with
hit/miss/eviction counters and the single :attr:`LruCache.hit_rate`
accounting site, so every cache surfaces the same numbers in serving
metrics.
"""
from __future__ import annotations

import json
import os
import tempfile
from collections import OrderedDict
from typing import Any, Dict, Hashable, Optional

from ..obs import trace as _trace
from ..obs.metrics import MetricsRegistry


class LruCache:
    """Bounded mapping with least-recently-used eviction.

    ``get`` refreshes recency and counts a hit/miss; ``put`` inserts (or
    refreshes) and evicts the oldest entries beyond ``capacity``.  ``in`` /
    ``len`` are pure reads — they never touch recency or the counters.

    ``scope`` names the cache on the observability plane (``"plan"``,
    ``"prefill"``, ...): a scoped cache emits ``cache.<scope>.hit`` /
    ``.miss`` / ``.evict`` instant events when a tracer is installed, and
    :meth:`attach_metrics` registers the canonical ``cache.<scope>.<field>``
    gauges in a :class:`~repro.obs.metrics.MetricsRegistry`.  Unscoped
    caches never touch the obs plane.
    """

    def __init__(self, capacity: int = 8, *, scope: Optional[str] = None) -> None:
        if capacity < 1:
            raise ValueError(f"LruCache capacity must be >= 1, got {capacity}")
        self.capacity = capacity
        self.scope = scope
        self._entries: "OrderedDict[Hashable, Any]" = OrderedDict()
        self.hits = 0
        self.misses = 0
        self.evictions = 0

    def get(self, key: Hashable, default: Any = None) -> Any:
        if key in self._entries:
            self.hits += 1
            if _trace.enabled and self.scope:
                _trace.event(f"cache.{self.scope}.hit", key=str(key))
            self._entries.move_to_end(key)
            return self._entries[key]
        self.misses += 1
        if _trace.enabled and self.scope:
            _trace.event(f"cache.{self.scope}.miss", key=str(key))
        return default

    def peek(self, key: Hashable, default: Any = None) -> Any:
        """Read an entry without touching hit/miss counters, recency order or
        the obs plane — for introspection (e.g. serializing the resident
        entries into an AOT artifact), never for the serving path."""
        return self._entries.get(key, default)

    def put(self, key: Hashable, value: Any) -> None:
        if key in self._entries:
            self._entries.move_to_end(key)
        self._entries[key] = value
        while len(self._entries) > self.capacity:
            evicted, _ = self._entries.popitem(last=False)
            self.evictions += 1
            if _trace.enabled and self.scope:
                _trace.event(f"cache.{self.scope}.evict", key=str(evicted))

    def attach_metrics(self, registry: MetricsRegistry, scope: Optional[str] = None) -> None:
        """Publish this cache's stats into ``registry`` under the canonical
        ``cache.<scope>.<field>`` keys (live callback gauges — snapshots
        always read the current counters, never a stale copy)."""
        scope = scope or self.scope
        if not scope:
            raise ValueError("attach_metrics needs a cache scope name")
        registry.attach_cache(scope, self)

    def __len__(self) -> int:
        return len(self._entries)

    def __contains__(self, key: Hashable) -> bool:
        return key in self._entries

    def keys(self):
        """Keys from least- to most-recently used (pure read)."""
        return list(self._entries.keys())

    @property
    def hit_rate(self) -> float:
        """hits / (hits + misses), 0.0 before any lookup.  This is the one
        place hit accounting turns into a rate — every cache consumer
        (CompiledModel.cache_stats, the serving engine's prefill metrics,
        the compiled-model server summary) surfaces this same number."""
        looked = self.hits + self.misses
        return (self.hits / looked) if looked else 0.0

    @property
    def stats(self) -> Dict[str, Any]:
        return {
            "size": len(self._entries),
            "capacity": self.capacity,
            "hits": self.hits,
            "misses": self.misses,
            "evictions": self.evictions,
            "hit_rate": self.hit_rate,
        }

    def __repr__(self) -> str:
        s = self.stats
        return (
            f"{type(self).__name__}(size={s['size']}/{s['capacity']}, "
            f"hits={s['hits']}, misses={s['misses']}, evictions={s['evictions']})"
        )


class PersistentJsonStore:
    """A string-keyed dict persisted as one schema-tagged JSON file.

    The on-disk co-design artifacts (the autotune tile cache, and anything
    shaped like it) share three requirements this class owns:

    * **diffable** — keys are written sorted with stable indentation, so two
      runs producing the same state produce byte-identical files and a tuned
      entry shows up as a clean one-hunk diff in review;
    * **atomic** — :meth:`save` writes to a temp file in the target directory
      and ``os.replace``\\ s it over the destination, so a crash mid-write can
      never leave a truncated artifact for the next process to warm-start
      from;
    * **schema-checked** — the file carries ``{"schema": ..., "entries":
      {...}}``; loading a file with a different schema tag raises instead of
      silently misreading a foreign format.

    A missing file is an empty store (the cold-start case).  ``put`` saves
    immediately — entries are few and each one cost real measurement time,
    so losing them to a crash would be the expensive failure mode.
    """

    def __init__(self, path: str, *, schema: str) -> None:
        self.path = str(path)
        self.schema = schema
        self.entries: Dict[str, Any] = {}
        self.load()

    def load(self) -> None:
        """(Re-)read the file; a missing file leaves the store empty."""
        if not os.path.exists(self.path):
            return
        with open(self.path) as f:
            data = json.load(f)
        got = data.get("schema")
        if got != self.schema:
            raise ValueError(
                f"{self.path}: schema {got!r} does not match expected {self.schema!r}"
            )
        entries = data.get("entries", {})
        if not isinstance(entries, dict):
            raise ValueError(f"{self.path}: 'entries' must be an object")
        self.entries = entries

    def save(self) -> None:
        """Atomic write: temp file in the destination directory + rename."""
        payload = {"schema": self.schema, "entries": self.entries}
        d = os.path.dirname(os.path.abspath(self.path))
        fd, tmp = tempfile.mkstemp(prefix=".store-", suffix=".json", dir=d)
        try:
            with os.fdopen(fd, "w") as f:
                json.dump(payload, f, indent=1, sort_keys=True)
                f.write("\n")
            os.replace(tmp, self.path)
        except BaseException:
            if os.path.exists(tmp):
                os.unlink(tmp)
            raise

    def get(self, key: str, default: Any = None) -> Any:
        return self.entries.get(str(key), default)

    def put(self, key: str, value: Any) -> None:
        self.entries[str(key)] = value
        self.save()

    def __len__(self) -> int:
        return len(self.entries)

    def __contains__(self, key: str) -> bool:
        return str(key) in self.entries
