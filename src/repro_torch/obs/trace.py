"""Tracing: thread-safe nested spans over the whole lowering/serving stack.

One :class:`Tracer` records **spans** (named wall-time intervals with
structured attributes, nesting per thread), **instant events** (cache
hits/misses, evictions) and **async spans** (request lifecycles that begin
and end in different call stacks, linked by an id).  The recorded timeline
exports two ways:

* :meth:`Tracer.to_chrome_trace` — the Chrome ``chrome://tracing`` /
  Perfetto JSON object format (``{"traceEvents": [...]}``, ``ph`` = "X"
  complete spans, "i" instants, "b"/"e" async pairs, timestamps in
  microseconds on a single monotonic clock), loadable as-is.
* :meth:`Tracer.render_tree` — a human-readable nested tree with durations
  and attributes, for terminals and bug reports.

Install/uninstall discipline
============================

Nothing in the stack holds a tracer; instrumentation sites call the
module-level :func:`span` / :func:`event` helpers, which consult the one
installed tracer (:func:`install` / :func:`uninstall`).  With **no tracer
installed** the helpers return a shared no-op context manager — one global
read and no allocation — and the hottest sites additionally guard on the
module flag :data:`enabled`, so the uninstrumented hot path stays at parity
(the ``sys_plan_overhead`` benchmark row pins this).

This module is intentionally dependency-free (stdlib only) and imports
nothing from the rest of :mod:`repro`.
"""
from __future__ import annotations

import dataclasses
import itertools
import json
import threading
import time
from typing import Any, Dict, List, Optional

#: True iff a tracer is installed.  Hot paths guard on this before building
#: span attribute dicts; everything else just calls :func:`span`.
enabled: bool = False

_TRACER: Optional["Tracer"] = None
_INSTALL_LOCK = threading.Lock()
_IDS = itertools.count(1)


@dataclasses.dataclass
class SpanRecord:
    """One finished timeline entry.

    kind   "span" (complete interval) | "instant" | "async_b" | "async_e"
    ts     start offset from the tracer epoch, seconds (monotonic clock)
    dur    duration in seconds (0.0 for instants and async endpoints)
    depth  nesting depth within its thread at record time (spans only)
    aid    async-link id ("async_b"/"async_e" only) — entries sharing an aid
           form one logical flow (e.g. one serving request)
    """

    name: str
    ts: float
    dur: float
    tid: int
    depth: int = 0
    attrs: Dict[str, Any] = dataclasses.field(default_factory=dict)
    kind: str = "span"
    aid: Optional[int] = None


class _ActiveSpan:
    """Context manager for one open span; finishing records it."""

    __slots__ = ("tracer", "name", "attrs", "t0")

    def __init__(self, tracer: "Tracer", name: str, attrs: Dict[str, Any]):
        self.tracer = tracer
        self.name = name
        self.attrs = attrs
        self.t0 = 0.0

    def set(self, **attrs: Any) -> "_ActiveSpan":
        """Attach attributes discovered mid-span (e.g. chosen tiles)."""
        self.attrs.update(attrs)
        return self

    def __enter__(self) -> "_ActiveSpan":
        self.t0 = time.perf_counter()
        self.tracer._enter(self)
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        if exc_type is not None:
            self.attrs.setdefault("error", exc_type.__name__)
        self.tracer._exit(self, time.perf_counter())
        return False


class _NullSpan:
    """Shared do-nothing span: what instrumentation sites get when no tracer
    is installed.  A singleton — entering it allocates nothing."""

    __slots__ = ()

    def set(self, **attrs: Any) -> "_NullSpan":
        return self

    def __enter__(self) -> "_NullSpan":
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        return False


NULL_SPAN = _NullSpan()


class Tracer:
    """Thread-safe span recorder with a single monotonic epoch.

    Per-thread nesting is tracked in a ``threading.local`` stack; finished
    records append to one list under a lock (recording is the only
    synchronized operation, and it is O(1))."""

    def __init__(self, trace_id: Optional[str] = None) -> None:
        self.trace_id = trace_id or f"trace-{next(_IDS)}-{int(time.time())}"
        self.epoch = time.perf_counter()
        self._lock = threading.Lock()
        self._records: List[SpanRecord] = []
        self._local = threading.local()
        self._tids: Dict[int, int] = {}  # thread ident -> small stable tid

    # -- recording ----------------------------------------------------------
    def span(self, name: str, **attrs: Any) -> _ActiveSpan:
        return _ActiveSpan(self, name, attrs)

    def event(self, name: str, **attrs: Any) -> None:
        """Record an instant event (cache hit/miss/evict, rejection, ...)."""
        now = time.perf_counter()
        with self._lock:
            self._records.append(
                SpanRecord(
                    name=name, ts=now - self.epoch, dur=0.0,
                    tid=self._tid(), depth=self._depth(), attrs=attrs,
                    kind="instant",
                )
            )

    def async_begin(self, name: str, aid: int, **attrs: Any) -> None:
        """Open an async span (ends in a different call stack / thread) —
        e.g. one serving request from submit to completion, ``aid`` = its
        request id."""
        now = time.perf_counter()
        with self._lock:
            self._records.append(
                SpanRecord(
                    name=name, ts=now - self.epoch, dur=0.0, tid=self._tid(),
                    attrs=attrs, kind="async_b", aid=aid,
                )
            )

    def async_end(self, name: str, aid: int, **attrs: Any) -> None:
        now = time.perf_counter()
        with self._lock:
            self._records.append(
                SpanRecord(
                    name=name, ts=now - self.epoch, dur=0.0, tid=self._tid(),
                    attrs=attrs, kind="async_e", aid=aid,
                )
            )

    def _stack(self) -> List[_ActiveSpan]:
        st = getattr(self._local, "stack", None)
        if st is None:
            st = self._local.stack = []
        return st

    def _depth(self) -> int:
        return len(self._stack())

    def _tid(self) -> int:
        ident = threading.get_ident()
        tid = self._tids.get(ident)
        if tid is None:
            tid = self._tids[ident] = len(self._tids)
        return tid

    def _enter(self, span: _ActiveSpan) -> None:
        self._stack().append(span)

    def _exit(self, span: _ActiveSpan, t1: float) -> None:
        stack = self._stack()
        # tolerate exit-out-of-order (a leaked span) rather than corrupting
        # the whole stack: pop through the matching entry
        while stack:
            top = stack.pop()
            if top is span:
                break
        with self._lock:
            self._records.append(
                SpanRecord(
                    name=span.name, ts=span.t0 - self.epoch,
                    dur=t1 - span.t0, tid=self._tid(), depth=len(stack),
                    attrs=span.attrs, kind="span",
                )
            )

    # -- reading ------------------------------------------------------------
    @property
    def records(self) -> List[SpanRecord]:
        """Snapshot of everything recorded so far (copy, sorted by start)."""
        with self._lock:
            recs = list(self._records)
        return sorted(recs, key=lambda r: (r.ts, -r.depth))

    def spans(self, name: Optional[str] = None) -> List[SpanRecord]:
        """Finished complete spans, optionally filtered by exact name."""
        return [
            r for r in self.records
            if r.kind == "span" and (name is None or r.name == name)
        ]

    def events(self, name: Optional[str] = None) -> List[SpanRecord]:
        return [
            r for r in self.records
            if r.kind == "instant" and (name is None or r.name == name)
        ]

    # -- export -------------------------------------------------------------
    def to_chrome_trace(self) -> Dict[str, Any]:
        """The Chrome-trace / Perfetto JSON object format.  Timestamps are
        microseconds from the tracer epoch on one monotonic clock, so the
        file loads with correct relative timing anywhere."""
        ph = {"span": "X", "instant": "i", "async_b": "b", "async_e": "e"}
        events: List[Dict[str, Any]] = [
            {
                "name": "process_name", "ph": "M", "pid": 0, "tid": 0,
                "args": {"name": f"repro.obs {self.trace_id}"},
            }
        ]
        for r in self.records:
            ev: Dict[str, Any] = {
                "name": r.name,
                "cat": r.name.split(".", 1)[0],
                "ph": ph[r.kind],
                "ts": round(r.ts * 1e6, 3),
                "pid": 0,
                "tid": r.tid,
                "args": _jsonable(r.attrs),
            }
            if r.kind == "span":
                ev["dur"] = round(r.dur * 1e6, 3)
            if r.aid is not None:
                ev["id"] = r.aid
                ev["s"] = "t"  # instant scope is ignored for b/e; harmless
            events.append(ev)
        return {"traceEvents": events, "displayTimeUnit": "ms", "otherData": {"trace_id": self.trace_id}}

    def dump(self, path: str) -> None:
        """Write the Chrome-trace JSON to ``path``."""
        with open(path, "w") as f:
            json.dump(self.to_chrome_trace(), f, indent=1)
            f.write("\n")

    def render_tree(self) -> str:
        """Human-readable per-thread span tree with durations and attrs."""
        lines: List[str] = [f"trace {self.trace_id}"]
        recs = self.records
        tids = sorted({r.tid for r in recs})
        for tid in tids:
            if len(tids) > 1:
                lines.append(f"thread {tid}:")
            for r in recs:
                if r.tid != tid:
                    continue
                pad = "  " * (r.depth + 1)
                attrs = ", ".join(f"{k}={_fmt(v)}" for k, v in r.attrs.items())
                attrs = f"  [{attrs}]" if attrs else ""
                if r.kind == "span":
                    lines.append(f"{pad}{r.name}  {r.dur * 1e3:.3f} ms{attrs}")
                elif r.kind == "instant":
                    lines.append(f"{pad}* {r.name}{attrs}")
                else:
                    arrow = "=>" if r.kind == "async_b" else "<="
                    lines.append(f"{pad}{arrow} {r.name}#{r.aid}{attrs}")
        return "\n".join(lines)


def _fmt(v: Any) -> str:
    if isinstance(v, float):
        return f"{v:.4g}"
    return str(v)


def _jsonable(obj: Any) -> Any:
    """Best-effort conversion of span attrs to JSON-clean values (numpy
    scalars/arrays stringify via their repr-ish forms)."""
    if isinstance(obj, dict):
        return {str(k): _jsonable(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_jsonable(v) for v in obj]
    if isinstance(obj, (str, int, float, bool)) or obj is None:
        return obj
    item = getattr(obj, "item", None)
    if callable(item):
        try:
            return _jsonable(item())
        except (TypeError, ValueError):
            pass
    return str(obj)


# ---------------------------------------------------------------------------
# module-level install discipline + no-op-cheap helpers
# ---------------------------------------------------------------------------


def install(tracer: Optional[Tracer] = None) -> Tracer:
    """Install ``tracer`` (or a fresh one) as *the* process tracer and flip
    :data:`enabled`.  Returns the installed tracer."""
    global _TRACER, enabled
    with _INSTALL_LOCK:
        _TRACER = tracer if tracer is not None else Tracer()
        enabled = True
        return _TRACER


def uninstall() -> Optional[Tracer]:
    """Remove the installed tracer (returning it) and flip :data:`enabled`
    off — instrumentation sites go back to the shared no-op span."""
    global _TRACER, enabled
    with _INSTALL_LOCK:
        t, _TRACER, enabled = _TRACER, None, False
        return t


def current() -> Optional[Tracer]:
    return _TRACER


def span(name: str, **attrs: Any):
    """The instrumentation-site entry point: a real span when a tracer is
    installed, the shared :data:`NULL_SPAN` otherwise."""
    t = _TRACER
    if t is None:
        return NULL_SPAN
    return t.span(name, **attrs)


def event(name: str, **attrs: Any) -> None:
    t = _TRACER
    if t is not None:
        t.event(name, **attrs)


def async_begin(name: str, aid: int, **attrs: Any) -> None:
    t = _TRACER
    if t is not None:
        t.async_begin(name, aid, **attrs)


def async_end(name: str, aid: int, **attrs: Any) -> None:
    t = _TRACER
    if t is not None:
        t.async_end(name, aid, **attrs)
