"""repro.obs — the observability plane: tracing, unified metrics, plan
provenance.

Three zero-dependency pieces, threaded through every stage of the stack
(pass pipeline → fusion → lowering → specialization → plan cache → kernel
dispatch → serving):

* :mod:`repro.obs.trace` — a thread-safe :class:`Tracer` of nested spans
  with structured attributes, exportable as Chrome-trace/Perfetto JSON and
  a human-readable tree.  Install one (:func:`install`) and the whole
  stack lights up; with none installed every site costs one global read.
* :mod:`repro.obs.metrics` — a :class:`MetricsRegistry` of counters,
  gauges and bounded log-bucketed histograms with the canonical
  ``cache.<scope>.<field>`` / ``serve.*`` / ``engine.*`` key scheme, JSON
  snapshots and Prometheus text export.
* :mod:`repro.obs.provenance` — the :class:`PlanProvenance` record an
  :class:`~repro.backend.plan.ExecutionPlan` carries so the co-design
  artifact explains itself (``plan.pretty(verbose=True)``).

The package imports nothing from the rest of :mod:`repro` (the rest of
:mod:`repro` imports *it*), so it can never create a dependency cycle and
is importable in any stripped-down context.
"""
from . import metrics, provenance, trace  # noqa: F401
from .metrics import (  # noqa: F401
    Counter,
    Gauge,
    Histogram,
    MetricsRegistry,
    default_registry,
)
from .provenance import (  # noqa: F401
    FusionRecord,
    PassEntry,
    PlanProvenance,
    SpecializationEvent,
)
from .trace import (  # noqa: F401
    NULL_SPAN,
    SpanRecord,
    Tracer,
    async_begin,
    async_end,
    current,
    event,
    install,
    span,
    uninstall,
)


def tracing_enabled() -> bool:
    """True iff a tracer is installed (live view of :data:`trace.enabled`)."""
    return trace.enabled
