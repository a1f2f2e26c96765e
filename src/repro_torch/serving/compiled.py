"""Micro-batching server for scenario-polymorphic compiled PQ-IR artifacts.

The token engine (:mod:`repro_torch.serving.engine`) serves the transformer stack;
this module serves the *compiled models the paper is actually about*: one
``compile_model(dynamic_axes=...)`` artifact, heavy request traffic, no
per-shape recompiles.  The structure mirrors the token engine's
request-lifecycle and metrics discipline (submit → step → drain; timestamped
requests; a flat ``metrics`` dict), specialized to single-shot inference:

* **Coalescing** — each :meth:`~CompiledModelServer.step` takes up to
  ``max_batch`` queued requests and runs them as one batch.  Coalescing is
  *axis-aware and multi-input*: a request carries one example per model
  input (a bare ndarray is single-input sugar), every input is stacked
  along the shared leading batch axis, and per-request named-axis extents
  are validated consistent across the request's inputs at submit.  With a
  variable-length sequence axis the requests are right-padded to the longest
  sequence in the group first, so the whole group lands on one cell of the
  (batch-bucket × seq-bucket) grid; the compiled model pads batch and
  sequence to their per-axis buckets and serves the cell from its bounded
  :class:`~repro_torch.backend.plan.PlanCache` — the vLLM-style shape-bucketing
  answer to "serve millions of users from one artifact", now over a 2-D
  scenario grid instead of a single free axis.
* **Deadline-aware admission** — with ``max_wait_ms`` set, a step holds off
  on a partial batch until either ``max_batch`` requests are queued or the
  *oldest* queued request has aged past the window; ageing out launches the
  partial batch immediately (a *window hit*, surfaced in :meth:`summary`).
  The default (``max_wait_ms=None``) drains greedily.
* **Padding/slicing** — zero padding is exact for every dynamic axis (the
  compiler proved each one elementwise); each request gets back exactly its
  own rows/steps, bit-identical to a solo run.
* **Metrics** — per-bucket and per-grid-cell batch counts, padded-row and
  padded-token overhead, window hits, plan-cache behavior (uniform
  ``hit_rate`` from :class:`repro_torch.core.cache.LruCache`), and request
  latency/queue-wait distributions.  Every number routes through the
  server's :class:`~repro_torch.obs.metrics.MetricsRegistry` under canonical
  ``serve.*`` / ``cache.plan.*`` keys; the flat ``metrics`` dict and
  :meth:`~CompiledModelServer.summary` keys are kept as aliases.  Latency
  is held in a log-bucketed :class:`~repro_torch.obs.metrics.Histogram` — bounded
  memory no matter how long the server lives, with p50/p95/p99 and an
  exact avg/max in :meth:`~CompiledModelServer.summary`.
* **Tracing** — with a tracer installed (:func:`repro_torch.obs.trace.install`),
  each request is an async span (``serve.request``, linked by uid) from
  submit to completion, and each :meth:`~CompiledModelServer.step` emits a
  ``serve.step`` span with ``serve.coalesce`` (stack + seq right-pad) and
  ``serve.compute`` (the bucketed model execution, with the ``serve.wait``
  for its outputs' copy to the host inside) children plus per-request
  queue-wait accounting.

The port of ``repro``'s server differs in two ways:

* execution is eager — ``repro`` jits each cell's ``plan.execute``; here
  ``CompiledModel.run`` calls the bound plan directly;
* a batch's outputs cross to the host **once per batch**, one ``.cpu()``
  per output, and each request's outputs are numpy views of that copy (as
  ``repro``'s are of its batch array).  This is deliberate: one copy per
  request would cost one device synchronisation per request.

Background autotuning is ``repro``'s: with an ``autotuner=`` (or a compiled
model that carries one) every newly served cell enqueues one
:class:`~repro_torch.backend.autotune.TuneJob`; each ``step()`` measures at
most ``tune_candidates_per_step`` tile candidates after its batch is out,
and a finished job swaps its tuned plan into the ``PlanCache`` with one
``put`` (``tuned_swaps``).
"""
from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import Any, Deque, Dict, List, Optional, Tuple

import numpy as np

from ..backend.autotune import TuneJob
from ..backend.plan import bindings_key
from ..core.compile import BATCH_AXIS, CompiledModel
from ..obs import trace as _trace
from ..obs.metrics import MetricsRegistry


@dataclasses.dataclass
class CompiledRequest:
    """One inference request: a single example per model input (no batch
    dim).  With a sequence axis the extent along it may vary per request —
    but every input of *one* request that carries the axis must agree on it
    (validated at submit)."""

    uid: int
    feeds: Dict[str, np.ndarray]
    # the request's extent along the server's variable-length axis, if any
    seq_len: Optional[int] = None
    # filled by the server:
    outputs: Optional[Dict[str, np.ndarray]] = None
    done: bool = False
    t_submit: float = 0.0
    t_done: Optional[float] = None

    @property
    def x(self) -> np.ndarray:
        """Single-input sugar: the example of a one-input request."""
        if len(self.feeds) != 1:
            raise AttributeError(
                f"request has {len(self.feeds)} input examples "
                f"({sorted(self.feeds)}); read .feeds instead of .x"
            )
        return next(iter(self.feeds.values()))

    @property
    def latency_s(self) -> Optional[float]:
        return None if self.t_done is None else self.t_done - self.t_submit


@dataclasses.dataclass
class CompiledServerConfig:
    max_batch: int = 32  # largest coalesced batch (its bucket bounds the specializations)
    # admission window: hold a partial batch until the oldest queued request
    # is this old (ms), then launch it (None = greedy drain)
    max_wait_ms: Optional[float] = None
    # background autotuning: at most this many tile candidates measured per
    # step() after its batch is served — the bound that keeps the search from
    # ever stretching a serving cycle unboundedly
    tune_candidates_per_step: int = 2

    def __post_init__(self) -> None:
        if self.max_batch < 1:
            raise ValueError(f"max_batch must be >= 1, got {self.max_batch}")
        if self.max_wait_ms is not None and self.max_wait_ms < 0:
            raise ValueError(f"max_wait_ms must be >= 0, got {self.max_wait_ms}")
        if self.tune_candidates_per_step < 1:
            raise ValueError(
                f"tune_candidates_per_step must be >= 1, got {self.tune_candidates_per_step}"
            )


class CompiledModelServer:
    """Queue + micro-batching loop over a scenario-polymorphic CompiledModel."""

    def __init__(
        self,
        cm: CompiledModel,
        cfg: Optional[CompiledServerConfig] = None,
        *,
        registry: Optional[MetricsRegistry] = None,
        autotuner=None,
        name: str = "",
        uid_start: int = 0,
    ) -> None:
        if not cm.is_dynamic:
            raise ValueError(
                "CompiledModelServer needs a scenario-polymorphic artifact — "
                'compile with compile_model(..., batch="dynamic") or '
                "dynamic_axes={...}"
            )
        batch_inputs = cm.axis_input_pos.get(BATCH_AXIS, {})
        missing = [n for n in cm.input_names if n not in batch_inputs]
        if not batch_inputs or missing:
            raise ValueError(
                f"the micro-batching server coalesces every model input along "
                f"the batch axis — inputs {missing or cm.input_names} do not "
                f"carry it (batch-carrying: {sorted(batch_inputs)})"
            )
        bad = [n for n, pos in batch_inputs.items() if pos != 0]
        if bad:
            raise ValueError(
                f"the batch axis must be the leading dim of every input, but "
                f"it is not on {sorted(bad)}"
            )
        #: single-input sugar target; None on a multi-input artifact
        self.input_name = (
            cm.input_names[0] if len(cm.input_names) == 1 else None
        )
        extra = [a for a in cm.dynamic_axes if a != BATCH_AXIS]
        if len(extra) > 1:
            raise ValueError(
                f"the server coalesces over the batch plus at most one "
                f"variable-length axis, got dynamic axes {sorted(cm.dynamic_axes)}"
            )
        self.cm = cm
        self.cfg = cfg if cfg is not None else CompiledServerConfig()
        #: the variable-length (sequence) axis, if the artifact has one
        self.seq_axis: Optional[str] = extra[0] if extra else None
        #: per-input example shape/dtype (batch dim stripped; dims may be
        #: named symbolic or None)
        self._example_shapes: Dict[str, Tuple] = {}
        self._example_dtypes: Dict[str, np.dtype] = {}
        for in_t in cm.model.graph.inputs:
            self._example_shapes[in_t.name] = tuple(in_t.shape[1:])
            self._example_dtypes[in_t.name] = np.dtype(in_t.dtype)
            stray = [
                d for d in in_t.shape[1:]
                if isinstance(d, str) and d not in cm.dynamic_axes
            ]
            if stray:
                raise ValueError(
                    f"input {in_t.name!r} has named symbolic dims {stray} the "
                    "compile left static — the server cannot validate or bucket "
                    "them; compile them as dynamic_axes or pin them to ints"
                )
        #: example-local sequence-dim position per seq-carrying input
        self._seq_pos: Dict[str, int] = {}
        if self.seq_axis is not None:
            for in_name, pos in cm.axis_input_pos[self.seq_axis].items():
                if pos == 0:
                    raise ValueError(
                        f"sequence axis {self.seq_axis!r} must sit on a "
                        f"non-leading dim of input {in_name!r}"
                    )
                self._seq_pos[in_name] = pos - 1  # batch dim stripped
            if not self._seq_pos:
                raise ValueError(
                    f"sequence axis {self.seq_axis!r} is bound by no input"
                )
        #: replica name when fronted by a router — stamps every span with a
        #: ``replica=`` attribute so fleet traces separate by owner
        self.name = name
        self.queue: Deque[CompiledRequest] = deque()
        # a router shares the uid space across replicas by offsetting each
        # replica's counter — uids stay fleet-unique for trace/fleet accounting
        self._uid = uid_start
        # per-instance registry unless the caller injects a shared one; the
        # plan cache publishes its canonical cache.plan.* gauges into it
        self.registry = registry if registry is not None else MetricsRegistry()
        cm.attach_metrics(self.registry)
        # bounded: a long-lived server keeps a log-bucketed histogram (a few
        # hundred ints), not one float per request forever
        self._latency = self.registry.histogram("serve.latency_ms")
        self._queue_wait = self.registry.histogram("serve.queue_wait_ms")
        self.metrics: Dict[str, Any] = {
            "requests": 0,
            "batches": 0,
            "completed": 0,
            "padded_rows": 0,  # bucket rows minus real rows, summed
            "padded_tokens": 0,  # seq-bucket slots minus real seq steps, summed
            "window_hits": 0,  # partial batches launched by the admission window
            "tuned_swaps": 0,  # cells whose tuned executor swapped in
            "bucket_batches": {},  # batch bucket -> number of coalesced batches
            "grid_batches": {},  # (batch bucket, seq bucket) -> batches (2-D grids)
        }
        # non-blocking autotuning: every served cell enqueues one TuneJob;
        # step() spends a bounded candidate budget on the front job after its
        # batch is out the door, and swaps the tuned executor into the
        # PlanCache atomically when the job finishes — requests are always
        # served on whatever the cache currently holds, never waiting on the
        # search
        self.autotuner = autotuner if autotuner is not None else getattr(cm, "autotuner", None)
        if self.autotuner is not None and not hasattr(self.autotuner, "tune_step"):
            raise TypeError(
                f"autotuner must be an Autotuner, got {type(self.autotuner).__name__} "
                "(it has no tune_step)"
            )
        if self.autotuner is not None:
            # the server owns the search: detach the tuner from the model so
            # a first-touch specialization inside step() can never block on a
            # measured search — cells go live on heuristic tiles immediately
            cm.autotuner = None
        self._tune_jobs: Deque[TuneJob] = deque()
        self._tuned_cells: set = set()

    def _count(self, key: str, n: int = 1) -> None:
        """One accounting site: the flat alias dict and the canonical
        ``serve.<key>`` registry counter move together."""
        self.metrics[key] += n
        self.registry.counter(f"serve.{key}").inc(n)

    # -- request lifecycle ----------------------------------------------------
    def submit(self, x) -> CompiledRequest:
        """Enqueue one request: a dict mapping every model input to its
        example (shapes = input shapes without the batch dim; the sequence
        dim, if any, may vary per request), or — single-input sugar — a bare
        ndarray.  Returns the request handle whose ``outputs`` fill on
        completion.

        Shape/dtype *and axis-binding consistency* are validated here, at
        admission: every input of one request that carries the same named
        dynamic axis must agree on its extent.  A bad example must be
        rejected up front, not blow up a coalesced batch mid-``step`` and
        take its co-batched requests down with it."""
        if isinstance(x, dict):
            feeds = {str(k): np.asarray(v) for k, v in x.items()}
            if set(feeds) != set(self.cm.input_names):
                raise ValueError(
                    f"request must feed exactly the model inputs "
                    f"{sorted(self.cm.input_names)}, got {sorted(feeds)}"
                )
        else:
            if self.input_name is None:
                raise ValueError(
                    f"multi-input artifact: submit a dict of examples for "
                    f"inputs {sorted(self.cm.input_names)}"
                )
            feeds = {self.input_name: np.asarray(x)}
        bound: Dict[str, int] = {}  # named axis -> extent this request binds
        for name, arr in feeds.items():
            want = self._example_shapes[name]
            ok = len(arr.shape) == len(want) and all(
                not isinstance(w, int) or got == w
                for got, w in zip(arr.shape, want)
            )
            if not ok or arr.dtype != self._example_dtypes[name]:
                raise ValueError(
                    f"example for input {name!r} must have shape {want} and "
                    f"dtype {self._example_dtypes[name]}, got {arr.shape} {arr.dtype}"
                )
            for got, w in zip(arr.shape, want):
                if not isinstance(w, str):
                    continue
                if got < 1:
                    raise ValueError(
                        f"example for input {name!r} has empty extent along "
                        f"axis {w!r}"
                    )
                prev = bound.setdefault(w, got)
                if prev != got:
                    raise ValueError(
                        f"inconsistent axis bindings within one request: "
                        f"axis {w!r} is {prev} on one input but {got} on "
                        f"{name!r} — all inputs of a request must agree"
                    )
        req = CompiledRequest(
            uid=self._uid,
            feeds=feeds,
            seq_len=bound.get(self.seq_axis) if self.seq_axis else None,
            t_submit=time.monotonic(),
        )
        self._uid += 1
        self.queue.append(req)
        self._count("requests")
        if _trace.enabled:
            _trace.async_begin(
                "serve.request",
                req.uid,
                shape="|".join(str(feeds[n].shape) for n in sorted(feeds)),
            )
        return req

    # -- main loop ------------------------------------------------------------
    def step(self) -> List[CompiledRequest]:
        """One server cycle: coalesce up to ``max_batch`` queued requests into
        a single bucketed model execution.  Returns the completed requests —
        possibly none, when the admission window is still holding a partial
        batch open for more arrivals.

        Idle cycles (empty queue, or a partial batch held by the admission
        window) still spend the bounded background-tuning budget — an idle
        server converges on tuned tiles fastest."""
        if not self.queue:
            self._advance_tuning()
            return []
        if (
            self.cfg.max_wait_ms is not None
            and len(self.queue) < self.cfg.max_batch
        ):
            age_ms = (time.monotonic() - self.queue[0].t_submit) * 1e3
            if age_ms < self.cfg.max_wait_ms:
                self._advance_tuning()
                return []  # hold the partial batch open for more arrivals
            self._count("window_hits")
        n = min(len(self.queue), self.cfg.max_batch)
        reqs = [self.queue.popleft() for _ in range(n)]
        with _trace.span("serve.step", n=n) as step_span:
            if _trace.enabled and self.name:
                step_span.set(replica=self.name)
            # queue wait ends at dequeue, but is only *observed* after the
            # batch succeeds — a failed batch re-queues its requests, and
            # observing here would count each retried request once per attempt
            t_deq = time.monotonic()
            # batch assembly AND execution both re-queue on failure: a failure
            # anywhere here (a shape mismatch np.stack rejects, a backend
            # error, a kernel launch that fails) must not lose the coalesced
            # requests — they go back to the head of the queue in original
            # order for the caller to retry/triage
            try:
                with _trace.span("serve.coalesce"):
                    if self.seq_axis is None:
                        seq_lens: Optional[List[int]] = None
                    else:
                        seq_lens = [int(r.seq_len) for r in reqs]
                    batch_feeds: Dict[str, np.ndarray] = {}
                    for name in self.cm.input_names:
                        seq_pos = self._seq_pos.get(name)
                        if seq_pos is None:
                            batch_feeds[name] = np.stack([r.feeds[name] for r in reqs])
                            continue
                        # right-pad every example of every seq-carrying input
                        # to the longest sequence in the group, so the whole
                        # group lands on one (batch-bucket × seq-bucket) cell
                        s_max = max(seq_lens)
                        rows = []
                        for r in reqs:
                            ex = r.feeds[name]
                            pad = s_max - ex.shape[seq_pos]
                            if pad:
                                widths = [(0, 0)] * ex.ndim
                                widths[seq_pos] = (0, pad)
                                ex = np.pad(ex, widths)
                            rows.append(ex)
                        batch_feeds[name] = np.stack(rows)
                # the compiled model pads each axis to its bucket and serves
                # the cell from its PlanCache; we only account for the
                # coalescing here
                with _trace.span("serve.compute"):
                    res = self.cm.run(batch_feeds)
                    # one host copy per output per batch (see the module
                    # docstring); requests get numpy views of it below.  The
                    # first copy waits for the batch to finish on the device.
                    with _trace.span("serve.wait") as wait_span:
                        outs = {k: v.cpu().numpy() for k, v in res.items()}
                    if _trace.enabled:
                        wait_span.set(bytes=sum(int(v.nbytes) for v in outs.values()))
            except Exception:
                # back to the head of the queue in original order; their
                # serve.request async spans stay open — each closes exactly
                # once, when the request is finally served
                self.queue.extendleft(reversed(reqs))
                raise
            # dequeue is now final: observe each request's queue wait exactly
            # once (measured at dequeue, not at completion)
            for r in reqs:
                self._queue_wait.observe((t_deq - r.t_submit) * 1e3)
            bucket = self.cm.bucket_for(BATCH_AXIS, n)
            cell_bindings = {BATCH_AXIS: bucket}
            self._count("batches")
            self._count("padded_rows", bucket - n)
            hist = self.metrics["bucket_batches"]
            hist[bucket] = hist.get(bucket, 0) + 1
            self.registry.counter(f"serve.batches.bucket.{bucket}").inc()
            if seq_lens is not None:
                s_bucket = self.cm.bucket_for(self.seq_axis, max(seq_lens))
                cell_bindings[self.seq_axis] = s_bucket
                self._count("padded_tokens", sum(s_bucket - s for s in seq_lens))
                grid = self.metrics["grid_batches"]
                cell = (bucket, s_bucket)
                grid[cell] = grid.get(cell, 0) + 1
                self.registry.counter(f"serve.batches.cell.{bucket}x{s_bucket}").inc()
                if _trace.enabled:
                    step_span.set(seq_bucket=s_bucket)
            if _trace.enabled:
                step_span.set(bucket=bucket, requests=",".join(str(r.uid) for r in reqs))
            now = time.monotonic()
            out_axes = self.cm.output_axis_pos
            for i, req in enumerate(reqs):
                # only batch-carrying outputs scatter per request (anything
                # batch-independent is shared whole); sequence-carrying
                # outputs additionally slice back to the request's own true
                # length
                req.outputs = {
                    k: self._request_view(v, out_axes.get(k, {}), i, seq_lens[i] if seq_lens else None)
                    for k, v in outs.items()
                }
                req.done = True
                req.t_done = now
                self._latency.observe((now - req.t_submit) * 1e3)
                if _trace.enabled:
                    _trace.async_end("serve.request", req.uid)
            self._count("completed", n)
        # the batch is out the door: spend the bounded tuning budget only now
        self._note_cell(cell_bindings)
        self._advance_tuning()
        return reqs

    # -- background autotuning ------------------------------------------------
    def _note_cell(self, bindings: Dict[str, int]) -> None:
        """First sighting of a scenario cell enqueues its measured search."""
        if self.autotuner is None:
            return
        key = bindings_key(bindings)
        if key in self._tuned_cells:
            return
        self._tuned_cells.add(key)
        self._tune_jobs.append(TuneJob(self.autotuner, self.cm.plan, bindings))

    def _advance_tuning(self) -> None:
        """Measure at most ``tune_candidates_per_step`` candidates of the
        front job; when a job finishes, swap its tuned executor into the
        PlanCache.  The swap is a single ``put`` — in-flight callers keep the
        heuristic entry they already hold, the next ``step()`` on the cell
        picks up the tuned one."""
        if self.autotuner is None or not self._tune_jobs:
            return
        job = self._tune_jobs[0]
        if job.advance(self.cfg.tune_candidates_per_step):
            self._tune_jobs.popleft()
            # every step of the cell is now resolved in the tuner's session,
            # so this specialization measures nothing — it just stamps the
            # tuned tiles (and their provenance source tags) into a new plan
            self.cm.install(job.bindings, self.autotuner)
            self._count("tuned_swaps")
            self.registry.counter("autotune.swaps").inc()

    @property
    def tuning_pending(self) -> int:
        """Candidates still to measure across all queued tune jobs."""
        return sum(j.remaining for j in self._tune_jobs)

    def _request_view(
        self, v: np.ndarray, axes: Dict[str, int], i: int, seq_len: Optional[int]
    ) -> np.ndarray:
        batch_pos = axes.get(BATCH_AXIS)
        seq_pos = axes.get(self.seq_axis) if self.seq_axis is not None else None
        if batch_pos is not None:
            v = v[(slice(None),) * batch_pos + (i,)]  # view, not a copy
            if seq_pos is not None and seq_pos > batch_pos:
                seq_pos -= 1
        if seq_pos is not None and seq_len is not None:
            slicer = [slice(None)] * v.ndim
            slicer[seq_pos] = slice(0, seq_len)
            v = v[tuple(slicer)]
        return v

    def run_until_drained(self, max_cycles: int = 10_000) -> List[CompiledRequest]:
        """Step until the queue is empty; returns everything completed.  An
        admission window cannot stall the drain: once the caller is draining,
        a deferred step only waits for the window to expire."""
        done: List[CompiledRequest] = []
        for _ in range(max_cycles):
            if not self.queue:
                return done
            completed = self.step()
            if not completed and self.cfg.max_wait_ms is not None:
                # deferred by the admission window — wait out the remainder
                age_s = time.monotonic() - self.queue[0].t_submit
                time.sleep(max(0.0, self.cfg.max_wait_ms / 1e3 - age_s))
            done.extend(completed)
        raise RuntimeError("compiled-model serve loop did not drain")

    # -- reporting ------------------------------------------------------------
    def summary(self) -> Dict[str, Any]:
        """Serving metrics + plan-cache behavior + latency aggregates.

        Latency aggregates come from the bounded ``serve.latency_ms``
        histogram: avg/max are exact, p50/p95/p99 are bucket estimates
        (within the histogram growth factor)."""
        lat = self._latency.stats()
        cache = self.cm.cache_stats
        out = dict(self.metrics)
        # snapshots, not aliases
        out["bucket_batches"] = dict(self.metrics["bucket_batches"])
        out["grid_batches"] = dict(self.metrics["grid_batches"])
        out.update(
            plan_cache=cache,
            plan_cache_hit_rate=cache["hit_rate"],
            tuning_pending=self.tuning_pending,
            latency_avg_ms=lat["avg"],
            latency_p50_ms=lat["p50"],
            latency_p95_ms=lat["p95"],
            latency_p99_ms=lat["p99"],
            latency_max_ms=lat["max"],
        )
        return out
