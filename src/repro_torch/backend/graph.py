"""The executors of :class:`~repro_torch.backend.plan.PlanCache` entries:
a bound, state-carrying plan on a CUDA device replays as one CUDA graph.

A decode plan is called in a loop at one bucket, each call's state feeding
the next, and its eager step loop issues well over a thousand launches a
call.  :func:`executor_for` decides from what it can see — a bound bucket,
the ``cuda`` backend on a CUDA device, and persistent state slots
(:func:`capturable`) — whether an entry's executor is a
:class:`GraphedExecutor` or the eager :class:`EagerExecutor`.  Stateless
plans (prefill, the CNN) stay eager: their outputs escape to the caller,
and each of their buckets would hold a graph pool of its own.

A graphed executor owns static buffers for every plan input.  Its first
call runs the plan once eagerly on a side stream (the kernels build,
qattention's occupancy query and qmatmul's split-K scratch for that stream
are set up), then captures the whole step list into a CUDA graph on the same
stream.  Since the executor owns the state buffers, the graph's plan writes
each state that a ``kv_write`` step alone updates into its own buffer
(:func:`writes_states_in_place`); any other state output is copied back into
its state input buffer at the end.  Every call then copies in the feeds that
are not already those buffers and replays.  The in-place step writes the
rows the eager step writes into its copy, so every result is bit for bit
the eager loop's.

The contract a caller sees:

* the returned states *are* the state input buffers, so they are
  overwritten by the next call; feeding them back costs no copy, and an
  in-place write into them (the engine's prefill scatter) is what the next
  replay reads;
* a state fed from elsewhere is copied in, and the caller's tensors are left
  as they were;
* every other output is a fresh copy, which a later replay does not touch;
* a feed whose shape, dtype or device differs from the buffer's, and every
  call after a capture that failed, runs eagerly.

The cache's ``graph_stats`` count ``captures``, ``replays`` and ``eager``
calls.  Each replay adds the launches counted while capturing to
:func:`repro_torch.kernels.launch_counts`.  Under a tracer a replay is one
``plan.graph`` span (attrs ``steps``, ``batch``) in place of ``plan.execute``
and its per-step spans.
"""
from __future__ import annotations

import dataclasses
from collections import Counter
from typing import Any, Callable, Dict, Optional, Tuple

import torch

from .. import kernels
from ..kernels import qmatmul
from ..obs import trace as _trace
from .plan import SLOT

Outputs = Dict[str, torch.Tensor]
#: ``capture(body, device) -> (replay, launches)``: ``replay()`` runs what
#: ``body()`` runs and returns its outputs; ``launches`` are the kernel
#: launches each replay makes.
Capture = Callable[[Callable[[], Outputs], torch.device],
                   Tuple[Callable[[], Outputs], Dict[str, int]]]


def capturable(plan, device) -> bool:
    """Whether a plan's executor replays a CUDA graph: a bound bucket, the
    ``cuda`` backend on a CUDA device, and state carried between calls."""
    return (plan.batch != "dynamic" and plan.backend == "cuda"
            and torch.device(device).type == "cuda" and bool(plan.states))


def executor_for(plan, device, stats: Dict[str, int]) -> "EagerExecutor":
    """The executor of a plan-cache entry (see the module docstring);
    ``stats`` is the cache's ``graph_stats``."""
    if capturable(plan, device):
        return GraphedExecutor(plan, device, stats)
    return EagerExecutor(plan, stats)


class EagerExecutor:
    """Runs the plan's step loop (:meth:`ExecutionPlan.execute`), counted
    under ``eager``."""

    def __init__(self, plan, stats: Dict[str, int]) -> None:
        self.plan = plan
        self.stats = stats

    def __call__(self, feeds: Dict[str, Any]) -> Dict[str, Any]:
        self.stats["eager"] += 1
        return self.plan.execute(feeds)


def record_launches(fn: Callable[[], None]) -> Dict[str, int]:
    """Run ``fn`` and return the kernel launches it counted, by name,
    setting the counters back: a capture records launches, it runs none."""
    before = kernels.launch_counts()
    try:
        fn()
    finally:
        after = kernels.launch_counts()
        counted = {k: v - before.get(k, 0) for k, v in after.items() if v != before.get(k, 0)}
        kernels.add_launch_counts({k: -v for k, v in counted.items()})
    return counted


def capture_cuda_graph(body: Callable[[], Outputs], device: torch.device):
    """Run ``body`` once on a side stream, then capture it there into a CUDA
    graph (a :data:`Capture`).  The replay keeps the graph, and the split-K
    scratch its qmatmul launches read, alive."""
    if device.index is None:
        device = torch.device(device.type, torch.cuda.current_device())
    stream = torch.cuda.Stream(device)
    stream.wait_stream(torch.cuda.current_stream(device))
    graph = torch.cuda.CUDAGraph()
    outs: Outputs = {}

    def record():
        with torch.cuda.graph(graph, stream=stream, capture_error_mode="thread_local"):
            outs.update(body())

    try:
        with torch.cuda.stream(stream):
            body()
        launches = record_launches(record)
    finally:
        scratch = qmatmul.take_scratch(device, stream.cuda_stream)

    def replay(_keep=(graph, scratch, stream)) -> Outputs:
        graph.replay()
        return outs

    return replay, launches


def writes_states_in_place(plan):
    """``plan`` with each ``kv_write`` step marked ``in_place`` where the
    step alone reads a state's input slot and produces that state's output:
    it then writes the new rows into the state's own buffer and returns it,
    so the state needs no copy back.  Only an executor that owns the state
    buffers runs the result (:class:`GraphedExecutor`); every other caller's
    cache is left as it was."""
    readers = Counter(a.index for st in plan.steps for a in st.args if a.kind == SLOT)
    own = {s.in_slot: s.output for s in plan.states}
    steps = [
        dataclasses.replace(st, params={**st.params, "in_place": True})
        if st.kernel == "kv_write" and own.get(st.args[0].index) == st.outputs[0]
        and readers[st.args[0].index] == 1 else st
        for st in plan.steps
    ]
    return dataclasses.replace(plan, steps=steps)


def _same_buffer(a: torch.Tensor, b: torch.Tensor) -> bool:
    return a.data_ptr() == b.data_ptr() and a.stride() == b.stride()


class GraphedExecutor(EagerExecutor):
    """A bound, state-carrying plan replayed as one CUDA graph (the module
    docstring gives the contract).  ``capture`` stands in for
    :func:`capture_cuda_graph` in tests."""

    def __init__(self, plan, device, stats: Dict[str, int],
                 capture: Capture = capture_cuda_graph) -> None:
        super().__init__(plan, stats)
        self.device = torch.device(device)
        self._capture = capture
        self._static: Optional[Dict[str, torch.Tensor]] = None
        self._replay: Optional[Callable[[], Outputs]] = None
        self._launches: Dict[str, int] = {}
        self._failed = False
        #: state output name -> its state input name
        self._state_of = {s.output: s.input for s in plan.states}
        #: what the graph runs: the plan writing the states it can into
        #: their own (static) buffers
        self._in_place = writes_states_in_place(plan)
        #: feeds copied into the static buffers by the last replayed call
        self.copied_in = 0

    def _body(self) -> Outputs:
        outs = self._in_place.execute(self._static)
        for s in self.plan.states:
            buf, out = self._static[s.input], outs[s.output]
            if out is not buf:
                buf.copy_(out)
        return outs

    def _prepare(self, feeds: Dict[str, Any]) -> None:
        """Static buffers from the first call's feeds, then the capture; on
        a failed capture every call runs eagerly from then on."""
        self._static = {name: feeds[name].clone(memory_format=torch.contiguous_format)
                        for name, _ in self.plan.inputs}
        try:
            self._replay, self._launches = self._capture(self._body, self.device)
        except RuntimeError:
            self._failed = True
            self._static = None
            return
        self.stats["captures"] += 1

    def _fits(self, feeds: Dict[str, Any]) -> bool:
        for name, buf in self._static.items():
            v = feeds[name]
            if not isinstance(v, torch.Tensor) or v.shape != buf.shape or v.dtype != buf.dtype \
                    or v.device != buf.device:
                return False
        return True

    def __call__(self, feeds: Dict[str, Any]) -> Dict[str, Any]:
        if self._replay is None and not self._failed:
            self._prepare(feeds)
        if self._failed or not self._fits(feeds):
            return super().__call__(feeds)
        if not _trace.enabled:
            return self._run(feeds)
        with _trace.span("plan.graph", steps=len(self.plan.steps), batch=self.plan._batch_str()):
            return self._run(feeds)

    def _run(self, feeds: Dict[str, Any]) -> Dict[str, Any]:
        copied = 0
        for name, buf in self._static.items():
            v = feeds[name]
            if not _same_buffer(v, buf):
                buf.copy_(v)
                copied += 1
        self.copied_in = copied
        outs = self._replay()
        kernels.add_launch_counts(self._launches)
        self.stats["replays"] += 1
        state_of, static = self._state_of, self._static
        return {name: static[state_of[name]] if name in state_of else v.clone()
                for name, v in outs.items()}
