"""Typed ExecutionPlan: the lowered form of a compiled PQ-IR artifact.

A plan is a flat list of :class:`PlanStep`\\ s over integer *buffer slots*.
Slots are storage, not tensors: liveness planning (see
:mod:`repro_torch.backend.lowering`) lets intermediates reuse the slot of a value
that is already dead, so executing a deep model touches a small, fixed pool
of buffers instead of growing a name-keyed dict.  Each step declares

* a **kernel id** resolved through :mod:`repro_torch.backend.registry` at
  execution time (``ref`` / ``cuda`` register per-id implementations — no
  backend conditionals in the executor),
* **args** — slot reads, baked constants, or absent optional operands,
* **static params** — everything specialized at *plan* time: ONNX attributes,
  output dtypes, and for the fused qmatmul path the chosen tile sizes and
  true (unpadded) problem shape,
* **consts** — parameter arrays baked into the step (for the shape-
  specialized qmatmul these are already padded to tile multiples, so the hot
  path never pads weights/bias/scales per call).

The plan's :meth:`ExecutionPlan.pretty` rendering is the co-design artifact a
hardware designer reads: one line per step with slots, dtypes/shapes, kernel
ids and static params.

Scenario specialization (named dynamic axes)
============================================

A plan's ``batch`` field says how its dynamic dimensions were handled:

* ``"static"`` — the classic path: shapes were specialized once at plan time
  (a symbolic dim falls back to default tiles).
* ``"dynamic"`` — the plan is a shape-generic **template**, open over the
  named axes in ``plan.axes`` (e.g. ``("N",)`` for the classic batch,
  ``("N", "S")`` for a batch × sequence grid): fusion, liveness slot
  planning and dtype inference are done, but the axis-dependent pieces
  (flat matmul M, bm tile choice) are left open.  Templates are not
  directly executable; they are *bound* to concrete per-axis buckets by
  :func:`repro_torch.backend.lowering.specialize_plan` (which also accepts a
  *partial* bindings dict — the result is then still a template over the
  remaining axes).
* an ``int`` — a single-axis (batch) bucket specialization of a template.
* a tuple of ``(axis, bucket)`` pairs — a multi-axis specialization.

Specializations are produced lazily and held in a bounded
:class:`PlanCache` keyed by the sorted bindings tuple.

Per-axis bucketing
==================

Each dynamic axis carries its own bucketing policy mapping a true extent to
the padded bucket: :func:`batch_bucket` (next power of two — the default,
bounding specializations at log₂(max) while wasting ≤ 2× padding) or
:func:`bucket_multiple` (round up to a granularity — e.g. the serving
engine's ``prefill_bucket`` discipline for sequence lengths).
:func:`resolve_bucketing` normalizes a user-facing axis spec (``None`` |
int granularity | callable) to a policy function.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Dict, List, Optional, Tuple, Union

import numpy as np

from ..core.cache import LruCache
from ..obs import trace as _trace
from ..obs.provenance import PlanProvenance

#: Arg kinds.
SLOT, CONST, NONE = "slot", "const", "none"


def _null_range(name: str):
    """A traced step's profiler range when no profiler records: none."""
    return _trace.NULL_SPAN


@dataclasses.dataclass(frozen=True)
class Arg:
    """One operand reference of a :class:`PlanStep`.

    kind   "slot" (read buffer ``index``), "const" (read
           ``step.consts[index]``) or "none" (absent optional input)
    index  slot number or const index
    name   source PQ-IR tensor name (for debugging)
    """

    kind: str
    index: int = -1
    name: str = ""


@dataclasses.dataclass(frozen=True)
class ValueInfo:
    """Static dtype/shape of a produced value (best-effort; None = unknown)."""

    dtype: Optional[str]
    shape: Optional[Tuple[Optional[int], ...]]

    def __str__(self) -> str:
        dt = self.dtype or "?"
        if self.shape is None:
            return f"{dt}[?]"
        dims = ",".join("?" if d is None else str(d) for d in self.shape)
        return f"{dt}[{dims}]"


@dataclasses.dataclass
class PlanStep:
    """One lowered operation: kernel id + operand refs + static params."""

    kernel: str  # registry kernel id ("qlinear_matmul", "op.Relu", ...)
    args: Tuple[Arg, ...]
    out_slots: Tuple[int, ...]
    params: Dict[str, Any] = dataclasses.field(default_factory=dict)
    consts: Tuple[Any, ...] = ()
    kind: str = "generic"  # stats bucket: fused_qlinear|fused_qconv|fused_lut|generic
    name: str = ""  # source node / pattern name
    outputs: Tuple[str, ...] = ()  # source tensor names of out_slots
    out_info: Tuple[ValueInfo, ...] = ()

    @property
    def in_slots(self) -> Tuple[int, ...]:
        return tuple(a.index for a in self.args if a.kind == SLOT)

    def describe(self) -> str:
        ins = ", ".join(
            f"%{a.index}" if a.kind == SLOT else ("·" if a.kind == NONE else f"c{a.index}")
            for a in self.args
        )
        outs = ", ".join(
            f"%{s}:{info}" if info is not None else f"%{s}"
            for s, info in zip(self.out_slots, self.out_info or (None,) * len(self.out_slots))
        )
        rendered = (
            (k, _fmt_param(v)) for k, v in sorted(self.params.items())
        )
        params = ",".join(f"{k}={v}" for k, v in rendered if v is not None)
        consts = ",".join(_arr_sig(c) for c in self.consts)
        tail = ""
        if params:
            tail += f" {{{params}}}"
        if consts:
            tail += f" consts[{consts}]"
        src = f"  # {self.name}" if self.name else ""
        return f"{outs} = {self.kernel}({ins}){tail}{src}"


def _fmt_param(v: Any) -> Optional[str]:
    """Compact static-param rendering; nested records (the qmatmul shape
    spec, generic ONNX attrs) flatten inline so the tile choices and
    attributes the plan was specialized with are visible in the printout.
    Embedded arrays are elided (their values live in ``consts``)."""
    if isinstance(v, np.ndarray):
        return None
    if isinstance(v, dict):
        inner = ",".join(
            f"{k}={fv}" for k, fv in ((k, _fmt_param(val)) for k, val in sorted(v.items()))
            if fv is not None
        )
        return "{" + inner + "}"
    if isinstance(v, (list, tuple)):
        return "(" + ",".join(str(x) for x in v) + ")"
    return str(v)


def _arr_sig(c: Any) -> str:
    if c is None:
        return "·"
    if hasattr(c, "dtype") and hasattr(c, "shape"):
        dtype = str(c.dtype).replace("torch.", "")  # torch and numpy render alike
        return f"{dtype}{tuple(int(d) for d in c.shape)}"
    return type(c).__name__


@dataclasses.dataclass(frozen=True)
class StateBinding:
    """A planned persistent state slot: the lowered form of a PQ-IR
    :class:`repro_torch.core.pqir.StateSpec`.

    The incoming state lands in buffer slot ``in_slot`` (a *pinned* slot —
    liveness planning never returns it to the free pool, so the buffer
    identity is stable across invocations) and the next state is produced at
    ``out_slot``.  ``shape`` may carry named symbolic dims (the KV cache's
    seq axis); ``specialize_plan`` binds them per bucket like any other
    value, so a specialized plan knows the concrete byte size of every
    state buffer it carries."""

    name: str
    input: str
    output: str
    in_slot: int
    out_slot: int
    dtype: Optional[str]
    shape: Optional[Tuple[Optional[Any], ...]]

    def describe(self) -> str:
        info = str(ValueInfo(self.dtype, self.shape))
        return f"{self.name}: %{self.in_slot} -> %{self.out_slot} {info}"


@dataclasses.dataclass
class ExecutionPlan:
    """A lowered, buffer-planned program for one backend.

    backend    kernel-resolution namespace ("ref" | "cuda")
    steps      lowered ops in execution order
    num_slots  size of the buffer pool (≤ number of distinct tensors thanks
               to liveness-driven slot reuse)
    inputs     (graph-input name, slot) feeds land here
    outputs    (graph-output name, slot) results are read from here
    states     persistent state slots (:class:`StateBinding`) carried across
               invocations — the int8 KV cache of the token path; () on
               stateless plans
    batch      "static" | "dynamic" (an unbound template) | int (a batch-
               bucket specialization) | tuple of (axis, bucket) pairs (a
               multi-axis specialization) — see the module docstring
    axes       named dynamic axes a "dynamic" template is still open over
               (() on static and fully-bound plans)
    provenance how this plan came to be (pass stats, fusion matches,
               specialization events, compile-time trace id) — shared by
               reference between a template and all of its specializations,
               so the record read from any of them shows the full history;
               rendered by ``pretty(verbose=True)``
    """

    backend: str
    steps: List[PlanStep]
    num_slots: int
    inputs: Tuple[Tuple[str, int], ...]
    outputs: Tuple[Tuple[str, int], ...]
    batch: Union[str, int, Tuple[Tuple[str, int], ...]] = "static"
    axes: Tuple[str, ...] = ()
    provenance: Optional[PlanProvenance] = None
    states: Tuple[StateBinding, ...] = ()

    # -- execution -----------------------------------------------------------
    def execute(self, feeds: Dict[str, Any]) -> Dict[str, Any]:
        """Slot-indexed interpretation (the hot path, run eagerly)."""
        from .registry import lookup

        if self.batch == "dynamic":
            raise RuntimeError(
                f"shape-generic template plan (open axes {list(self.axes)}) "
                "cannot execute directly: bind it first with "
                "repro_torch.backend.lowering.specialize_plan, or run through "
                "CompiledModel which caches specializations per bucket"
            )
        env: List[Any] = [None] * self.num_slots
        for name, slot in self.inputs:
            env[slot] = feeds[name]
        if _trace.enabled:
            return self._execute_traced(env)
        for step in self.steps:
            impl = lookup(self.backend, step.kernel)
            args = [
                env[a.index] if a.kind == SLOT
                else (step.consts[a.index] if a.kind == CONST else None)
                for a in step.args
            ]
            outs = impl(step, args)
            for slot, val in zip(step.out_slots, outs):
                env[slot] = val
        return {name: env[slot] for name, slot in self.outputs}

    def _execute_traced(self, env: List[Any]) -> Dict[str, Any]:
        """:meth:`execute`'s loop under a tracer: one ``plan.execute`` span,
        and in it one ``plan.<kind>`` span per step (attrs ``step``,
        ``kernel``, ``name``), each mirrored as a profiler range while a
        profiler records.  A step's interval runs from its kernel lookup to
        its last output stored; the stamps are kept in a list and become
        records only when the tracer is read."""
        from .registry import lookup

        steps = self.steps
        rng = _trace.profiler_range() or _null_range
        perf = time.perf_counter
        stamps: List[float] = []
        stamp = stamps.append

        def label(i: int) -> Tuple[str, Dict[str, Any]]:
            s = steps[i]
            return "plan." + s.kind, {"step": i, "kernel": s.kernel, "name": s.name}

        with _trace.span("plan.execute", steps=len(steps), batch=self._batch_str()):
            try:
                for step in steps:
                    with rng("plan." + step.kind):
                        t0 = perf()
                        impl = lookup(self.backend, step.kernel)
                        args = [
                            env[a.index] if a.kind == SLOT
                            else (step.consts[a.index] if a.kind == CONST else None)
                            for a in step.args
                        ]
                        outs = impl(step, args)
                        for slot, val in zip(step.out_slots, outs):
                            env[slot] = val
                        t1 = perf()
                    stamp(t0)
                    stamp(t1)
            finally:
                tracer = _trace.current()
                if tracer is not None:
                    tracer.add_steps(stamps, label)
        return {name: env[slot] for name, slot in self.outputs}

    def next_state_feeds(self, outputs: Dict[str, Any]) -> Dict[str, Any]:
        """Map one invocation's outputs to the next invocation's state feeds
        (the functional carry: ``present.* -> past_key_values.*``)."""
        return {s.input: outputs[s.output] for s in self.states}

    def execute_dict_env(self, feeds: Dict[str, Any]) -> Dict[str, Any]:
        """Name-keyed dict-env interpretation: the execution model before the
        plan, kept as the baseline of the plan's overhead.  It runs the
        *same* registry kernels; only the storage differs (a dict that only
        grows in place of the fixed slot pool)."""
        from .registry import lookup

        env: Dict[str, Any] = dict(feeds)
        for step in self.steps:
            impl = lookup(self.backend, step.kernel)
            args = [
                env[a.name] if a.kind == SLOT
                else (step.consts[a.index] if a.kind == CONST else None)
                for a in step.args
            ]
            outs = impl(step, args)
            for name, val in zip(step.outputs, outs):
                env[name] = val
        return {name: env[name] for name, _ in self.outputs}

    # -- introspection -------------------------------------------------------
    @property
    def kinds(self) -> Dict[str, int]:
        agg: Dict[str, int] = {}
        for s in self.steps:
            agg[s.kind] = agg.get(s.kind, 0) + 1
        return agg

    def _batch_str(self) -> str:
        """Rendered ``batch`` tag.  Single-axis forms are byte-identical to
        the PR 4 renderings (``dynamic`` / the bare bucket int); a multi-axis
        template additionally names its open axes, and a multi-axis
        specialization renders its bindings as ``(N=8,S=32)``."""
        if isinstance(self.batch, tuple):
            return "(" + ",".join(f"{a}={v}" for a, v in self.batch) + ")"
        if self.batch == "dynamic" and self.axes and self.axes != ("N",):
            return "dynamic, axes=[" + ",".join(self.axes) + "]"
        return str(self.batch)

    def pretty(self, verbose: bool = False) -> str:
        """Human-readable lowering — the artifact a hardware designer reads.
        ``verbose=True`` appends the provenance section (pass stats, fusion
        matches, specialization history) so the artifact explains not just
        *what* executes but *how it came to be*."""
        batch = "" if self.batch == "static" else f", batch={self._batch_str()}"
        head = (
            f"ExecutionPlan(backend={self.backend}, steps={len(self.steps)}, "
            f"slots={self.num_slots}{batch})"
        )
        ins = "  inputs:  " + ", ".join(f"{n} -> %{s}" for n, s in self.inputs)
        outs = "  outputs: " + ", ".join(f"%{s} -> {n}" for n, s in self.outputs)
        if self.states:
            outs += "\n  states:  " + ", ".join(s.describe() for s in self.states)
        body = [f"  {i:3d}: {s.describe()}" for i, s in enumerate(self.steps)]
        if verbose and self.provenance is not None:
            body.append(self.provenance.render(indent="  "))
        return "\n".join([head, ins, outs] + body)

    def __str__(self) -> str:
        return self.pretty()

    def __repr__(self) -> str:
        if self.batch == "static":
            batch = ""
        elif isinstance(self.batch, (str, int)) and not (self.axes and self.axes != ("N",)):
            batch = f", batch={self.batch!r}"  # PR 4 single-axis rendering
        else:
            batch = f", batch={self._batch_str()}"
        return (
            f"ExecutionPlan(backend={self.backend!r}, steps={len(self.steps)}, "
            f"slots={self.num_slots}, kinds={self.kinds}{batch})"
        )


# ---------------------------------------------------------------------------
# per-axis bucketing policies + the specialization cache
# ---------------------------------------------------------------------------


def batch_bucket(m: int) -> int:
    """The padded bucket for a true extent of ``m``: the smallest power of
    two ≥ m.  Power-of-two buckets bound the number of specializations at
    log₂(max extent) while wasting at most 2× padding — the
    standard continuous-batching compromise, and the default policy for
    every dynamic axis."""
    if m < 1:
        raise ValueError(f"batch must be >= 1, got {m}")
    b = 1
    while b < m:
        b <<= 1
    return b


def bucket_multiple(n: int, granularity: int) -> int:
    """Round an extent up to a multiple of ``granularity`` — the serving
    engine's prefill discipline (prompts right-pad to ``prefill_bucket``
    multiples), reusable as a per-axis policy for sequence-length axes."""
    if n < 1:
        raise ValueError(f"batch must be >= 1, got {n}")
    if granularity < 1:
        raise ValueError(f"bucket granularity must be >= 1, got {granularity}")
    return -(-n // granularity) * granularity


def resolve_bucketing(spec) -> "Callable[[int], int]":
    """Normalize a per-axis bucketing spec to a policy function.

    ``None`` → power-of-two (:func:`batch_bucket`); an ``int`` g →
    round-up-to-multiple-of-g (:func:`bucket_multiple`); a callable is used
    as-is (must map a true extent ≥ 1 to a padded bucket ≥ that extent)."""
    if spec is None:
        return batch_bucket
    if isinstance(spec, int):
        if spec < 1:
            raise ValueError(f"bucket granularity must be >= 1, got {spec}")
        return lambda n, _g=spec: bucket_multiple(n, _g)
    if callable(spec):
        return spec
    raise TypeError(
        f"axis bucketing spec must be None (power-of-two), an int granularity "
        f"or a callable, got {spec!r}"
    )


def bindings_key(bindings: Dict[str, int]) -> Tuple[Tuple[str, int], ...]:
    """Canonical :class:`PlanCache` key: the sorted (axis, bucket) tuple —
    binding order never produces distinct specializations."""
    return tuple(sorted((str(a), int(v)) for a, v in bindings.items()))


class PlanCache(LruCache):
    """Bounded LRU of per-bucket plan specializations.

    Keyed by the sorted ``(axis, bucket)`` bindings tuple
    (:func:`bindings_key`); each value is the pair ``(specialized
    ExecutionPlan, executor)``, made only by
    :meth:`repro_torch.core.compile.CompiledModel.install` (the executor a
    CUDA graph for a bound decode plan on the card, freed with its entry).
    A bucket combination is specialized at most once while it stays
    resident (the acceptance criterion for scenario-specialized serving);
    ``misses`` therefore counts specializations and ``hits`` counts
    cache-served requests.  The bound keeps adversarial shape traffic from
    accumulating specializations without limit — evicted buckets simply
    re-specialize on their next use.
    ``graph_stats`` counts how the entries' executors ran: ``captures`` (CUDA
    graphs captured), ``replays`` and ``eager`` calls.
    """

    DEFAULT_CAPACITY = 8

    def __init__(self, capacity: int = DEFAULT_CAPACITY, *, scope: Optional[str] = None) -> None:
        super().__init__(capacity, scope=scope)
        self.graph_stats: Dict[str, int] = {"captures": 0, "replays": 0, "eager": 0}
