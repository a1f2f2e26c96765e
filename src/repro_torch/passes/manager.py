"""PassManager: named, ordered, individually-toggleable optimization passes
with per-pass stats and an optional conformance hook.

The conformance hook is the subsystem's safety contract: after every pass
that changed the graph, the transformed model is re-executed by
:class:`repro.core.runtime.ReferenceRuntime` on deterministic probe inputs
and compared against the *original* artifact — bit-exact on integer outputs,
allclose on float outputs.  A pass that breaks semantics raises
:class:`ConformanceError` naming the pass, so a bad rewrite can never
silently reach the backend compiler.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np

from ..core.pqir import DTYPES, Graph, Model
from ..core.runtime import ReferenceRuntime
from ..obs import trace as _trace
from .analysis import clone_model
from .canonicalize import AddFold, ConstantFold, DeadCode, IdentityElim, MulFold, Pass, QdqCancel
from .sink import SinkShapes


class ConformanceError(RuntimeError):
    """A pass produced a graph that is not semantics-preserving."""


def default_passes() -> List[Pass]:
    """The canonicalization pipeline, in order: fold constants, drop
    identities, sink shape ops (exposing longer elementwise chains), fold the
    §3.1 two-Mul rescales and integer Add-bias pairs, cancel
    Dequantize→Quantize round trips, then sweep dead nodes/initializers."""
    return [ConstantFold(), IdentityElim(), SinkShapes(), MulFold(), AddFold(), QdqCancel(), DeadCode()]


@dataclasses.dataclass
class PassStat:
    iteration: int
    name: str
    counters: Dict[str, int]
    changed: bool


@dataclasses.dataclass
class PipelineReport:
    entries: List[PassStat] = dataclasses.field(default_factory=list)
    nodes_before: int = 0
    nodes_after: int = 0
    iterations: int = 0

    def total(self, key: str) -> int:
        return sum(e.counters.get(key, 0) for e in self.entries)

    @property
    def totals(self) -> Dict[str, int]:
        agg: Dict[str, int] = {}
        for e in self.entries:
            for k, v in e.counters.items():
                agg[k] = agg.get(k, 0) + v
        return agg

    @property
    def changed(self) -> bool:
        return any(e.changed for e in self.entries)

    def summary(self) -> str:
        t = self.totals
        body = ";".join(f"{k}={v}" for k, v in sorted(t.items())) or "no-op"
        return f"nodes {self.nodes_before}->{self.nodes_after} ({body})"


def make_probe_feeds(graph: Graph, *, batch: int = 2, seed: int = 0) -> Dict[str, np.ndarray]:
    """Deterministic inputs matching the graph's declared signature (unknown
    dims become ``batch``) — what the conformance hook executes."""
    rng = np.random.default_rng(seed)
    feeds: Dict[str, np.ndarray] = {}
    for t in graph.inputs:
        shape = tuple(batch if d is None else int(d) for d in t.shape)
        np_dtype = DTYPES[t.dtype]
        if t.dtype == "bool":
            feeds[t.name] = rng.integers(0, 2, shape).astype(np_dtype)
        elif np.issubdtype(np_dtype, np.integer):
            info = np.iinfo(np_dtype)
            lo, hi = max(info.min, -128), min(int(info.max), 127) + 1
            if t.dtype in ("int32", "int64"):
                lo, hi = 0, 2  # likely indices — stay in range of any gather
            feeds[t.name] = rng.integers(lo, hi, shape).astype(np_dtype)
        else:
            feeds[t.name] = rng.standard_normal(shape).astype(np_dtype)
    return feeds


def _check_outputs(baseline: Dict[str, np.ndarray], got: Dict[str, np.ndarray], pass_name: str) -> None:
    for k, want in baseline.items():
        have = got[k]
        if want.dtype != have.dtype or want.shape != have.shape:
            raise ConformanceError(
                f"pass {pass_name!r} changed output {k!r} signature: "
                f"{want.dtype}{want.shape} -> {have.dtype}{have.shape}"
            )
        if np.issubdtype(want.dtype, np.integer) or want.dtype == np.bool_:
            if not np.array_equal(want, have):
                raise ConformanceError(f"pass {pass_name!r} is not bit-exact on integer output {k!r}")
        elif not np.allclose(want, have, rtol=1e-5, atol=1e-6):
            raise ConformanceError(f"pass {pass_name!r} diverged on float output {k!r}")


class PassManager:
    """Runs an ordered list of passes to a fixpoint (bounded by
    ``max_iterations`` sweeps over the list).

    passes    explicit pass list (default :func:`default_passes`)
    disable   names to skip (the toggle: ``PassManager(disable=("mul_fold",))``)
    verify    run the reference-runtime conformance hook after each changing
              pass (probe inputs are deterministic; see make_probe_feeds)
    """

    def __init__(
        self,
        passes: Optional[Sequence[Pass]] = None,
        *,
        disable: Iterable[str] = (),
        verify: bool = False,
        probe_batch: int = 2,
        probe_seed: int = 0,
        max_iterations: int = 4,
    ) -> None:
        disabled = set(disable)
        candidates = list(passes) if passes is not None else default_passes()
        unknown = disabled - {p.name for p in candidates}
        if unknown:
            raise ValueError(f"unknown pass name(s) in disable: {sorted(unknown)}")
        self.passes = [p for p in candidates if p.name not in disabled]
        self.verify = verify
        self.probe_batch = probe_batch
        self.probe_seed = probe_seed
        self.max_iterations = max_iterations

    def run(self, model: Model) -> Tuple[Model, PipelineReport]:
        """Optimize a *clone* of ``model`` (the input artifact is untouched)."""
        opt = clone_model(model)
        report = PipelineReport(nodes_before=len(opt.graph.nodes))
        baseline: Optional[Dict[str, np.ndarray]] = None
        feeds: Dict[str, np.ndarray] = {}
        with _trace.span(
            "passes.pipeline", nodes=report.nodes_before, verify=self.verify
        ) as pipe_span:
            if self.verify:
                feeds = make_probe_feeds(model.graph, batch=self.probe_batch, seed=self.probe_seed)
                baseline = ReferenceRuntime(model, validate=False).run(feeds)
            for it in range(self.max_iterations):
                sweep_changed = False
                for p in self.passes:
                    with _trace.span(f"pass.{p.name}", iteration=it) as pass_span:
                        counters = p.run(opt.graph)
                        changed = any(counters.values())
                        pass_span.set(
                            changed=changed, **{k: v for k, v in counters.items() if v}
                        )
                        report.entries.append(PassStat(it, p.name, counters, changed))
                        if changed and baseline is not None:
                            with _trace.span("pass.conformance_check"):
                                got = ReferenceRuntime(opt, validate=False).run(feeds)
                                _check_outputs(baseline, got, p.name)
                    sweep_changed |= changed
                report.iterations = it + 1
                if not sweep_changed:
                    break
            report.nodes_after = len(opt.graph.nodes)
            pipe_span.set(nodes_after=report.nodes_after, iterations=report.iterations)
            opt.validate(standard_ops_only=False)  # structural safety net
        return opt, report


def optimize(
    model: Model,
    *,
    passes: Optional[Sequence[Pass]] = None,
    disable: Iterable[str] = (),
    verify: bool = False,
) -> Tuple[Model, PipelineReport]:
    """One-shot convenience wrapper around :class:`PassManager`."""
    return PassManager(passes, disable=disable, verify=verify).run(model)
