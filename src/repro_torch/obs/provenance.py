"""Plan provenance: the record of *how* an ExecutionPlan came to be.

The paper's artifact is something a hardware designer inspects to co-design
the backend.  ``print(plan)`` shows *what* will execute; the provenance
record attached to the plan explains *why it looks that way*:

* which optimization passes fired, in which fixpoint iteration, and what
  each rewrote (``const_fold folded=3`` ...),
* which fusion patterns matched, anchored where, consuming which nodes —
  the audit trail from graph ops to fused kernel ids,
* every scenario-cell specialization the template has served, with its
  axis bindings and the tiles chosen for them (appended lazily as buckets
  are visited; the record is *shared* between a template and all of its
  specializations, so reading it from either shows the full history),
* the obs trace id active at compile time, linking the plan to the span
  timeline that produced it.

Everything here is deterministic — no wall times, no ids that vary run to
run (the trace id is only attached when a tracer is installed) — so the
rendering can be golden-pinned like the plan itself.

Stdlib-only; imports nothing from the rest of :mod:`repro`.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Tuple


@dataclasses.dataclass(frozen=True)
class PassEntry:
    """One pass application that changed the graph."""

    iteration: int
    name: str
    counters: Tuple[Tuple[str, int], ...]  # sorted, non-zero

    def describe(self) -> str:
        body = ";".join(f"{k}={v}" for k, v in self.counters)
        return f"it{self.iteration} {self.name}: {body}"


@dataclasses.dataclass(frozen=True)
class FusionRecord:
    """One fusion-pattern match: which nodes became which fused step."""

    pattern: str
    anchor: str  # anchor node name
    nodes: Tuple[str, ...]  # all consumed node names, chain order
    output: str  # the fused step's output tensor

    def describe(self) -> str:
        chain = "+".join(self.nodes)
        return f"{self.pattern} @ {self.anchor}: {chain} -> {self.output}"


@dataclasses.dataclass(frozen=True)
class SpecializationEvent:
    """One scenario-cell specialization of a plan template.

    Each tile record is the bound ``m=..,bm=..,bk=..,bn=..`` string; when the
    tiles came from the measured autotuner rather than the static heuristic
    the record carries a trailing source tag (``... [tuned]`` / ``[cache]``).
    Heuristic tiles render untagged — existing golden renderings are
    byte-identical."""

    bindings: Tuple[Tuple[str, int], ...]  # sorted (axis, bucket)
    tiles: Tuple[Tuple[str, str], ...]  # (fused step name, bound tile record)

    def describe(self) -> str:
        cell = ",".join(f"{a}={v}" for a, v in self.bindings)
        tiles = "; ".join(f"{name} {rec}" for name, rec in self.tiles) or "no fused steps"
        return f"({cell}): {tiles}"


@dataclasses.dataclass
class PlanProvenance:
    """The full how-this-plan-came-to-be record, attached to
    :class:`repro.backend.plan.ExecutionPlan` and rendered by
    ``plan.pretty(verbose=True)``."""

    nodes_before: int = 0
    nodes_after: int = 0
    pass_iterations: int = 0
    passes: List[PassEntry] = dataclasses.field(default_factory=list)
    fusions: List[FusionRecord] = dataclasses.field(default_factory=list)
    specializations: List[SpecializationEvent] = dataclasses.field(default_factory=list)
    trace_id: Optional[str] = None

    # -- construction helpers ------------------------------------------------
    def add_pass(self, iteration: int, name: str, counters: Dict[str, int]) -> None:
        nz = tuple(sorted((k, int(v)) for k, v in counters.items() if v))
        if nz:
            self.passes.append(PassEntry(iteration, name, nz))

    def add_fusion(self, pattern: str, anchor: str, nodes: Tuple[str, ...], output: str) -> None:
        self.fusions.append(FusionRecord(pattern, anchor, nodes, output))

    def add_specialization(
        self, bindings: Dict[str, int], tiles: Dict[str, str]
    ) -> SpecializationEvent:
        ev = SpecializationEvent(
            bindings=tuple(sorted((str(a), int(v)) for a, v in bindings.items())),
            tiles=tuple(sorted(tiles.items())),
        )
        self.specializations.append(ev)
        return ev

    @property
    def pass_totals(self) -> Dict[str, int]:
        agg: Dict[str, int] = {}
        for e in self.passes:
            for k, v in e.counters:
                agg[k] = agg.get(k, 0) + v
        return agg

    # -- rendering -----------------------------------------------------------
    def render(self, indent: str = "  ") -> str:
        """Deterministic human-readable provenance section."""
        pad = indent
        lines: List[str] = [f"{pad}provenance:"]
        totals = ";".join(f"{k}={v}" for k, v in sorted(self.pass_totals.items())) or "no-op"
        lines.append(
            f"{pad}  passes: nodes {self.nodes_before}->{self.nodes_after} "
            f"in {self.pass_iterations} iteration(s) ({totals})"
        )
        for e in self.passes:
            lines.append(f"{pad}    {e.describe()}")
        lines.append(f"{pad}  fusions: {len(self.fusions)} matched")
        for f in self.fusions:
            lines.append(f"{pad}    {f.describe()}")
        if self.specializations:
            lines.append(f"{pad}  specializations: {len(self.specializations)}")
            for s in self.specializations:
                lines.append(f"{pad}    {s.describe()}")
        if self.trace_id is not None:
            lines.append(f"{pad}  trace: {self.trace_id}")
        return "\n".join(lines)

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "PlanProvenance":
        """Inverse of :meth:`to_dict` — reconstructs the record from its
        JSON-able form (AOT artifacts round-trip provenance through this).
        ``to_dict(from_dict(d)) == d`` for any ``to_dict`` output."""
        prov = cls(
            nodes_before=int(d.get("nodes_before", 0)),
            nodes_after=int(d.get("nodes_after", 0)),
            pass_iterations=int(d.get("pass_iterations", 0)),
            trace_id=d.get("trace_id"),
        )
        for e in d.get("passes", ()):
            prov.add_pass(int(e["iteration"]), str(e["name"]), dict(e["counters"]))
        for f in d.get("fusions", ()):
            prov.add_fusion(
                str(f["pattern"]), str(f["anchor"]),
                tuple(f["nodes"]), str(f["output"]),
            )
        for s in d.get("specializations", ()):
            prov.add_specialization(dict(s["bindings"]), dict(s["tiles"]))
        return prov

    def to_dict(self) -> Dict[str, Any]:
        """JSON-able form (what ``benchmarks/run.py --trace`` embeds)."""
        return {
            "nodes_before": self.nodes_before,
            "nodes_after": self.nodes_after,
            "pass_iterations": self.pass_iterations,
            "passes": [
                {"iteration": e.iteration, "name": e.name, "counters": dict(e.counters)}
                for e in self.passes
            ],
            "fusions": [dataclasses.asdict(f) for f in self.fusions],
            "specializations": [
                {"bindings": dict(s.bindings), "tiles": dict(s.tiles)}
                for s in self.specializations
            ],
            "trace_id": self.trace_id,
        }
