"""Lowering: step drafts → buffer-planned :class:`ExecutionPlan`.

The compiler's builders emit :class:`StepDraft`\\ s — kernel id + symbolic
operands (graph-tensor names, baked constants, absent optionals) in execution
order.  :func:`build_plan` turns those into the typed plan:

* **slot allocation (liveness-planned):** every tensor gets an integer buffer
  slot; a slot returns to the free pool the moment its tensor's last reader
  has consumed it, so later intermediates reuse storage.  Inputs of a step
  are released *before* its outputs are allocated — an output may alias a
  dead input's slot, which is safe because the executor reads all operands
  before writing results.  Graph outputs are pinned (never freed).
* **static typing:** each produced value is annotated with the dtype/shape
  that :mod:`repro_torch.passes.analysis` inferred on the optimized graph, making
  the plan self-describing for co-design inspection.

Scenario specialization splits plan building in two: :func:`build_plan` with
``batch="dynamic"`` produces a shape-generic **template** (all of the above,
with the named symbolic axes left open — the classic batch-only case is just
``axes=("N",)``), and :func:`specialize_plan` lazily binds a template to
concrete per-axis buckets — flat M from the bound lead dims, the bm tile —
without re-running fusion, liveness planning, or parameter padding.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Tuple, Union

from ..core.pqir import Graph
from ..kernels import ops as kops
from ..obs import trace as _trace
from ..obs.provenance import PlanProvenance
from ..passes.analysis import BATCH_AXIS, GraphAnalysis, bind
from .plan import CONST, NONE, SLOT, Arg, ExecutionPlan, PlanStep, StateBinding, ValueInfo

#: Draft operand kinds: ("tensor", name) | ("const", value) | ("none", None)
DraftArg = Tuple[str, Any]


def tensor_arg(name: str) -> DraftArg:
    return ("tensor", name)


def const_arg(value: Any) -> DraftArg:
    return ("const", value)


def none_arg() -> DraftArg:
    return ("none", None)


@dataclasses.dataclass
class StepDraft:
    """A lowered-but-unplanned step: symbolic operands, no slots yet."""

    kernel: str
    args: List[DraftArg]
    outputs: List[str]
    params: Dict[str, Any] = dataclasses.field(default_factory=dict)
    consts: Tuple[Any, ...] = ()  # bag constants (read via step.consts)
    kind: str = "generic"
    name: str = ""


def build_plan(
    graph: Graph,
    analysis: GraphAnalysis,
    drafts: List[StepDraft],
    backend: str,
    batch: Union[str, int] = "static",
    axes: Tuple[str, ...] = (),
    provenance: Optional[PlanProvenance] = None,
) -> ExecutionPlan:
    """Assign liveness-planned buffer slots and produce the ExecutionPlan.

    ``batch="dynamic"`` marks the result as an unbound template open over the
    named ``axes`` (the drafts must then carry axis-open shape records — see
    the compiler's fused builders); slot planning, liveness and value typing
    are identical either way, which is exactly the point: they are
    independent of every dynamic axis.

    Graph ``states`` (the declared KV-cache pairs) lower to *persistent*
    slots: a state's input slot is pinned — excluded from liveness release —
    so its buffer identity survives the whole invocation (and, by contract,
    across invocations: the executor's caller feeds each state output back
    into its paired input).  The pairs are recorded as
    :class:`repro_torch.backend.plan.StateBinding` on the plan."""
    out_names = {t.name for t in graph.outputs}
    state_inputs = {s.input for s in graph.states}
    pinned = out_names | state_inputs

    uses: Dict[str, int] = {}
    for d in drafts:
        for kind, val in d.args:
            if kind == "tensor":
                uses[val] = uses.get(val, 0) + 1

    slot_of: Dict[str, int] = {}
    free: List[int] = []
    num_slots = 0

    def alloc(name: str) -> int:
        nonlocal num_slots
        if free:
            s = free.pop()
        else:
            s = num_slots
            num_slots += 1
        slot_of[name] = s
        return s

    def release(name: str) -> None:
        if name not in pinned and name in slot_of:
            free.append(slot_of.pop(name))

    inputs = tuple((t.name, alloc(t.name)) for t in graph.inputs)
    # graph inputs nobody reads die immediately
    for t in graph.inputs:
        if uses.get(t.name, 0) == 0:
            release(t.name)

    steps: List[PlanStep] = []
    for d in drafts:
        consts = list(d.consts)
        args: List[Arg] = []
        for kind, val in d.args:
            if kind == "tensor":
                args.append(Arg(SLOT, slot_of[val], val))
            elif kind == "const":
                consts.append(val)
                args.append(Arg(CONST, len(consts) - 1))
            else:
                args.append(Arg(NONE))
        # inputs whose last use this is free their slots now, so this step's
        # outputs may alias them (safe: operands are read before results land)
        for kind, val in d.args:
            if kind != "tensor":
                continue
            uses[val] -= 1
            if uses[val] == 0:
                release(val)
        out_slots = tuple(alloc(o) for o in d.outputs)
        for o in d.outputs:  # never-read, non-output results die immediately
            if uses.get(o, 0) == 0:
                release(o)
        out_info = tuple(ValueInfo(analysis.dtype(o), analysis.shape(o)) for o in d.outputs)
        steps.append(
            PlanStep(
                kernel=d.kernel,
                args=tuple(args),
                out_slots=out_slots,
                params=d.params,
                consts=tuple(consts),
                kind=d.kind,
                name=d.name,
                outputs=tuple(d.outputs),
                out_info=out_info,
            )
        )

    missing = [n for n in out_names if n not in slot_of]
    if missing:
        raise ValueError(f"graph outputs never lowered: {missing}")
    outputs = tuple((t.name, slot_of[t.name]) for t in graph.outputs)
    in_specs = {t.name: t for t in graph.inputs}
    states = tuple(
        StateBinding(
            name=s.name,
            input=s.input,
            output=s.output,
            in_slot=slot_of[s.input],
            out_slot=slot_of[s.output],
            dtype=in_specs[s.input].dtype,
            shape=tuple(in_specs[s.input].shape),
        )
        for s in graph.states
    )
    if batch == "dynamic" and not axes:
        axes = (BATCH_AXIS,)
    return ExecutionPlan(
        backend=backend,
        steps=steps,
        num_slots=num_slots,
        inputs=inputs,
        outputs=outputs,
        batch=batch,
        axes=axes if batch == "dynamic" else (),
        provenance=provenance,
        states=states,
    )


def specialize_plan(
    template: ExecutionPlan,
    bindings: Union[int, Dict[str, int]],
) -> ExecutionPlan:
    """Bind a scenario-polymorphic plan template to concrete axis buckets.

    ``bindings`` maps axis names to padded buckets (``{"N": 8, "S": 128}``);
    a bare int is PR 4 sugar for ``{"N": int}``.  This is the *late* half of
    shape specialization: for every fused-qmatmul step carrying an axis-open
    shape record the flat M and the bm tile are computed from the bound lead
    dims (:func:`repro_torch.kernels.ops.bind_qmatmul_axes`), and every value's
    symbolic dims are substituted in ``out_info`` so the specialized plan
    renders fully concrete.  Everything else — steps, slots, liveness,
    padded parameter tensors on the device — is shared with the template
    (no re-lowering, no tensor copies): a bucket specialization is O(steps).

    Binding a *subset* of the template's axes yields a plan that is still a
    ``"dynamic"`` template over the remaining axes (and still refuses to
    execute); binding order never matters — the result is keyed/rendered on
    the sorted bindings.  Unknown axis names are rejected.  As a degenerate
    case, ``specialize_plan(plan, {})`` on a fully-static plan is a no-op
    (there is nothing to bind); a non-empty bindings dict on a static plan
    is still an error.
    """
    if isinstance(bindings, dict):
        bindings = {str(a): int(v) for a, v in bindings.items()}
    else:
        bindings = {BATCH_AXIS: int(bindings)}
    if template.batch != "dynamic":
        if not bindings:
            return template  # nothing to bind: binding is a no-op on statics
        raise ValueError(
            f"only a batch='dynamic' template can be specialized, "
            f"got a batch={template.batch!r} plan"
        )
    unknown = sorted(set(bindings) - set(template.axes))
    if unknown:
        raise ValueError(
            f"unknown dynamic axes {unknown}: this template is open over "
            f"{list(template.axes)}"
        )
    remaining = tuple(a for a in template.axes if a not in bindings)
    with _trace.span(
        "backend.specialize",
        bindings=",".join(f"{a}={v}" for a, v in sorted(bindings.items())),
        partial=bool(remaining),
    ) as sp:
        steps = []
        tiles: Dict[str, str] = {}
        for step in template.steps:
            params = step.params
            if params.get("dynamic_attn"):
                # fused attention carries its own axis-open record (b/s/t/dh
                # rather than lead/m) and its own binder — it must NOT take
                # the qmatmul dynamic_batch path, whose binder assumes the
                # (w2,b2,qs2,qsh2) consts layout
                if remaining:
                    params = dict(params)
                    params["shape"] = kops.bind_qattention_axes(
                        step.params["shape"], bindings, partial=True
                    )
                else:
                    params = {k: v for k, v in params.items() if k != "dynamic_attn"}
                    shape = kops.bind_qattention_axes(step.params["shape"], bindings)
                    params["shape"] = shape
                    tiles[step.name or step.kernel] = ",".join(
                        f"{k}={shape[k]}" for k in ("b", "s", "t", "dh")
                    )
            elif params.get("dynamic_batch"):
                if remaining:
                    params = dict(params)
                    params["shape"] = kops.bind_qmatmul_axes(
                        step.params["shape"], bindings, partial=True
                    )
                else:
                    params = {k: v for k, v in params.items() if k != "dynamic_batch"}
                    shape = kops.bind_qmatmul_axes(step.params["shape"], bindings)
                    params["shape"] = shape
                    rec = ",".join(
                        f"{k}={shape[k]}" for k in ("m", "bm", "bk", "bn") if k in shape
                    )
                    if "bits" in shape:
                        # sub-8-bit weight lane: a hardware designer reads the
                        # precision off the cell record (activations stay int8)
                        rec += f",w{shape['bits']}/a8"
                    tiles[step.name or step.kernel] = rec
            out_info = tuple(
                ValueInfo(info.dtype, bind(info.shape, bindings)) if info is not None else info
                for info in step.out_info
            )
            steps.append(dataclasses.replace(step, params=params, out_info=out_info))
        # state buffers bind their seq extent like any other value: the
        # specialized plan knows the concrete KV-cache bucket it carries
        states = tuple(
            dataclasses.replace(s, shape=bind(s.shape, bindings)) for s in template.states
        )
        if remaining:
            return dataclasses.replace(
                template, steps=steps, batch="dynamic", axes=remaining, states=states
            )
        sp.set(**tiles)
        # a full bind is one visited scenario cell: record it on the shared
        # provenance so template *and* specializations show the history
        if template.provenance is not None:
            template.provenance.add_specialization(bindings, tiles)
        if template.axes == (BATCH_AXIS,):
            bound: Union[int, Tuple[Tuple[str, int], ...]] = bindings[BATCH_AXIS]
        else:
            bound = tuple(sorted(bindings.items()))
        return dataclasses.replace(template, steps=steps, batch=bound, axes=(), states=states)
