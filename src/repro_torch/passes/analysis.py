"""Graph-wide analyses for PQ-IR: dtype/shape inference and def-use maps.

This is the single home for the facts every optimization pass and the backend
compiler need about a :class:`repro.core.pqir.Graph`:

* :func:`infer_dtypes` — forward dtype propagation over the standard-op
  vocabulary (replaces the private ``infer_dtypes`` that used to live in
  ``repro.core.compile``).
* :func:`infer_shapes` — best-effort static shape propagation over
  :data:`SymDim` dimensions.  A dimension is a concrete ``int``, a *named
  symbolic axis* (a ``str`` such as ``"N"`` or ``"S"``), or ``None``
  (unknown); a wholly unknown shape is ``None``.  Passes must treat ``None``
  as "don't know" and stay conservative.  Named axes are declared in the
  artifact's input signatures (``("N", "S", 64)``) and the per-op rules
  (MatMul/Gemm/Conv/Reshape/Flatten/…) propagate each name through to the
  outputs, so every value knows *which* dynamic axes it carries and at what
  position.  The scenario-specialization compile path
  (``compile_model(dynamic_axes={...})``) later *binds* the names to
  concrete buckets — either by re-running :func:`infer_shapes` with
  ``bindings=`` or per-value via :func:`bind`.

  **Legacy batch convention:** artifacts that name no axis at all but export
  ``(None, …)`` inputs treat the leading ``None`` as the implicit batch axis
  :data:`BATCH_AXIS` (``"N"``) — exactly the PR 4 single-axis contract.
  :func:`graph_axes` detects this case and the per-axis machinery runs in
  *implicit* mode (the axis is pinned to position 0 by convention rather
  than tracked by name).
* :func:`axis_mixing_nodes` — the per-axis safety proof behind zero-padded
  dynamic execution: each dynamic axis is independently proven elementwise
  (no op mixes information across it) or the compile is rejected.
* :class:`GraphAnalysis` — a cached bundle of dtypes, shapes, producer and
  consumer maps plus the constant/initializer view, rebuilt from scratch by
  each pass iteration so it can never go stale against a mutated graph.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple, Union

import numpy as np

from ..core.pqir import DTYPES, Graph, Model, Node

#: One dimension: concrete int, named symbolic axis, or None (unknown).
SymDim = Optional[Union[int, str]]
Shape = Optional[Tuple[SymDim, ...]]

#: Canonical name of the implicit batch axis (the legacy leading-``None``
#: convention of ``compile_model(batch="dynamic")`` graphs).
BATCH_AXIS = "N"

_UNARY_PASSTHROUGH = frozenset(
    {"Relu", "Tanh", "Sigmoid", "Erf", "Sqrt", "Softmax", "Clip", "Identity"}
)
_BINARY_PROMOTE = frozenset({"Mul", "Add", "Sub", "Div", "Pow"})


# ---------------------------------------------------------------------------
# dtype inference
# ---------------------------------------------------------------------------


def infer_dtypes(graph: Graph) -> Dict[str, str]:
    """Forward dtype propagation; returns tensor-name → dtype-name."""
    dt: Dict[str, str] = {t.name: t.dtype for t in graph.inputs}
    for name, arr in graph.initializers.items():
        dt[name] = str(arr.dtype)
    for node in graph.toposorted():
        o = node.outputs[0]
        t = node.op_type
        if t in ("MatMulInteger", "ConvInteger"):
            dt[o] = "int32"
        elif t == "Gemm":
            # integer Gemm accumulates in int32 (dialect rule, see
            # repro.core.runtime); float Gemm preserves its input dtype
            a = dt.get(node.inputs[0], "float32")
            dt[o] = "int32" if np.issubdtype(DTYPES.get(a, np.float32), np.integer) else a
        elif t == "QuantizeLinear":
            dt[o] = dt.get(node.inputs[2], "int8") if len(node.inputs) > 2 else "int8"
        elif t == "DequantizeLinear":
            dt[o] = "float32"
        elif t == "Cast":
            dt[o] = node.attrs["to"]
        elif t == "Shape":
            dt[o] = "int64"
        elif t in _BINARY_PROMOTE and len(node.inputs) >= 2:
            a, b = dt.get(node.inputs[0]), dt.get(node.inputs[1])
            if a is not None and b is not None:
                dt[o] = str(np.promote_types(a, b))
            else:
                dt[o] = a or b or "float32"
        else:
            dt[o] = dt.get(node.inputs[0], "float32") if node.inputs else "float32"
        for extra in node.outputs[1:]:
            dt[extra] = dt[o]
    return dt


# ---------------------------------------------------------------------------
# shape inference (best-effort; None = unknown)
# ---------------------------------------------------------------------------


def _broadcast(a: Shape, b: Shape) -> Shape:
    if a is None or b is None:
        return None
    n = max(len(a), len(b))
    out: List[SymDim] = []
    for i in range(n):
        da = a[len(a) - n + i] if i >= n - len(a) else 1
        db = b[len(b) - n + i] if i >= n - len(b) else 1
        sa, sb = isinstance(da, str), isinstance(db, str)
        if sa or sb:
            # named symbolic axes: a name broadcasts against itself or 1;
            # anything else (another name, an unknown, a pinned extent) makes
            # the result untrackable — drop to wholly-unknown, never guess
            if sa and (db == 1 or da == db):
                out.append(da)
            elif sb and da == 1:
                out.append(db)
            else:
                return None
        elif da is None and db is None:
            out.append(None)
        elif da is None:
            out.append(db if db != 1 else None)
        elif db is None:
            out.append(da if da != 1 else None)
        elif da == 1:
            out.append(db)
        elif db == 1:
            out.append(da)
        elif da == db:
            out.append(da)
        else:
            return None  # incompatible — treat as unknown
    return tuple(out)


def _prod(dims) -> SymDim:
    """Product of dims: an int when fully concrete, the axis name when the
    product is one named symbolic axis times only 1s, else None (unknown)."""
    p, sym = 1, None
    for d in dims:
        if isinstance(d, str):
            if sym is not None:
                return None  # two symbolic factors: untrackable
            sym = d
        elif d is None:
            return None
        else:
            p *= int(d)
    if sym is not None:
        return sym if p == 1 else None
    return p


def _conv_hw(d: SymDim, k: int, pad0: int, pad1: int, stride: int, dil: int) -> Optional[int]:
    if not isinstance(d, int):
        return None
    return (d + pad0 + pad1 - (dil * (k - 1) + 1)) // stride + 1


def _node_shape(node: Node, sh, const) -> Shape:  # noqa: C901 (dispatch table)
    t = node.op_type
    s0: Shape = sh(node.inputs[0]) if node.inputs else None
    if t in _UNARY_PASSTHROUGH or t in ("Cast", "QuantizeLinear", "DequantizeLinear"):
        return s0
    if t in ("Mul", "Add", "Sub", "Div", "Pow"):
        return _broadcast(s0, sh(node.inputs[1]))
    if t in ("MatMul", "MatMulInteger"):
        s1 = sh(node.inputs[1])
        if s0 is None or s1 is None or len(s0) < 1:
            return None
        if len(s1) == 2:
            return tuple(s0[:-1]) + (s1[1],)
        # stacked matmul (both operands ≥ 2-D): leading dims broadcast, the
        # trailing two contract as (…, M, K) @ (…, K, N) -> (…, M, N)
        if len(s0) < 2 or len(s1) < 2:
            return None
        lead = _broadcast(tuple(s0[:-2]), tuple(s1[:-2]))
        if lead is None:
            return None
        return tuple(lead) + (s0[-2], s1[-1])
    if t == "Gemm":
        s1 = sh(node.inputs[1])
        if s0 is None or s1 is None or len(s0) != 2 or len(s1) != 2:
            return None
        m = s0[1] if node.attrs.get("transA", 0) else s0[0]
        n = s1[0] if node.attrs.get("transB", 0) else s1[1]
        return (m, n)
    if t in ("Conv", "ConvInteger"):
        s1 = sh(node.inputs[1])
        if s0 is None or s1 is None or len(s0) != 4 or len(s1) != 4:
            return None
        strides = tuple(node.attrs.get("strides", (1, 1)))
        pads = tuple(node.attrs.get("pads", (0, 0, 0, 0)))
        dil = tuple(node.attrs.get("dilations", (1, 1)))
        kh, kw = s1[2], s1[3]
        return (
            s0[0],
            s1[0],
            _conv_hw(s0[2], int(kh), pads[0], pads[2], strides[0], dil[0]),
            _conv_hw(s0[3], int(kw), pads[1], pads[3], strides[1], dil[1]),
        )
    if t == "Reshape":
        target = const(node.inputs[1]) if len(node.inputs) > 1 else None
        if target is None:
            return None
        dims = [int(d) for d in np.asarray(target).reshape(-1)]
        if -1 not in dims:
            return tuple(dims)
        # a leading named axis survives a (-1, concrete...) reshape whose tail
        # product is preserved — the row-preserving form the per-axis safety
        # proof admits — so the name keeps flowing to downstream values
        if (
            s0 is not None and len(s0) >= 1 and isinstance(s0[0], str)
            and dims[0] == -1 and all(d != -1 for d in dims[1:])
            and _prod(s0[1:]) == _prod(dims[1:])
            and isinstance(_prod(dims[1:]), int)
        ):
            return (s0[0],) + tuple(dims[1:])
        total = _prod(s0) if s0 is not None else None
        if not isinstance(total, int):
            return tuple(None if d == -1 else d for d in dims)
        rest = _prod([d for d in dims if d != -1])
        return tuple(total // rest if d == -1 else d for d in dims)
    if t == "Transpose":
        if s0 is None:
            return None
        perm = node.attrs.get("perm") or list(range(len(s0)))[::-1]
        return tuple(s0[int(p)] for p in perm)
    if t == "Flatten":
        if s0 is None:
            return None
        axis = int(node.attrs.get("axis", 1))
        return (_prod(s0[:axis]) if axis else 1, _prod(s0[axis:]))
    if t == "Concat":
        shapes = [sh(i) for i in node.inputs]
        if any(s is None for s in shapes):
            return None
        axis = int(node.attrs["axis"])
        dims = list(shapes[0])
        cat = 0
        for s in shapes:
            if not isinstance(s[axis], int):
                cat = None
                break
            cat += s[axis]
        dims[axis] = cat
        return tuple(dims)
    if t == "Gather":
        s1 = sh(node.inputs[1])
        if s0 is None or s1 is None:
            return None
        axis = int(node.attrs.get("axis", 0))
        return tuple(s0[:axis]) + tuple(s1) + tuple(s0[axis + 1 :])
    if t == "Slice":
        starts = const(node.inputs[1]) if len(node.inputs) > 1 else None
        ends = const(node.inputs[2]) if len(node.inputs) > 2 else None
        if s0 is None or starts is None or ends is None:
            return None
        starts = [int(v) for v in np.asarray(starts).reshape(-1)]
        ends = [int(v) for v in np.asarray(ends).reshape(-1)]
        axes_c = const(node.inputs[3]) if len(node.inputs) > 3 and node.inputs[3] else None
        steps_c = const(node.inputs[4]) if len(node.inputs) > 4 and node.inputs[4] else None
        axes = [int(v) for v in np.asarray(axes_c).reshape(-1)] if axes_c is not None else list(range(len(starts)))
        steps = [int(v) for v in np.asarray(steps_c).reshape(-1)] if steps_c is not None else [1] * len(starts)
        dims = list(s0)
        for s, e, a, st in zip(starts, ends, axes, steps):
            if not isinstance(dims[a], int):
                # unknown stays unknown; a sliced *named* axis loses its name
                # (the slice extent is no longer the axis extent)
                dims[a] = None
                continue
            dims[a] = len(range(*slice(s, e, st).indices(int(dims[a]))))
        return tuple(dims)
    if t in ("Squeeze", "Unsqueeze"):
        axes = const(node.inputs[1]) if len(node.inputs) > 1 else None
        if s0 is None or axes is None:
            return None
        ax = [int(a) for a in np.asarray(axes).reshape(-1)]
        if t == "Squeeze":
            return tuple(d for i, d in enumerate(s0) if i not in ax and i - len(s0) not in ax)
        dims = list(s0)
        for a in sorted(ax):
            dims.insert(a if a >= 0 else a + len(dims) + 1, 1)
        return tuple(dims)
    if t in ("MaxPool", "AveragePool"):
        if s0 is None or len(s0) != 4:
            return None
        kh, kw = node.attrs["kernel_shape"]
        strides = tuple(node.attrs.get("strides", (kh, kw)))
        pads = tuple(node.attrs.get("pads", (0, 0, 0, 0)))
        return (
            s0[0],
            s0[1],
            _conv_hw(s0[2], int(kh), pads[0], pads[2], strides[0], 1),
            _conv_hw(s0[3], int(kw), pads[1], pads[3], strides[1], 1),
        )
    if t == "GlobalAveragePool":
        return None if s0 is None else (s0[0], s0[1], 1, 1)
    if t in ("ReduceMean", "ReduceMax", "ReduceSum"):
        if s0 is None:
            return None
        axes = node.attrs.get("axes")
        ax = [int(a) % len(s0) for a in axes] if axes else list(range(len(s0)))
        keep = bool(node.attrs.get("keepdims", 1))
        if keep:
            return tuple(1 if i in ax else d for i, d in enumerate(s0))
        return tuple(d for i, d in enumerate(s0) if i not in ax)
    return None


# ---------------------------------------------------------------------------
# named symbolic axes
# ---------------------------------------------------------------------------


def is_sym(dim: SymDim) -> bool:
    """True for a named symbolic axis (a ``str`` dimension)."""
    return isinstance(dim, str)


def symbolic_axes(shape: Shape) -> Tuple[str, ...]:
    """The named symbolic axes a shape carries, in position order."""
    if shape is None:
        return ()
    return tuple(d for d in shape if isinstance(d, str))


def bind(shape: Shape, bindings: Optional[Dict[str, int]]) -> Shape:
    """Substitute named symbolic dims with concrete extents from ``bindings``.

    Axes absent from ``bindings`` stay symbolic (partial binding); an empty
    or ``None`` bindings map is always a no-op, and binding never touches a
    fully-static shape.  **Legacy convention:** an *unnamed* leading ``None``
    dim binds to :data:`BATCH_AXIS` when that axis is bound — this is what
    keeps PR 4 ``(None, …)`` single-axis artifacts working unchanged."""
    if not bindings or shape is None:
        return shape
    out: List[SymDim] = []
    for i, d in enumerate(shape):
        if isinstance(d, str) and d in bindings:
            out.append(int(bindings[d]))
        elif d is None and i == 0 and BATCH_AXIS in bindings:
            out.append(int(bindings[BATCH_AXIS]))
        else:
            out.append(d)
    return tuple(out)


def implicit_batch_graph(graph: Graph) -> bool:
    """True when the graph names no axis at all — its dynamic-axis contract
    (if any) is the legacy leading-``None`` batch convention."""
    return not any(isinstance(d, str) for t in graph.inputs for d in t.shape)


def graph_axes(graph: Graph) -> Tuple[str, ...]:
    """Named symbolic axes declared across the graph's input signatures, in
    first-appearance order.  A graph that names nothing but exports a
    ``(None, …)`` input contributes the implicit :data:`BATCH_AXIS`."""
    names: List[str] = []
    for t in graph.inputs:
        for d in t.shape:
            if isinstance(d, str) and d not in names:
                names.append(d)
    if names:
        return tuple(names)
    if any(len(t.shape) >= 1 and t.shape[0] is None for t in graph.inputs):
        return (BATCH_AXIS,)
    return ()


def axis_positions(shape: Shape, axis: str, *, implicit: bool = False) -> Optional[Tuple[int, ...]]:
    """Positions where ``axis`` occurs in ``shape`` (``None`` = shape unknown).

    ``implicit`` selects the legacy convention: the axis is the leading
    ``None`` dim (position 0) rather than a name match."""
    if shape is None:
        return None
    if implicit:
        return (0,) if (len(shape) >= 1 and shape[0] is None) else ()
    return tuple(i for i, d in enumerate(shape) if d == axis)


def axis_inputs(graph: Graph, axis: str) -> List[str]:
    """Names of graph inputs carrying the dynamic ``axis`` — the feeds a
    scenario-specialized compiled model pads to the axis bucket."""
    implicit = implicit_batch_graph(graph)
    out = []
    for t in graph.inputs:
        pos = axis_positions(tuple(t.shape), axis, implicit=implicit and axis == BATCH_AXIS)
        if pos:
            out.append(t.name)
    return out


#: Ops that are elementwise and shape-preserving along every axis whenever the
#: dynamic axis rides only the data operand (scales/zero-points are constants).
_ROWWISE_OPS = frozenset(
    {"Relu", "Tanh", "Sigmoid", "Erf", "Sqrt", "Clip", "Identity",
     "Cast", "QuantizeLinear", "DequantizeLinear"}
)
#: Contractions whose first operand carries independent rows / the N axis.
_LEAD0_OPS = frozenset({"MatMul", "MatMulInteger", "Gemm"})
_NCHW_OPS = frozenset(
    {"Conv", "ConvInteger", "MaxPool", "AveragePool", "GlobalAveragePool"}
)
_BCAST_OPS = frozenset({"Mul", "Add", "Sub", "Div", "Pow"})


def axis_mixing_nodes(
    ga: "GraphAnalysis",
    axis: str,
    *,
    implicit: Optional[bool] = None,
    exempt: frozenset = frozenset(),
) -> List[str]:
    """Nodes that cannot be *proved* elementwise along the dynamic ``axis``.

    Scenario-specialized execution pads feeds with zero slabs along each
    dynamic axis and slices results back — exact only when no op mixes
    information across that axis.  That holds for the artifact's
    quantized-inference vocabulary (elementwise chains, weight contractions
    over *other* dims, NCHW windows with the axis on the batch position) but
    is false for e.g. a global ReduceMean, Softmax over the axis, an
    axis-folding Reshape/Flatten, or a Concat along it — those would
    silently compute over the zero padding.
    ``compile_model(dynamic_axes=...)`` rejects graphs where this returns a
    non-empty list of human-readable reasons, once per requested axis.

    Two tracking modes:

    * **named** (graphs that declare axis names): the axis is followed *by
      name* through shape inference, so it may legally move position
      (Transpose, Unsqueeze) — the proof only requires that every op is
      elementwise along it and that the name survives to a unique position.
    * **implicit** (legacy ``(None, …)`` batch graphs): the axis is pinned
      to position 0 by convention, so any op that would move it off the
      leading dim is rejected — byte-for-byte the PR 4 behavior.

    Conservative by construction: an op the proof cannot reason about
    (unknown shapes, unlisted op types touching an axis-carrying value) is
    reported, not assumed safe.

    ``exempt`` lists node names the *caller* has already proven safe by a
    stronger, region-level argument — e.g. a fused-attention region whose
    masked softmax is exact under zero padding because a zero-padded mask
    forces the padded keys' weights to exactly 0 (see
    ``repro.core.compile.qattention_exempt_nodes``).  Exempted nodes are
    skipped, everything else is still proven node-by-node.
    """
    if implicit is None:
        implicit = implicit_batch_graph(ga.graph)

    def positions(name: str) -> Optional[Tuple[int, ...]]:
        if ga.is_const(name):
            return ()
        return axis_positions(ga.shape(name), axis, implicit=implicit)

    def carries(name: str) -> bool:
        p = positions(name)
        return p is None or len(p) > 0  # unknown shape: assume it may carry

    def pos_of(name: str) -> Optional[int]:
        """The unique tracked position, or None (unknown / ambiguous).
        Implicit mode pins the axis to position 0 by convention."""
        if implicit:
            return 0
        p = positions(name)
        return p[0] if p is not None and len(p) == 1 else None

    def norm_axes(axes, rank):
        return {int(a) % rank for a in axes}

    problems: List[str] = []
    for node in ga.graph.toposorted():
        if node.name and node.name in exempt:
            continue
        ins = [i for i in node.inputs if i]
        carrying = [i for i in ins if carries(i)]
        if not carrying:
            continue
        t = node.op_type
        s0 = ga.shape(node.inputs[0]) if node.inputs else None
        rank = len(s0) if s0 is not None else None
        only_data = set(carrying) <= {node.inputs[0]}
        p0 = pos_of(node.inputs[0]) if node.inputs else None
        reason = None

        if t in _ROWWISE_OPS:
            reason = None if only_data else "axis rides a non-data operand"
        elif t in _BCAST_OPS:
            out = ga.shape(node.outputs[0])
            out_pos = axis_positions(out, axis, implicit=implicit)
            if out_pos is None or len(out_pos) != 1:
                reason = "broadcast result does not keep the axis at a unique position"
            else:
                for i in ins:
                    s = ga.shape(i)
                    if s is None:
                        reason = f"operand {i!r} has unknown shape"
                        break
                    if implicit and len(s) == len(out) and s[0] is not None and s[0] != 1:
                        reason = f"operand {i!r} pins axis 0 to {s[0]}"
                        break
                    ip = axis_positions(s, axis, implicit=implicit)
                    if ip is not None and len(ip) > 1:
                        reason = f"operand {i!r} carries the axis more than once"
                        break
        elif t in _LEAD0_OPS:
            contraction = rank - 1 if rank is not None else None
            if not only_data:
                reason = "axis rides a non-row operand"
            elif p0 is None:
                reason = "cannot locate the axis on the data operand"
            elif t == "Gemm" and p0 != (1 if node.attrs.get("transA", 0) else 0):
                reason = "axis is not on the Gemm row axis"
            elif t != "Gemm" and contraction is not None and p0 == contraction:
                reason = "axis is the matmul contraction dim"
            elif t in ("MatMul", "MatMulInteger"):
                s1 = ga.shape(node.inputs[1])
                if s1 is None or len(s1) != 2:
                    reason = "rhs is not a known 2-D operand (stacked matmul may broadcast over the axis)"
        elif t in _NCHW_OPS:
            if not only_data:
                reason = "axis rides a non-data operand"
            elif p0 != 0:
                reason = "axis is not on the NCHW batch position (windows/channels mix it)"
        elif t == "Softmax":
            if not only_data or rank is None or p0 is None:
                reason = "cannot normalize the softmax axis"
            elif int(node.attrs.get("axis", -1)) % rank == p0:
                reason = "softmax normalizes over the axis"
        elif t in ("ReduceMean", "ReduceMax", "ReduceSum"):
            axes = node.attrs.get("axes")
            if axes is None or rank is None or p0 is None:
                reason = "reduces over all axes (including the dynamic axis)"
            elif p0 in norm_axes(axes, rank):
                reason = "reduces over the axis"
        elif t == "Flatten":
            a = int(node.attrs.get("axis", 1))
            if rank is None or p0 is None:
                reason = "operand shape unknown"
            else:
                side = list(enumerate(s0))[:a] if p0 < a else list(enumerate(s0))[a:]
                if any(d != 1 for i, d in side if i != p0):
                    reason = "flatten folds the axis together with other dims"
        elif t == "Transpose":
            if implicit:
                perm = node.attrs.get("perm")
                if not perm or int(perm[0]) != 0:
                    reason = "permutation moves the axis off position 0"
            else:
                out_pos = axis_positions(ga.shape(node.outputs[0]), axis)
                if out_pos is None or len(out_pos) != 1:
                    reason = "permutation loses track of the axis"
        elif t == "Concat":
            if rank is None or p0 is None or int(node.attrs["axis"]) % rank == p0:
                reason = "concatenates along the axis"
        elif t == "Gather":
            if not only_data:
                # a gather from a *constant* table is elementwise in the
                # indices (out[..., i, ...] = table[idx[..., i, ...]]), so a
                # dynamic axis riding the indices never mixes — this is the
                # embedding-lookup / LUT-gather case of the token path
                if not (ga.is_const(node.inputs[0]) and set(carrying) <= {node.inputs[1]}):
                    reason = "axis rides the indices"
            elif rank is None or p0 is None or int(node.attrs.get("axis", 0)) % rank == p0:
                reason = "gathers along the axis"
        elif t == "Slice":
            axes_c = ga.const(node.inputs[3]) if len(node.inputs) > 3 and node.inputs[3] else None
            if not only_data or axes_c is None or rank is None or p0 is None:
                reason = "slice axes unknown (may slice the dynamic axis)"
            elif p0 in norm_axes(np.asarray(axes_c).reshape(-1), rank):
                reason = "slices the axis"
        elif t in ("Squeeze", "Unsqueeze"):
            axes_c = ga.const(node.inputs[1]) if len(node.inputs) > 1 else None
            if not only_data or axes_c is None or rank is None or p0 is None:
                reason = "axes unknown"
            elif t == "Squeeze":
                if p0 in norm_axes(np.asarray(axes_c).reshape(-1), rank):
                    reason = "squeezes the axis"
            elif implicit:
                out_rank = rank + np.asarray(axes_c).size
                if 0 in norm_axes(np.asarray(axes_c).reshape(-1), out_rank):
                    reason = "moves the axis off position 0"
            # named Unsqueeze: inserting 1-dims never mixes, and shape
            # inference tracks the name to its new position
        elif t == "Reshape":
            target = ga.const(node.inputs[1]) if len(node.inputs) > 1 else None
            tail = s0[1:] if s0 is not None else None
            if p0 != 0:
                reason = "axis is not leading (only leading-axis reshapes are proven)"
            elif target is None or tail is None or any(not isinstance(d, int) for d in tail):
                reason = "target/operand shape unknown"
            else:
                dims = [int(d) for d in np.asarray(target).reshape(-1)]
                tail_total = int(np.prod([int(d) for d in tail])) if tail else 1
                rest = dims[1:]
                rest_total = int(np.prod(rest)) if rest else 1
                if not dims or dims[0] != -1 or any(d == -1 for d in rest):
                    reason = "target pins the axis dim (leading target must be -1)"
                elif rest_total != tail_total:
                    reason = "reshape folds the axis into other dims"
        else:
            reason = "op not verified elementwise along the axis under zero padding"

        if reason:
            problems.append(f"{node.name or t}[{t}]: {axis!r} {reason}")
    return problems


def infer_shapes(graph: Graph, *, bindings: Optional[Dict[str, int]] = None) -> Dict[str, Shape]:
    """Best-effort static shapes; tensors missing from the map are unknown.

    ``bindings`` substitutes named symbolic axes (and, per the legacy
    convention, an unnamed leading ``None`` when :data:`BATCH_AXIS` is
    bound) in every graph-input signature before propagation, so the whole
    map comes out specialized for that scenario bucket (used by the
    scenario-specializing lowering to cross-check per-bucket plans)."""
    shapes: Dict[str, Shape] = {
        t.name: bind(tuple(t.shape), bindings) for t in graph.inputs
    }
    for name, arr in graph.initializers.items():
        shapes[name] = tuple(arr.shape)

    def sh(name: str) -> Shape:
        return shapes.get(name)

    def const(name: str):
        return graph.initializers.get(name)

    for node in graph.toposorted():
        try:
            s = _node_shape(node, sh, const)
        except Exception:
            s = None
        for o in node.outputs:
            shapes[o] = s
    return shapes


# ---------------------------------------------------------------------------
# cached bundle
# ---------------------------------------------------------------------------


class GraphAnalysis:
    """Immutable-use snapshot of everything a pass needs to reason about a
    graph.  Rebuild (cheap) after any mutation — never reuse across edits."""

    def __init__(self, graph: Graph) -> None:
        self.graph = graph
        self.dtypes = infer_dtypes(graph)
        self.shapes = infer_shapes(graph)
        self.consumers = graph.consumers()
        self.producers = graph.producers()
        self.out_names = {t.name for t in graph.outputs}
        self.in_names = {t.name for t in graph.inputs}

    # -- constants ----------------------------------------------------------
    def is_const(self, name: str) -> bool:
        return name in self.graph.initializers

    def const(self, name: str) -> Optional[np.ndarray]:
        return self.graph.initializers.get(name)

    # -- structure ----------------------------------------------------------
    def dtype(self, name: str) -> Optional[str]:
        return self.dtypes.get(name)

    def shape(self, name: str) -> Shape:
        return self.shapes.get(name)

    def single_consumer(self, tensor: str) -> Optional[Node]:
        """The unique consuming node, or None if the tensor is a graph output
        or has zero/multiple consumers (mirrors the fusion precondition)."""
        if tensor in self.out_names:
            return None
        cons = self.consumers.get(tensor, [])
        return cons[0] if len(cons) == 1 else None


# ---------------------------------------------------------------------------
# graph cloning (passes operate on a copy; the caller's artifact is untouched)
# ---------------------------------------------------------------------------


def clone_graph(graph: Graph) -> Graph:
    """Structural copy.  Initializer arrays are shared (passes replace dict
    entries, they never mutate arrays in place)."""
    return Graph(
        name=graph.name,
        inputs=[dataclasses.replace(t) for t in graph.inputs],
        outputs=[dataclasses.replace(t) for t in graph.outputs],
        nodes=[Node(n.op_type, list(n.inputs), list(n.outputs), dict(n.attrs), n.name) for n in graph.nodes],
        initializers=dict(graph.initializers),
        states=[dataclasses.replace(s) for s in graph.states],
    )


def clone_model(model: Model) -> Model:
    return Model(
        graph=clone_graph(model.graph),
        opset=model.opset,
        ir_version=model.ir_version,
        producer=model.producer,
        metadata=dict(model.metadata),
    )
