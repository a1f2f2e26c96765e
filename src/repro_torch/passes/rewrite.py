"""Declarative pattern-rewrite engine for PQ-IR graphs.

A fusion or canonicalization candidate is described as *data*, not code: a
:class:`Pattern` is a chain of :class:`OpSpec` entries matched along
single-consumer edges starting at an anchor node.  Each spec carries the
preconditions the old hand-written matchers used to check imperatively —
accepted op types, arity, required attribute values, which inputs must be
initializers (captured by name), and an optional escape-hatch predicate for
anything numeric (e.g. "scale must be exactly 1.0").

Matching walks the producer→consumer chain with the same safety contract the
original ``core.compile`` matchers enforced: every intermediate tensor must
have exactly one consumer and must not be a graph output, so consuming the
matched nodes can never orphan a value another part of the graph needs.

The module also hosts the small graph-surgery helpers every rewrite needs
(:func:`remove_nodes`, :func:`replace_uses`, :func:`bypass_tensor`,
:func:`unique_name`), so passes stay declarative + a few lines of wiring.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Iterable, List, Mapping, Optional, Sequence, Tuple, Union

import numpy as np

from ..core.pqir import Graph, Node
from .analysis import GraphAnalysis

Predicate = Callable[[GraphAnalysis, Node], bool]


@dataclasses.dataclass(frozen=True)
class OpSpec:
    """One link in a pattern chain.

    op            accepted op_type (or tuple of alternatives)
    capture       name under which the matched node is recorded
    optional      the chain may skip this link
    arity         required number of non-empty inputs (None = any)
    attrs         attribute values that must match exactly
    const_inputs  input-index → capture-name; that input must be an
                  initializer, whose value is recorded in ``Match.consts``
    const_operand for commutative binary ops: the operand that is *not* the
                  incoming chain tensor must be an initializer (captured)
    where         extra predicate on (analysis, node)
    """

    op: Union[str, Tuple[str, ...]]
    capture: str = ""
    optional: bool = False
    arity: Optional[int] = None
    attrs: Mapping[str, Any] = dataclasses.field(default_factory=dict)
    const_inputs: Mapping[int, str] = dataclasses.field(default_factory=dict)
    const_operand: str = ""
    where: Optional[Predicate] = None

    @property
    def ops(self) -> Tuple[str, ...]:
        return (self.op,) if isinstance(self.op, str) else tuple(self.op)


@dataclasses.dataclass(frozen=True)
class Pattern:
    """An op chain matched along single-consumer edges.  ``where`` (if set)
    validates the completed :class:`Match` — use it for cross-link
    constraints (e.g. "the fp16 down-cast and up-cast must appear together")."""

    name: str
    chain: Tuple[OpSpec, ...]
    where: Optional[Callable[["Match"], bool]] = None

    @property
    def anchor_ops(self) -> Tuple[str, ...]:
        return self.chain[0].ops


class Match:
    """A successful pattern application: matched nodes in chain order plus
    captured nodes/constants by name."""

    def __init__(self, pattern: Pattern) -> None:
        self.pattern = pattern
        self.nodes: List[Node] = []
        self._caps: Dict[str, Node] = {}
        self.consts: Dict[str, np.ndarray] = {}

    def node(self, capture: str) -> Optional[Node]:
        return self._caps.get(capture)

    def __contains__(self, capture: str) -> bool:
        return capture in self._caps

    @property
    def anchor(self) -> Node:
        return self.nodes[0]

    @property
    def last(self) -> Node:
        return self.nodes[-1]

    @property
    def out_tensor(self) -> str:
        return self.last.outputs[0]


def _try_spec(ga: GraphAnalysis, spec: OpSpec, node: Node, chain_in: Optional[str]) -> Optional[Dict[str, np.ndarray]]:
    """Check one spec against one node; returns captured constants or None."""
    if node.op_type not in spec.ops:
        return None
    if spec.arity is not None and len([i for i in node.inputs if i]) != spec.arity:
        return None
    for k, v in spec.attrs.items():
        if node.attrs.get(k) != v:
            return None
    consts: Dict[str, np.ndarray] = {}
    for idx, cap in spec.const_inputs.items():
        if idx >= len(node.inputs):
            return None
        val = ga.const(node.inputs[idx])
        if val is None:
            return None
        consts[cap] = val
    if spec.const_operand:
        if len(node.inputs) != 2:
            return None
        if chain_in is not None:
            if chain_in not in node.inputs:
                return None
            other = node.inputs[1] if node.inputs[0] == chain_in else node.inputs[0]
        else:
            # anchor position: exactly one operand must be the constant
            flags = [ga.is_const(i) for i in node.inputs]
            if sum(flags) != 1:
                return None
            other = node.inputs[flags.index(True)]
        val = ga.const(other)
        if val is None:
            return None
        consts[spec.const_operand] = val
    if spec.where is not None and not spec.where(ga, node):
        return None
    return consts


def match_chain(ga: GraphAnalysis, start: Node, pattern: Pattern) -> Optional[Match]:
    """Match ``pattern`` anchored at ``start``; None if any mandatory link
    fails.  Optional links are matched greedily."""
    specs = pattern.chain
    got = _try_spec(ga, specs[0], start, None)
    if got is None:
        return None
    m = Match(pattern)
    _record(m, specs[0], start, got)
    cur = start.outputs[0]
    for spec in specs[1:]:
        nxt = ga.single_consumer(cur)
        got = None
        if nxt is not None and (spec.const_operand or (nxt.inputs and nxt.inputs[0] == cur)):
            got = _try_spec(ga, spec, nxt, cur)
        if got is not None:
            _record(m, spec, nxt, got)
            cur = nxt.outputs[0]
        elif spec.optional:
            continue
        else:
            return None
    if pattern.where is not None and not pattern.where(m):
        return None
    return m


def _record(m: Match, spec: OpSpec, node: Node, consts: Dict[str, np.ndarray]) -> None:
    m.nodes.append(node)
    if spec.capture:
        m._caps[spec.capture] = node
    m.consts.update(consts)


def ql_params(ga: GraphAnalysis, node: Node):
    """(scale, zero_point) initializers of a QuantizeLinear/DequantizeLinear
    node; zero_point defaults to int8 0.  None scale means non-constant."""
    scale = ga.const(node.inputs[1]) if len(node.inputs) > 1 else None
    zp = ga.const(node.inputs[2]) if len(node.inputs) > 2 else np.zeros((), np.int8)
    return scale, zp


# ---------------------------------------------------------------------------
# graph surgery helpers
# ---------------------------------------------------------------------------


def all_tensor_names(graph: Graph) -> set:
    names = {t.name for t in graph.inputs} | {t.name for t in graph.outputs} | set(graph.initializers)
    for node in graph.nodes:
        names.update(node.inputs)
        names.update(node.outputs)
    return names


def unique_name(graph: Graph, base: str) -> str:
    taken = all_tensor_names(graph)
    if base not in taken:
        return base
    i = 1
    while f"{base}_{i}" in taken:
        i += 1
    return f"{base}_{i}"


def replace_uses(graph: Graph, old: str, new: str) -> None:
    """Rewrite every node input reading ``old`` to read ``new``."""
    for node in graph.nodes:
        node.inputs[:] = [new if i == old else i for i in node.inputs]


def remove_nodes(graph: Graph, nodes: Iterable[Node]) -> None:
    doomed = {id(n) for n in nodes}
    graph.nodes[:] = [n for n in graph.nodes if id(n) not in doomed]


def bypass_tensor(graph: Graph, src: str, dst: str) -> bool:
    """Make the graph read ``src`` wherever it read ``dst`` (the nodes that
    produced ``dst`` must already be removed).  If ``dst`` is a graph output,
    the surviving ``src`` tensor is renamed to ``dst`` so the artifact's
    external interface is unchanged; that rename is only possible when ``src``
    is node-produced and not itself part of the interface — returns False if
    the rewrite cannot be done safely (caller should skip the rewrite)."""
    out_names = {t.name for t in graph.outputs}
    if dst not in out_names:
        replace_uses(graph, dst, src)
        return True
    in_names = {t.name for t in graph.inputs}
    if src in out_names or src in in_names or src in graph.initializers:
        return False
    producer = None
    for node in graph.nodes:
        if src in node.outputs:
            producer = node
            break
    if producer is None:
        return False
    producer.outputs[producer.outputs.index(src)] = dst
    replace_uses(graph, src, dst)
    return True
