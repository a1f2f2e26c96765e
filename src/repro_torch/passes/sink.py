"""Reshape/Transpose/Flatten sinking: move pure data-movement ops *past*
elementwise ops so compute chains become contiguous and visible to the fusion
patterns.

    Transpose → Relu → …      ⇒      Relu → Transpose → …
    Reshape → Mul(c) → …      ⇒      Mul(c) → Reshape → …
    Flatten → Relu → …        ⇒      Relu → Flatten → …

Elementwise ops commute exactly with permutations/reshapes of their data
input, so the rewrite is bit-exact.  Binary ops only qualify when the other
operand is a **rank-0 scalar** initializer: broadcasting a true scalar is
layout invariant, while per-channel operands are not, and even a size-1
rank>0 constant can rank-expand its operand.  The pass iterates to a local
fixpoint, so a shape op sinks through an arbitrarily long elementwise chain
in one ``run`` — which also keeps the whole pipeline idempotent.
"""
from __future__ import annotations

from typing import Dict, Optional

from ..core.pqir import Graph, Node
from .analysis import GraphAnalysis
from .canonicalize import Pass
from .rewrite import unique_name

_SHAPE_OPS = frozenset({"Reshape", "Transpose", "Flatten"})
_UNARY = frozenset({"Relu", "Tanh", "Sigmoid", "Erf", "Sqrt", "Cast"})
_BINARY = frozenset({"Mul", "Add", "Sub", "Div"})
_SCALAR_PARAM = frozenset({"QuantizeLinear", "DequantizeLinear", "Clip"})


def _sinkable_through(ga: GraphAnalysis, consumer: Node, tensor: str) -> bool:
    t = consumer.op_type
    if t in _UNARY:
        return consumer.inputs[0] == tensor
    if t in _SCALAR_PARAM:
        if consumer.inputs[0] != tensor:
            return False
        for extra in consumer.inputs[1:]:
            if not extra:
                continue
            c = ga.const(extra)
            if c is None or c.ndim != 0:
                return False
        return True
    if t in _BINARY:
        if len(consumer.inputs) != 2 or tensor not in consumer.inputs:
            return False
        other = consumer.inputs[1] if consumer.inputs[0] == tensor else consumer.inputs[0]
        if other == tensor:
            return False  # e.g. Mul(t, t): rewiring one side is not enough
        c = ga.const(other)
        return c is not None and c.ndim == 0
    return False


class SinkShapes(Pass):
    name = "sink_shapes"

    def run(self, graph: Graph) -> Dict[str, int]:
        sunk = 0
        while True:
            ga = GraphAnalysis(graph)
            move = self._find(ga, graph)
            if move is None:
                return {"sunk": sunk}
            shape_op, consumer = move
            t = shape_op.outputs[0]
            new_t = unique_name(graph, f"{consumer.outputs[0]}_pre{shape_op.op_type.lower()}")
            # consumer now reads the shape op's input and produces a fresh name
            consumer.inputs[:] = [shape_op.inputs[0] if i == t else i for i in consumer.inputs]
            e_out = consumer.outputs[0]
            consumer.outputs[0] = new_t
            # the shape op re-materializes afterwards, keeping the public name
            replayed = Node(
                shape_op.op_type,
                [new_t] + list(shape_op.inputs[1:]),
                [e_out],
                dict(shape_op.attrs),
                shape_op.name,
            )
            idx = next(i for i, n in enumerate(graph.nodes) if n is shape_op)
            graph.nodes[idx] = replayed
            sunk += 1

    @staticmethod
    def _find(ga: GraphAnalysis, graph: Graph):
        for node in graph.toposorted():
            if node.op_type not in _SHAPE_OPS:
                continue
            consumer = ga.single_consumer(node.outputs[0])
            if consumer is None or consumer.op_type in _SHAPE_OPS:
                continue
            if _sinkable_through(ga, consumer, node.outputs[0]):
                return node, consumer
        return None
