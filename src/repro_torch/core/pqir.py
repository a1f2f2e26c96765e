"""PQ-IR: the pre-quantized model artifact (ONNX dialect).

This is the interchange format at the heart of the paper: a graph of
*standard ONNX operators only* with all quantization parameters embedded as
initializers (paper goals 1 & 3).  The container image has no ``onnx``
package, so the artifact is serialized as JSON with base64 raw tensor data —
the operator vocabulary, attribute names and dtype semantics follow the ONNX
spec exactly, so emitting protobuf instead would be a mechanical change
(see DESIGN.md §3, assumption 2).

Executability by "standard tools" (paper goal 2) is modeled by
:mod:`repro.core.runtime`, an op-by-op numpy interpreter with ONNX semantics —
our ONNXRuntime stand-in and the conformance oracle for every compiled
backend.
"""
from __future__ import annotations

import base64
import dataclasses
import json
from typing import Any, Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np

# ---------------------------------------------------------------------------
# Standard-operator vocabulary (paper goal 3: no custom operators).
# Names and semantics follow the ONNX operator set.
# ---------------------------------------------------------------------------
STANDARD_OPS = frozenset(
    {
        # quantized compute
        "MatMulInteger",
        "ConvInteger",
        # quant/dequant & rescale plumbing
        "QuantizeLinear",
        "DequantizeLinear",
        "Cast",
        "Mul",
        "Add",
        "Sub",
        "Div",
        # activations
        "Relu",
        "Tanh",
        "Sigmoid",
        "Softmax",
        "Erf",
        # float compute (for mixed-precision sections & fp32 baselines)
        "MatMul",
        "Gemm",
        "Conv",
        # shape plumbing
        "Reshape",
        "Transpose",
        "Flatten",
        "Concat",
        "Slice",
        "Gather",
        "Squeeze",
        "Unsqueeze",
        # pooling / norm
        "MaxPool",
        "AveragePool",
        "GlobalAveragePool",
        "ReduceMean",
        "ReduceMax",
        "ReduceSum",
        "Sqrt",
        "Pow",
        "Clip",
    }
)

DTYPES = {
    "float32": np.float32,
    "float16": np.float16,
    "int8": np.int8,
    "uint8": np.uint8,
    "int32": np.int32,
    "int64": np.int64,
    "bool": np.bool_,
}
_NP2NAME = {np.dtype(v): k for k, v in DTYPES.items()}


def dtype_name(arr_or_dtype) -> str:
    d = arr_or_dtype.dtype if hasattr(arr_or_dtype, "dtype") else np.dtype(arr_or_dtype)
    try:
        return _NP2NAME[np.dtype(d)]
    except KeyError:
        raise ValueError(f"unsupported dtype {d}") from None


@dataclasses.dataclass
class TensorInfo:
    name: str
    dtype: str
    shape: Tuple[Optional[int], ...]

    def to_json(self) -> dict:
        return {"name": self.name, "dtype": self.dtype, "shape": list(self.shape)}

    @staticmethod
    def from_json(d: dict) -> "TensorInfo":
        return TensorInfo(d["name"], d["dtype"], tuple(d["shape"]))


@dataclasses.dataclass
class Node:
    op_type: str
    inputs: List[str]
    outputs: List[str]
    attrs: Dict[str, Any] = dataclasses.field(default_factory=dict)
    name: str = ""

    def to_json(self) -> dict:
        return {
            "op_type": self.op_type,
            "inputs": list(self.inputs),
            "outputs": list(self.outputs),
            "attrs": _attrs_to_json(self.attrs),
            "name": self.name,
        }

    @staticmethod
    def from_json(d: dict) -> "Node":
        return Node(d["op_type"], list(d["inputs"]), list(d["outputs"]), _attrs_from_json(d.get("attrs", {})), d.get("name", ""))


def _attrs_to_json(attrs: Dict[str, Any]) -> dict:
    out = {}
    for k, v in attrs.items():
        if isinstance(v, np.ndarray):
            out[k] = {"__tensor__": _encode_array(v)}
        elif isinstance(v, (np.integer,)):
            out[k] = int(v)
        elif isinstance(v, (np.floating,)):
            out[k] = float(v)
        elif isinstance(v, (list, tuple)):
            out[k] = [int(x) if isinstance(x, (np.integer, int)) else x for x in v]
        else:
            out[k] = v
    return out


def _attrs_from_json(attrs: dict) -> Dict[str, Any]:
    out = {}
    for k, v in attrs.items():
        if isinstance(v, dict) and "__tensor__" in v:
            out[k] = _decode_array(v["__tensor__"])
        else:
            out[k] = v
    return out


def _encode_array(a: np.ndarray) -> dict:
    a = np.ascontiguousarray(a)
    return {
        "dtype": dtype_name(a),
        "shape": list(a.shape),
        "data": base64.b64encode(a.tobytes()).decode("ascii"),
    }


def _decode_array(d: dict) -> np.ndarray:
    raw = base64.b64decode(d["data"])
    return np.frombuffer(raw, dtype=DTYPES[d["dtype"]]).reshape(d["shape"]).copy()


@dataclasses.dataclass
class StateSpec:
    """A named state slot: a (graph input, graph output) pair the runtime
    carries across invocations — ONNX's past/present KV-cache convention
    (``past_key_values.*`` → ``present.*``) codified on the graph itself.

    The graph stays purely functional: a state is *declared*, not mutated.
    Each invocation reads the current state through ``input`` and produces
    the next state at ``output``; the serving layer (or the plan executor)
    feeds each ``output`` back into its ``input`` on the next call.  Both
    ends are ordinary declared tensors, so every standard tool that ignores
    ``states`` still executes the graph correctly one call at a time."""

    name: str
    input: str
    output: str

    def to_json(self) -> dict:
        return {"name": self.name, "input": self.input, "output": self.output}

    @staticmethod
    def from_json(d: dict) -> "StateSpec":
        return StateSpec(d["name"], d["input"], d["output"])


@dataclasses.dataclass
class Graph:
    name: str
    inputs: List[TensorInfo]
    outputs: List[TensorInfo]
    nodes: List[Node]
    initializers: Dict[str, np.ndarray] = dataclasses.field(default_factory=dict)
    states: List[StateSpec] = dataclasses.field(default_factory=list)

    # -- validation ---------------------------------------------------------
    def validate(self, *, standard_ops_only: bool = True) -> None:
        """Structural validation + paper-goal-3 check (standard ops only).

        Rejects: non-standard ops, duplicate graph input/output names, graph
        inputs shadowing initializers, any tensor produced twice, node inputs
        that are neither graph inputs, initializers, nor produced by any node
        (checked order-independently — the node list need not be topologically
        sorted), and cyclic graphs."""
        seen_inputs = set()
        for t in self.inputs:
            if t.name in seen_inputs:
                raise ValueError(f"duplicate graph input {t.name!r}")
            if t.name in self.initializers:
                raise ValueError(f"graph input {t.name!r} shadows an initializer")
            seen_inputs.add(t.name)
        produced = set(seen_inputs) | set(self.initializers)
        for node in self.nodes:
            if standard_ops_only and node.op_type not in STANDARD_OPS:
                raise ValueError(
                    f"non-standard operator {node.op_type!r} in node {node.name!r} "
                    "(paper goal 3 forbids custom operators)"
                )
            for o in node.outputs:
                if o in produced:
                    raise ValueError(f"tensor {o!r} produced twice")
                produced.add(o)
        for node in self.nodes:
            for i in node.inputs:
                if i and i not in produced:
                    raise ValueError(
                        f"node {node.name!r} consumes undefined tensor {i!r} "
                        "(not a graph input, initializer, or any node's output)"
                    )
        seen_outputs = set()
        for t in self.outputs:
            if t.name in seen_outputs:
                raise ValueError(f"duplicate graph output {t.name!r}")
            seen_outputs.add(t.name)
            if t.name not in produced:
                raise ValueError(f"graph output {t.name!r} never produced")
        in_specs = {t.name: t for t in self.inputs}
        out_specs = {t.name: t for t in self.outputs}
        seen_states: set = set()
        for s in self.states:
            if s.name in seen_states:
                raise ValueError(f"duplicate state {s.name!r}")
            seen_states.add(s.name)
            ti, to = in_specs.get(s.input), out_specs.get(s.output)
            if ti is None:
                raise ValueError(f"state {s.name!r} reads {s.input!r}, which is not a graph input")
            if to is None:
                raise ValueError(f"state {s.name!r} writes {s.output!r}, which is not a graph output")
            if ti.dtype != to.dtype:
                raise ValueError(
                    f"state {s.name!r} dtype mismatch: reads {ti.dtype}, writes {to.dtype}"
                )
            if len(ti.shape) != len(to.shape):
                raise ValueError(
                    f"state {s.name!r} rank mismatch: reads {ti.shape}, writes {to.shape}"
                )
        self.toposorted()  # raises on cycles

    def toposorted(self) -> List[Node]:
        """Nodes in executable order (stable Kahn topo-sort)."""
        produced = {t.name for t in self.inputs} | set(self.initializers)
        remaining = list(self.nodes)
        ordered: List[Node] = []
        while remaining:
            progressed = False
            nxt = []
            for node in remaining:
                if all((not i) or (i in produced) for i in node.inputs):
                    ordered.append(node)
                    produced.update(node.outputs)
                    progressed = True
                else:
                    nxt.append(node)
            remaining = nxt
            if not progressed:
                bad = [n.name or n.op_type for n in remaining]
                raise ValueError(f"graph has a cycle or missing producers: {bad}")
        return ordered

    def consumers(self) -> Dict[str, List[Node]]:
        out: Dict[str, List[Node]] = {}
        for node in self.nodes:
            for i in node.inputs:
                if i:
                    out.setdefault(i, []).append(node)
        return out

    def producers(self) -> Dict[str, Node]:
        out: Dict[str, Node] = {}
        for node in self.nodes:
            for o in node.outputs:
                out[o] = node
        return out

    def to_json(self) -> dict:
        doc = {
            "name": self.name,
            "inputs": [t.to_json() for t in self.inputs],
            "outputs": [t.to_json() for t in self.outputs],
            "nodes": [n.to_json() for n in self.nodes],
            "initializers": {k: _encode_array(v) for k, v in self.initializers.items()},
        }
        if self.states:  # stateless graphs stay byte-identical to pre-state JSON
            doc["states"] = [s.to_json() for s in self.states]
        return doc

    @staticmethod
    def from_json(d: dict) -> "Graph":
        return Graph(
            name=d["name"],
            inputs=[TensorInfo.from_json(t) for t in d["inputs"]],
            outputs=[TensorInfo.from_json(t) for t in d["outputs"]],
            nodes=[Node.from_json(n) for n in d["nodes"]],
            initializers={k: _decode_array(v) for k, v in d.get("initializers", {}).items()},
            states=[StateSpec.from_json(s) for s in d.get("states", [])],
        )


@dataclasses.dataclass
class Model:
    """Top-level artifact.  ``metadata`` carries provenance only — NO
    quantization parameters live here (paper goal 1: everything needed to run
    is embedded in the graph itself)."""

    graph: Graph
    opset: int = 13
    ir_version: int = 8
    producer: str = "repro-pqir"
    metadata: Dict[str, str] = dataclasses.field(default_factory=dict)

    def validate(self, *, standard_ops_only: bool = True) -> None:
        self.graph.validate(standard_ops_only=standard_ops_only)

    def to_json(self) -> dict:
        return {
            "ir_version": self.ir_version,
            "opset": self.opset,
            "producer": self.producer,
            "metadata": dict(self.metadata),
            "graph": self.graph.to_json(),
        }

    def save(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(self.to_json(), f)

    @staticmethod
    def from_json(d: dict) -> "Model":
        return Model(
            graph=Graph.from_json(d["graph"]),
            opset=d.get("opset", 13),
            ir_version=d.get("ir_version", 8),
            producer=d.get("producer", ""),
            metadata=d.get("metadata", {}),
        )

    @staticmethod
    def load(path: str) -> "Model":
        with open(path) as f:
            return Model.from_json(json.load(f))


class GraphBuilder:
    """Convenience builder used by :mod:`repro.core.patterns` and the exporter."""

    def __init__(self, name: str) -> None:
        self.name = name
        self.inputs: List[TensorInfo] = []
        self.outputs: List[TensorInfo] = []
        self.nodes: List[Node] = []
        self.initializers: Dict[str, np.ndarray] = {}
        self.states: List[StateSpec] = []
        self._counter = 0

    def fresh(self, hint: str) -> str:
        self._counter += 1
        return f"{hint}_{self._counter}"

    def add_input(self, name: str, dtype: str, shape: Sequence[Optional[int]]) -> str:
        self.inputs.append(TensorInfo(name, dtype, tuple(shape)))
        return name

    def add_output(self, name: str, dtype: str, shape: Sequence[Optional[int]]) -> str:
        self.outputs.append(TensorInfo(name, dtype, tuple(shape)))
        return name

    def add_initializer(self, name: str, value: np.ndarray) -> str:
        if name in self.initializers:
            raise ValueError(f"initializer {name!r} already exists")
        self.initializers[name] = np.asarray(value)
        return name

    def add_node(self, op_type: str, inputs: Iterable[str], outputs: Iterable[str], name: str = "", **attrs) -> Node:
        node = Node(op_type, list(inputs), list(outputs), attrs, name or self.fresh(op_type.lower()))
        self.nodes.append(node)
        return node

    def op(self, op_type: str, inputs: Iterable[str], out_hint: str = "t", name: str = "", **attrs) -> str:
        """Add a single-output node, returning the fresh output tensor name."""
        out = self.fresh(out_hint)
        self.add_node(op_type, inputs, [out], name=name, **attrs)
        return out

    def add_state(self, name: str, input: str, output: str) -> StateSpec:
        """Declare a persistent state slot pairing an existing graph input
        (the incoming state) with an existing graph output (the next state)."""
        spec = StateSpec(name, input, output)
        self.states.append(spec)
        return spec

    def build(self, validate: bool = True, **model_kwargs) -> Model:
        g = Graph(self.name, self.inputs, self.outputs, self.nodes, self.initializers, states=self.states)
        m = Model(graph=g, **model_kwargs)
        if validate:
            m.validate()
        return m
