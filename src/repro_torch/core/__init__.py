"""repro_torch.core — the PQ-IR artifact and its compiler side.

Artifact:        pqir (ONNX-dialect, standard ops only, scales embedded),
                 quant (the §3.1 rescale), patterns (the codified chains)
Compiler side:   runtime (numpy reference oracle), cache (bounded LRU),
                 compile (PQ-IR → ExecutionPlan on torch devices)
"""
from . import cache, patterns, pqir, quant, runtime  # noqa: F401
from .pqir import Graph, GraphBuilder, Model, Node, TensorInfo  # noqa: F401
from .quant import (  # noqa: F401
    MAX_EXACT_FLOAT_INT,
    QuantizedLinearParams,
    Rescale,
    decompose_multiplier,
    dequantize,
    quantize,
    quantize_bias,
    quantize_linear_layer,
)
from .runtime import ReferenceRuntime, run_model  # noqa: F401
