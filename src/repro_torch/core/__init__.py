"""repro_torch.core — the PQ-IR artifact and its compiler side.

Artifact:        pqir (ONNX-dialect, standard ops only, scales embedded),
                 quant (the §3.1 rescale), patterns (the codified chains)
Quantizer side:  calibrate (observers), toolchain (fp32 MLP/CNN →
                 artifact: ``quantize_mlp`` / ``quantize_cnn``), export
Compiler side:   runtime (numpy reference oracle), cache (bounded LRU),
                 compile (PQ-IR → ExecutionPlan on torch devices)
"""
from . import cache, calibrate, export, patterns, pqir, quant, runtime, toolchain  # noqa: F401
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
from .toolchain import CNNSpec, ConvLayerSpec, MLPSpec, quantize_cnn, quantize_mlp  # noqa: F401
