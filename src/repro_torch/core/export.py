"""Export: JAX models → pre-quantized PQ-IR artifacts.

Closes the co-design loop: a model trained (optionally with QAT) in this
framework is calibrated on sample data and emitted as a standard-ops-only
pre-quantized artifact — which the *same* framework's hardware compiler
(:mod:`repro.core.compile`) or any conforming runtime can execute.

``export_mlp_params`` handles the paper-scale MLP/CNN cases end-to-end;
``export_linear_stack`` is the generic N-layer path used by the QAT example.
"""
from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np

from .calibrate import make_observer
from .pqir import GraphBuilder, Model
from .quant import choose_scale, quantize_linear_layer
from . import patterns


def export_linear_stack(
    weights: Sequence[np.ndarray],  # (in, out) f32 each
    biases: Sequence[Optional[np.ndarray]],
    activations: Sequence[Optional[str]],  # None | "Relu" | "Tanh" | "Sigmoid"
    calib_inputs: np.ndarray,
    *,
    observer: str = "absmax",
    name: str = "exported_model",
    two_mul: bool = True,
    tanh_mode: str = "int8",
) -> Model:
    """Calibrate + emit a pre-quantized artifact for a stack of linears."""
    from .toolchain import MLPSpec, quantize_mlp

    spec = MLPSpec(list(map(np.asarray, weights)), [None if b is None else np.asarray(b) for b in biases], list(activations))
    return quantize_mlp(spec, np.asarray(calib_inputs, np.float32), observer=observer, name=name, two_mul=two_mul, tanh_mode=tanh_mode)


def export_quant_report(model: Model) -> dict:
    """Summarize the embedded quantization parameters of an artifact —
    useful for co-design reviews (which layers got which scales/shifts)."""
    report = {"name": model.graph.name, "layers": []}
    for node in model.graph.nodes:
        if node.op_type not in ("MatMulInteger", "ConvInteger"):
            continue
        prefix = node.name.rsplit("_", 1)[0] if node.name else node.inputs[1].rsplit("_", 2)[0]
        init = model.graph.initializers
        w_name = node.inputs[1]
        entry = {"op": node.op_type, "weight": w_name, "weight_shape": list(init[w_name].shape)}
        for key in list(init):
            if key.startswith(prefix := w_name.rsplit("_weight_q", 1)[0]):
                if key.endswith("quant_scale"):
                    entry["quant_scale"] = int(float(init[key]))
                elif key.endswith("quant_shift"):
                    entry["quant_shift_bits"] = int(round(-np.log2(float(init[key]))))
                elif key.endswith("quant_multiplier"):
                    entry["quant_multiplier"] = float(init[key])
        report["layers"].append(entry)
    return report
