"""Quantizer-side toolchain: fp32 model + calibration data → PQ-IR artifact.

This is the "independent development" half of the paper's co-design story:
everything here runs with *no knowledge of the target hardware* — it profiles
activations, picks scales, quantizes weights/biases per §3, decomposes the
rescale multipliers per §3.1, and emits a standard-ops-only artifact.  The
hardware team consumes the artifact via :mod:`repro.core.compile`.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence

import numpy as np

from . import patterns
from .calibrate import make_observer
from .pqir import GraphBuilder, Model
from .quant import (
    choose_scale,
    choose_scales,
    decompose_multiplier,
    decompose_multipliers,
    quantize,
    quantize_bias,
    quantize_linear_layer,
)


@dataclasses.dataclass
class MLPSpec:
    """A float MLP: x @ W1 + b1 -> act -> … -> logits."""

    weights: List[np.ndarray]  # each (in, out), float32
    biases: List[Optional[np.ndarray]]
    activations: List[Optional[str]]  # per layer: None|"Relu"|"Tanh"|"Sigmoid"|...

    def forward(self, x: np.ndarray) -> List[np.ndarray]:
        """Returns the list of per-layer pre-activation/post-activation outputs
        (used for calibration)."""
        outs = []
        h = x.astype(np.float32)
        for w, b, act in zip(self.weights, self.biases, self.activations):
            h = h @ w
            if b is not None:
                h = h + b
            if act == "Relu":
                h = np.maximum(h, 0.0)
            elif act == "Tanh":
                h = np.tanh(h)
            elif act == "Sigmoid":
                h = 1.0 / (1.0 + np.exp(-h))
            outs.append(h)
        return outs


def quantize_mlp(
    spec: MLPSpec,
    calib_data: np.ndarray,
    *,
    observer: str = "absmax",
    name: str = "prequantized_mlp",
    two_mul: bool = True,
    per_channel: bool = False,
    tanh_mode: str = "int8",  # "int8" (Fig 4) or "fp16" (Fig 5)
    weight_bits: int = 8,
) -> Model:
    """Produce a complete pre-quantized MLP artifact (the paper's §4 example
    generalized to N layers).

    ``weight_bits=4`` codifies every FC layer's weights on [-8, 7] (QONNX-style
    sub-8-bit lane): the graph carries a ``weight_bits`` attr per core op and
    the backend packs two nibbles per byte at plan time."""
    n_layers = len(spec.weights)
    # ---- calibration pass (quantizer side, hardware-agnostic) ----
    obs_in = make_observer(observer)
    obs_in.observe(calib_data)
    layer_outs = spec.forward(calib_data)
    obs_layers = []
    for h in layer_outs:
        o = make_observer(observer)
        o.observe(h)
        obs_layers.append(o)

    gb = GraphBuilder(name)
    in_dtype = "int8"
    scale_x = obs_in.scale(in_dtype)
    x = gb.add_input("input_q", in_dtype, (None, spec.weights[0].shape[0]))
    cur_scale = scale_x
    for i, (w, b, act) in enumerate(zip(spec.weights, spec.biases, spec.activations)):
        prefix = f"fc{i}"
        last = i == n_layers - 1
        out_dtype = "uint8" if act == "Sigmoid" else "int8"
        if act in ("Tanh", "Sigmoid"):
            # Activation patterns fix their own output scale convention.
            scale_y = (1.0 / 127.0) if act == "Tanh" else (1.0 / 255.0)
            absmax = patterns.TANH_INPUT_ABSMAX if act == "Tanh" else patterns.SIGMOID_INPUT_ABSMAX
            # FC rescale maps accumulator onto the activation's input range.
            p = quantize_linear_layer(
                w, b, cur_scale, absmax / 127.0, per_channel=per_channel, in_dtype=in_dtype, out_dtype="int8",
                bits=weight_bits,
            )
            if act == "Tanh":
                fn = patterns.fc_int8_tanh if tanh_mode == "int8" else patterns.fc_fp16_tanh
                x = fn(gb, x, p, prefix, input_absmax=absmax)
            else:
                x = patterns.fc_fp16_sigmoid(gb, x, p, prefix, input_absmax=absmax)
        else:
            scale_y = choose_scale(_absmax_of(obs_layers[i]), out_dtype)
            p = quantize_linear_layer(
                w, b, cur_scale, scale_y, per_channel=per_channel, in_dtype=in_dtype, out_dtype=out_dtype,
                bits=weight_bits,
            )
            x = patterns.fc_layer(gb, x, p, prefix, two_mul=two_mul, activation=act)
        cur_scale = scale_y
        in_dtype = out_dtype
    gb.add_output(x, in_dtype, (None, spec.weights[-1].shape[1]))
    model = gb.build()
    model.metadata.update({"source": "repro.toolchain.quantize_mlp", "input_scale": repr(scale_x), "output_scale": repr(cur_scale)})
    return model


def _absmax_of(obs) -> float:
    a = obs.absmax
    return float(a() if callable(a) else a)


@dataclasses.dataclass
class ConvLayerSpec:
    weight: np.ndarray  # (M, C, kH, kW) float32
    bias: Optional[np.ndarray]
    strides: Sequence[int] = (1, 1)
    pads: Sequence[int] = (0, 0, 0, 0)
    activation: Optional[str] = None  # None | "Relu"


@dataclasses.dataclass
class CNNSpec:
    """Conv stack + optional trailing FC head (LeNet-style)."""

    convs: List[ConvLayerSpec]
    head: Optional[MLPSpec] = None

    def forward_convs(self, x: np.ndarray) -> List[np.ndarray]:
        from .runtime import _conv2d_f32  # reuse reference conv

        outs = []
        h = x.astype(np.float32)
        for c in self.convs:
            attrs = {"strides": tuple(c.strides), "pads": tuple(c.pads)}
            h = _conv2d_f32(h, c.weight.astype(np.float32), attrs)
            if c.bias is not None:
                h = h + c.bias.reshape(1, -1, 1, 1)
            if c.activation == "Relu":
                h = np.maximum(h, 0.0)
            outs.append(h)
        return outs


def quantize_cnn(
    spec: CNNSpec,
    calib_data: np.ndarray,
    *,
    observer: str = "absmax",
    name: str = "prequantized_cnn",
    two_mul: bool = False,
    per_channel: bool = False,
) -> Model:
    """Produce the paper's §5 CNN artifact (ConvInteger pattern), optionally
    followed by a flattened FC head.  With ``per_channel=True`` every conv
    filter (output channel) and FC output feature gets its own weight scale
    and §3.1 rescale decomposition, codified as vector Mul constants."""
    obs_in = make_observer(observer)
    obs_in.observe(calib_data)
    conv_outs = spec.forward_convs(calib_data)

    gb = GraphBuilder(name)
    scale_x = obs_in.scale("int8")
    n, c, h, w = calib_data.shape
    x = gb.add_input("input_q", "int8", (None, c, h, w))
    cur_scale = scale_x
    for i, (conv, out_f32) in enumerate(zip(spec.convs, conv_outs)):
        prefix = f"conv{i}"
        o = make_observer(observer)
        o.observe(out_f32)
        scale_y = choose_scale(_absmax_of(o), "int8")
        if per_channel:
            # One weight scale per conv filter (output channel M), quantized
            # against the (C, kH, kW) slice it scales.
            scale_w = choose_scales(np.abs(conv.weight).max(axis=(1, 2, 3)), "int8")
            w_q = quantize(conv.weight, scale_w.reshape(-1, 1, 1, 1), "int8")
            rescale = decompose_multipliers(scale_w.astype(np.float64) * cur_scale / scale_y)
        else:
            scale_w = choose_scale(float(np.abs(conv.weight).max()), "int8")
            w_q = quantize(conv.weight, scale_w, "int8")
            rescale = decompose_multiplier(scale_w * cur_scale / scale_y)
        b_q = None
        if conv.bias is not None:
            b_q = quantize_bias(conv.bias, scale_w, cur_scale)
        x = patterns.conv_layer(
            gb,
            x,
            w_q,
            b_q,
            rescale,
            prefix,
            strides=conv.strides,
            pads=conv.pads,
            two_mul=two_mul,
            activation=conv.activation,
        )
        cur_scale = scale_y
        last_shape = out_f32.shape
    if spec.head is not None:
        # Flatten NCHW → (N, C*H*W) then reuse the FC pattern.
        x = gb.op("Flatten", [x], out_hint="flat", axis=1)
        flat_dim = int(np.prod(last_shape[1:]))
        h_in = conv_outs[-1].reshape(conv_outs[-1].shape[0], -1)
        head_outs = spec.head.forward(h_in)
        for j, (wgt, b, act) in enumerate(zip(spec.head.weights, spec.head.biases, spec.head.activations)):
            o = make_observer(observer)
            o.observe(head_outs[j])
            out_dtype = "uint8" if act == "Sigmoid" else "int8"
            scale_y = choose_scale(_absmax_of(o), out_dtype)
            p = quantize_linear_layer(
                wgt, b, cur_scale, scale_y, per_channel=per_channel, in_dtype="int8", out_dtype=out_dtype
            )
            x = patterns.fc_layer(gb, x, p, f"head{j}", two_mul=two_mul, activation=act)
            cur_scale = scale_y
        gb.add_output(x, out_dtype, (None, spec.head.weights[-1].shape[1]))
    else:
        gb.add_output(x, "int8", (None,) + tuple(last_shape[1:]))
    model = gb.build()
    model.metadata.update({"source": "repro.toolchain.quantize_cnn", "input_scale": repr(scale_x), "output_scale": repr(cur_scale)})
    return model
