"""cnn-r18-stages: the paper's section 5 CNN flow (``ConvInteger`` + ReLU,
per-channel rescale) at ResNet-18's shapes: the 7x7/2 stem, the 3x3/2 max
pool, the first conv of each stage (conv2_1 to conv5_1, each at ResNet-18's
channels and map), the global average pool and the 512 -> 1000 FC head,
compiled batch-polymorphic and served by ``CompiledModelServer``.

The artifact is built here from pre-quantized codes drawn on the device from
the seed: int8 conv and head weight codes, int32 bias codes and one float32
multiplier per output channel, derived from the code ranges so that every
layer's output codes spread about ``target_code_std`` (times a factor in
[0.75, 1.25) drawn per channel). The examples are int8 image codes drawn on
the device too. No float weight is calibrated.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np

from harness import codes

LOOP = "server"


#: E[x²] of a pool's output codes as a share of target_code_std², where its
#: input is ReLU'd codes of that spread (E[x²] = 1/2 of it): the max of a
#: 3x3 window lies above, the mean of a map near the ReLU's mean squared.
POOL_X2 = {"max": 1.0, "avg": 0.16}


def layers(cfg):
    """Each layer in order as (kind, K, N, out side, stride, pad, kernel):
    the convs as GEMMs over im2col rows (K = C·k², N = out channels), the
    max pool after the first conv, the average pool after the last, then
    the head (K and N of its GEMM)."""
    _, side, _ = cfg["input_shape"]
    out = []
    for i, (m, c, k, st, pd) in enumerate(cfg["convs"]):
        side = (side + 2 * pd - k) // st + 1
        out.append(("conv", c * k * k, m, side, st, pd, k))
        pools = [("max", cfg["max_pool"])] if i == 0 else []
        pools += [("avg", cfg["avg_pool"])] if i == len(cfg["convs"]) - 1 else []
        for kind, (k, st, pd) in pools:
            side = (side + 2 * pd - k) // st + 1
            out.append((kind, 0, m, side, st, pd, k))
    out.append(("fc", cfg["convs"][-1][0] * side * side, cfg["classes"], 1, 1, 0, 1))
    return out


def make_inputs(cfg, seed, device):
    import torch

    a = cfg["assumed"]
    lo, hi = a["weight_codes"]
    w_std = codes.code_std(lo, hi)
    g = codes.generator(codes.derived_seeds(seed, 2)[0], device)
    # E[x²] of the codes each layer reads: the input's uniform codes, then
    # ReLU'd codes of spread target_code_std (half of a normal's second
    # moment), or a pool's output
    x2 = codes.code_std(*a["input_codes"]) ** 2
    t = a["target_code_std"]
    convs = iter(cfg["convs"])
    out = []
    for kind, k, n, *_ in layers(cfg):
        if kind in POOL_X2:
            x2 = POOL_X2[kind] * t * t
            continue
        if kind == "conv":
            m_out, c, kk, *_ = next(convs)
            shape = (m_out, c, kk, kk)
        else:
            shape = (k, n)
        w = codes.uniform_codes(g, lo, hi, shape, torch.int8, device)
        base = t / (math.sqrt(k * x2) * w_std)
        jitter = torch.rand((n,), generator=g, device=device, dtype=torch.float64).cpu().numpy()
        m = (base * (0.75 + 0.5 * jitter)).astype(np.float32)
        b_hi = max(1, round(a["bias_codes"] / float(m.min())))
        b = codes.uniform_codes(g, -b_hi, b_hi, (n,), torch.int32, device)
        pairs = [codes.rescale_pair(float(x)) for x in m]
        out.append(dict(kind=kind, w=w, b=b, multiplier=m,
                        quant_scale=np.array([p[0] for p in pairs], np.int64),
                        shift=np.array([p[1] for p in pairs], np.int64)))
        x2 = t * t / 2.0
    return dict(layers=out)


def make_examples(cfg, n, seed, device):
    """``n`` int8 image codes (n, C, H, W), drawn on the device, on the host."""
    import torch

    g = codes.generator(codes.derived_seeds(seed, 2)[1], device)
    lo, hi = cfg["assumed"]["input_codes"]
    return codes.uniform_codes(g, lo, hi, (n, *cfg["input_shape"]), torch.int8, device).cpu().numpy()


@dataclasses.dataclass
class System:
    cm: object


def build(cfg, inputs, device) -> System:
    """The program under test: the PQ-IR artifact (``conv_layer`` with ReLU
    for each conv, ``MaxPool`` after the first, ``AveragePool`` after the
    last, ``Flatten``, ``fc_layer``), ``compile_model`` on backend ``cuda``
    with a dynamic batch axis."""
    from repro_torch.core import pqir
    from repro_torch.core.compile import compile_model
    from repro_torch.core.patterns import conv_layer, fc_layer
    from repro_torch.core.quant import QuantizedLinearParams, RescaleVector

    gb = pqir.GraphBuilder("portbench_cnn")
    x = gb.add_input("input_q", "int8", (None, *cfg["input_shape"]))
    params = iter(inputs["layers"])
    for i, (kind, _, _, _, st, pd, k) in enumerate(layers(cfg)):
        if kind in POOL_X2:
            op = {"max": "MaxPool", "avg": "AveragePool"}[kind]
            x = gb.op(op, [x], out_hint=f"{kind}pool", kernel_shape=(k, k), strides=(st, st), pads=(pd,) * 4)
            continue
        p = next(params)
        rescale = RescaleVector(p["quant_scale"], p["shift"], p["multiplier"])
        w, b = p["w"].cpu().numpy(), p["b"].cpu().numpy()
        if kind == "conv":
            x = conv_layer(gb, x, w, b, rescale, f"conv{i}", strides=(st, st), pads=(pd,) * 4,
                           two_mul=False, activation="Relu")
            continue
        x = gb.op("Flatten", [x], out_hint="flat", axis=1)
        head = QuantizedLinearParams(weight_q=w, bias_q=b, scale_x=1.0, scale_w=p["multiplier"],
                                     scale_y=1.0, rescale=rescale)
        x = fc_layer(gb, x, head, "head", two_mul=False)
    gb.add_output(x, "int8", (None, cfg["classes"]))
    return System(cm=compile_model(gb.build(), backend="cuda", device=device, batch="dynamic"))
