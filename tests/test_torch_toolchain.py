"""The port's quantizer-side toolchain against the JAX package's, on the CPU.

``repro_torch.core.toolchain`` (with ``calibrate`` and ``export``) is a copy
of ``repro.core.toolchain``: from the same float spec and the same
numpy-seeded calibration data, ``quantize_mlp`` / ``quantize_cnn`` must emit
the identical PQ-IR JSON — every node, attribute, scale and weight — and an
artifact ``repro`` saved must load into the port unchanged.

Tolerance: 0.  The artifacts are compared as JSON documents, exactly.
"""
import json

import numpy as np
import pytest

from repro.core import export as jexport
from repro.core import toolchain as jtc
from repro.core.runtime import ReferenceRuntime as JRuntime
from repro_torch.core import export, toolchain
from repro_torch.core.pqir import Model
from repro_torch.core.runtime import ReferenceRuntime


def _mlp(pkg, rng, acts, widths=(12, 24, 16, 6)):
    return pkg.MLPSpec(
        weights=[rng.normal(size=(a, b)).astype(np.float32) * 0.3 for a, b in zip(widths, widths[1:])],
        biases=[rng.normal(size=(b,)).astype(np.float32) * 0.1 for b in widths[1:]],
        activations=list(acts),
    )


# (activations, quantize_mlp options): Relu, Tanh int8 (Fig 4), Tanh fp16
# (Fig 5), Sigmoid (Fig 6), per-channel, the w4 lane, another observer
MLP_CASES = [
    (("Relu", "Relu", None), {}),
    (("Tanh", "Sigmoid", None), {"tanh_mode": "int8"}),
    (("Tanh", "Sigmoid", None), {"tanh_mode": "fp16", "per_channel": True}),
    (("Sigmoid", "Tanh", "Relu"), {"tanh_mode": "fp16", "two_mul": False}),
    (("Relu", None, None), {"weight_bits": 4, "per_channel": True}),
    (("Tanh", "Relu", None), {"observer": "percentile"}),
]


@pytest.mark.parametrize("acts,opts", MLP_CASES)
def test_quantize_mlp_emits_repro_json(acts, opts):
    seed = 7 + MLP_CASES.index((acts, opts))
    rng = np.random.default_rng(seed)
    calib = rng.normal(size=(64, 12)).astype(np.float32)
    want = jtc.quantize_mlp(_mlp(jtc, np.random.default_rng(seed), acts), calib, **opts)
    got = toolchain.quantize_mlp(_mlp(toolchain, np.random.default_rng(seed), acts), calib, **opts)
    assert json.dumps(got.to_json(), sort_keys=True) == json.dumps(want.to_json(), sort_keys=True)


def _cnn(pkg, rng, head: bool):
    convs = [
        pkg.ConvLayerSpec(rng.normal(size=(4, 3, 3, 3)).astype(np.float32) * 0.3,
                          rng.normal(size=(4,)).astype(np.float32) * 0.1,
                          strides=(2, 2), pads=(1, 1, 1, 1), activation="Relu"),
        pkg.ConvLayerSpec(rng.normal(size=(6, 4, 3, 3)).astype(np.float32) * 0.3, None,
                          strides=(1, 1), pads=(0, 0, 0, 0), activation=None),
    ]
    spec_head = None
    if head:
        spec_head = pkg.MLPSpec([rng.normal(size=(6 * 2 * 2, 5)).astype(np.float32) * 0.2],
                                [rng.normal(size=(5,)).astype(np.float32) * 0.1], [None])
    return pkg.CNNSpec(convs, spec_head)


@pytest.mark.parametrize("head,per_channel", [(True, True), (True, False), (False, True)])
def test_quantize_cnn_emits_repro_json(head, per_channel):
    calib = np.random.default_rng(3).normal(size=(4, 3, 8, 8)).astype(np.float32)
    want = jtc.quantize_cnn(_cnn(jtc, np.random.default_rng(5), head), calib, per_channel=per_channel)
    got = toolchain.quantize_cnn(_cnn(toolchain, np.random.default_rng(5), head), calib,
                                 per_channel=per_channel)
    assert json.dumps(got.to_json(), sort_keys=True) == json.dumps(want.to_json(), sort_keys=True)


def test_export_linear_stack_emits_repro_json():
    rng = np.random.default_rng(11)
    ws = [rng.normal(size=(8, 10)).astype(np.float32), rng.normal(size=(10, 4)).astype(np.float32)]
    bs = [None, rng.normal(size=(4,)).astype(np.float32)]
    calib = rng.normal(size=(32, 8)).astype(np.float32)
    want = jexport.export_linear_stack(ws, bs, ["Tanh", None], calib, tanh_mode="fp16")
    got = export.export_linear_stack(ws, bs, ["Tanh", None], calib, tanh_mode="fp16")
    assert got.to_json() == want.to_json()
    assert export.export_quant_report(got) == jexport.export_quant_report(want)


def test_repro_saved_artifact_loads_in_the_port(tmp_path):
    rng = np.random.default_rng(13)
    calib = rng.normal(size=(64, 12)).astype(np.float32)
    model = jtc.quantize_mlp(_mlp(jtc, rng, ("Tanh", "Sigmoid", None)), calib,
                             tanh_mode="fp16", per_channel=True)
    path = tmp_path / "mlp.pqir.json"
    model.save(str(path))
    port = Model.load(str(path))
    assert port.to_json() == model.to_json()
    x = rng.integers(-128, 128, (5, 12)).astype(np.int8)
    want = JRuntime(model).run({"input_q": x})
    got = ReferenceRuntime(port).run({"input_q": x})
    for k, v in want.items():
        np.testing.assert_array_equal(got[k], v)
