"""Quickstart on the port: the paper's §4 MLP, end to end
(``examples/quickstart.py`` on the H100).

1. Build a float MLP and calibration data (the "researcher" side).
2. Quantize + codify it as a pre-quantized ONNX-dialect artifact
   (Figs 1/2 patterns; §3.1 integer scale + right-shift rescaling).
3. Execute the artifact with the standard-tool reference runtime (numpy).
4. Compile the SAME artifact for the card (``backend="cuda"``: pattern-fused
   steps on the hand-written qmatmul kernel) — outputs must match
   BIT-EXACTLY.
5. Save/reload the artifact (goal 1: everything is embedded).

Run:  PYTHONPATH=src python -m repro_torch.examples.quickstart [--device cpu]
"""
import argparse
import os
import tempfile

import numpy as np

from repro_torch.core import quant
from repro_torch.core.compile import compile_model, resolve_device
from repro_torch.core.export import export_quant_report
from repro_torch.core.pqir import Model
from repro_torch.core.runtime import ReferenceRuntime
from repro_torch.core.toolchain import MLPSpec, quantize_mlp
from repro_torch.examples import add_device_arg, finish
from repro_torch.kernels import launch_counts, reset_launch_counts


def make_spec(rng):
    """The float model and its calibration batch (the quantizer side knows
    nothing about hardware)."""
    spec = MLPSpec(
        weights=[
            rng.normal(size=(64, 128)).astype(np.float32) * 0.2,
            rng.normal(size=(128, 128)).astype(np.float32) * 0.15,
            rng.normal(size=(128, 10)).astype(np.float32) * 0.2,
        ],
        biases=[
            rng.normal(size=(128,)).astype(np.float32) * 0.1,
            rng.normal(size=(128,)).astype(np.float32) * 0.1,
            rng.normal(size=(10,)).astype(np.float32) * 0.1,
        ],
        activations=["Relu", "Relu", None],
    )
    calib = rng.normal(size=(512, 64)).astype(np.float32)
    return spec, calib


def quantize(spec, calib) -> Model:
    model = quantize_mlp(spec, calib, observer="percentile", name="quickstart_mlp")
    model.validate(standard_ops_only=True)  # paper goal 3
    return model


def run_compiled(model, xq, device):
    """Compile for ``device`` through the pass pipeline (its reference-runtime
    conformance hook on) and run ``xq``; returns the compiled model and its
    int8 codes on the host."""
    cm = compile_model(model, backend="cuda", device=device, verify_passes=True)
    (yq,) = cm.run({"input_q": xq}).values()
    return cm, yq.cpu().numpy()


def main(argv=None):
    ap = argparse.ArgumentParser()
    add_device_arg(ap)
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    reset_launch_counts()
    rng = np.random.default_rng(0)

    # -- 1. the float model --------------------------------------------------
    spec, calib = make_spec(rng)

    # -- 2. quantize + codify ------------------------------------------------
    model = quantize(spec, calib)
    print(f"artifact: {len(model.graph.nodes)} standard ONNX ops, "
          f"{len(model.graph.initializers)} embedded initializers")
    for layer in export_quant_report(model)["layers"]:
        print("  ", layer)

    # -- 3. run with the 'standard tool' (reference runtime) ------------------
    # the scales are the artifact's own float reprs
    s_in = float(model.metadata["input_scale"])
    s_out = float(model.metadata["output_scale"])
    x = rng.normal(size=(16, 64)).astype(np.float32)
    xq = quant.quantize(x, s_in, "int8")
    (yq_ref,) = ReferenceRuntime(model).run({"input_q": xq}).values()

    # -- 4. compile for the card (fused int8 kernels) and compare ------------
    cm, yq_card = run_compiled(model, xq, device)
    print(f"optimization pipeline: {cm.pass_report.summary()}")
    print(f"compiler fusion report: {cm.stats}")
    # the typed ExecutionPlan — what a hardware designer reads: buffer slots,
    # kernel ids, compile-time tile choices (bm, K splits), pre-padded
    # parameter shapes
    print(cm.plan)
    eliminated = cm.pass_report.total("eliminated")
    assert eliminated >= 1, "canonicalization eliminated nothing"
    codes_equal = bool(np.array_equal(yq_ref, yq_card)) and yq_card.dtype == yq_ref.dtype
    assert codes_equal, "conformance violation!"
    print(f"reference runtime ≡ compiled backend on {device}: BIT-EXACT ✓")

    # accuracy vs float
    h = np.maximum(x @ spec.weights[0] + spec.biases[0], 0)
    h = np.maximum(h @ spec.weights[1] + spec.biases[1], 0)
    y_f32 = h @ spec.weights[2] + spec.biases[2]
    y_int8 = yq_ref.astype(np.float32) * s_out
    rel = float(np.abs(y_int8 - y_f32).max() / np.abs(y_f32).max())
    print(f"int8 vs fp32 relative error: {rel:.4f}")
    agree = float((y_int8.argmax(-1) == y_f32.argmax(-1)).mean())
    print(f"argmax agreement: {agree:.2%}")

    # -- 5. serialization round trip ------------------------------------------
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "model.pqir.json")
        model.save(path)
        model2 = Model.load(path)
        (yq2,) = ReferenceRuntime(model2).run({"input_q": xq}).values()
        round_trip_equal = bool(np.array_equal(yq_ref, yq2))
        assert round_trip_equal
        nbytes = os.path.getsize(path)
        print(f"artifact round-trip via {os.path.basename(path)}: BIT-EXACT ✓ "
              f"({nbytes} bytes, fully self-contained)")

    return finish({
        "example": "quickstart", "device": str(device), "codes_equal": codes_equal,
        "eliminated": eliminated, "stats": dict(cm.stats), "rel_err_vs_f32": rel,
        "argmax_agreement": agree, "round_trip_equal": round_trip_equal,
        "artifact_bytes": nbytes, "launches": launch_counts(),
    })


if __name__ == "__main__":
    main()
