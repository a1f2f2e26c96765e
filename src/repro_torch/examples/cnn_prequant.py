"""The paper's §5 CNN example on the port: ConvInteger patterns + int8 head
(Fig 3/4; ``examples/cnn_prequant.py`` on the H100).

Trains a tiny fp32 CNN on a synthetic 8×8 shape-classification task (pure
numpy SGD — the quantizer side needs no accelerator), quantizes it into a
pre-quantized artifact, per tensor and per channel, and compares fp32 vs
int8 accuracy under the reference runtime and the compiled backend.

The compiled backend is the port's default, ``cuda`` (``repro``'s
``compile_model`` defaults to its ``ref`` oracle): the fused conv runs as
im2col onto the qmatmul kernel.  The stride-2 conv pads by 1 and takes the
**int8** input codes, so the padded value is 0 in every backend; the
uint8-padding difference of ``repro``'s Pallas conv does not arise here.

Run:  PYTHONPATH=src python -m repro_torch.examples.cnn_prequant [--device cpu]
"""
import argparse

import numpy as np

from repro_torch.core import quant
from repro_torch.core.compile import compile_model, resolve_device
from repro_torch.core.runtime import ReferenceRuntime, _conv2d_f32
from repro_torch.core.toolchain import CNNSpec, ConvLayerSpec, MLPSpec, quantize_cnn
from repro_torch.examples import add_device_arg, finish
from repro_torch.kernels import launch_counts, reset_launch_counts

CONV_ATTRS = {"strides": (2, 2), "pads": (1, 1, 1, 1)}


def make_data(rng, n):
    """Three classes: horizontal bar, vertical bar, blob."""
    x = rng.normal(size=(n, 1, 8, 8)).astype(np.float32) * 0.3
    y = rng.integers(0, 3, n)
    for i, cls in enumerate(y):
        if cls == 0:
            x[i, 0, 3:5, :] += 2.0
        elif cls == 1:
            x[i, 0, :, 3:5] += 2.0
        else:
            x[i, 0, 2:6, 2:6] += 1.5
    return x, y


def forward_f32(x, convw, convb, fcw, fcb):
    h = _conv2d_f32(x, convw, CONV_ATTRS) + convb.reshape(1, -1, 1, 1)
    h = np.maximum(h, 0)
    h = h.reshape(h.shape[0], -1)
    return h @ fcw + fcb


def train_spec(rng, xtr, ytr):
    """numpy SGD on the FC head over fixed conv filters; returns the float
    CNN as a spec."""
    convw = rng.normal(size=(8, 1, 3, 3)).astype(np.float32) * 0.5
    convb = np.zeros(8, np.float32)

    def feat(x):
        h = _conv2d_f32(x, convw, CONV_ATTRS) + convb.reshape(1, -1, 1, 1)
        return np.maximum(h, 0).reshape(x.shape[0], -1)

    fdim = feat(xtr[:1]).shape[1]
    fcw = rng.normal(size=(fdim, 3)).astype(np.float32) * 0.05
    fcb = np.zeros(3, np.float32)
    lr = 0.05
    f = feat(xtr)  # the conv filters are fixed: the features are too
    for _ in range(30):
        logits = f @ fcw + fcb
        p = np.exp(logits - logits.max(-1, keepdims=True))
        p /= p.sum(-1, keepdims=True)
        g = p.copy()
        g[np.arange(len(ytr)), ytr] -= 1
        g /= len(ytr)
        fcw -= lr * f.T @ g
        fcb -= lr * g.sum(0)
    return CNNSpec(
        convs=[ConvLayerSpec(convw, convb, strides=(2, 2), pads=(1, 1, 1, 1), activation="Relu")],
        head=MLPSpec(weights=[fcw], biases=[fcb], activations=[None]),
    )


def run_variant(model, xte, device):
    """Quantize the test set with the artifact's input scale, run it through
    the reference runtime and the compiled backend; returns the compiled
    model and both int8 outputs on the host."""
    xq = quant.quantize(xte, float(model.metadata["input_scale"]), "int8")
    (yq_ref,) = ReferenceRuntime(model).run({"input_q": xq}).values()
    cm = compile_model(model, device=device)
    (yq,) = cm.run({"input_q": xq}).values()
    return cm, yq_ref, yq.cpu().numpy()


def main(argv=None):
    ap = argparse.ArgumentParser()
    add_device_arg(ap)
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    reset_launch_counts()
    rng = np.random.default_rng(0)
    xtr, ytr = make_data(rng, 2048)
    xte, yte = make_data(rng, 512)

    # -- tiny fp32 training ---------------------------------------------------
    spec = train_spec(rng, xtr, ytr)
    (conv,), (fcw,), (fcb,) = spec.convs, spec.head.weights, spec.head.biases
    acc_f32 = float((forward_f32(xte, conv.weight, conv.bias, fcw, fcb).argmax(-1) == yte).mean())
    print(f"fp32 test accuracy: {acc_f32:.3f}")

    # -- quantize into the §5 artifact ----------------------------------------
    model = quantize_cnn(spec, xtr[:256], observer="percentile", name="cnn_prequant")
    model.validate(standard_ops_only=True)
    ops = [n.op_type for n in model.graph.toposorted()]
    print(f"artifact ops: {ops}")

    cm, yq_ref, yq_card = run_variant(model, xte, device)
    acc_ref = float((yq_ref.astype(np.float32).argmax(-1) == yte).mean())
    print(f"compiler fusion report: {cm.stats}")
    per_tensor_equal = bool(np.array_equal(yq_ref, yq_card)) and yq_ref.dtype == yq_card.dtype
    assert per_tensor_equal
    print(f"reference runtime ≡ compiled backend on {device}: BIT-EXACT ✓")
    print(f"int8 test accuracy: {acc_ref:.3f} (fp32 {acc_f32:.3f}, "
          f"Δ {abs(acc_f32 - acc_ref):.3f})")

    # -- per-channel variant: one weight scale + §3.1 rescale per filter ------
    model_pc = quantize_cnn(spec, xtr[:256], observer="percentile",
                            per_channel=True, name="cnn_prequant_pc")
    model_pc.validate(standard_ops_only=True)
    cm_pc, yq_pc_ref, yq_pc = run_variant(model_pc, xte, device)
    assert cm_pc.stats["fused_qconv"] == 1 and cm_pc.stats["fused_qlinear"] == 1
    per_channel_equal = bool(np.array_equal(yq_pc_ref, yq_pc)) and yq_pc.dtype == yq_pc_ref.dtype
    assert per_channel_equal
    acc_pc = float((yq_pc.astype(np.float32).argmax(-1) == yte).mean())
    print(f"per-channel artifact: fused + BIT-EXACT ✓ "
          f"(int8 per-channel accuracy: {acc_pc:.3f})")

    return finish({
        "example": "cnn_prequant", "device": str(device),
        "per_tensor_equal": per_tensor_equal, "per_channel_equal": per_channel_equal,
        "stats": dict(cm.stats), "stats_per_channel": dict(cm_pc.stats),
        "acc_f32": acc_f32, "acc_int8": acc_ref, "acc_int8_per_channel": acc_pc,
        "launches": launch_counts(),
    })


if __name__ == "__main__":
    main()
