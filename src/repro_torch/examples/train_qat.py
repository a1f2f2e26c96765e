"""The end-to-end co-design loop on the port: QAT training → export → serve
int8 (``examples/train_qat.py`` on the H100).

Trains a reduced qwen3-family decoder with quantization-aware training (the
forward sees int8-faithful fake-quant numerics) for a few hundred steps with
checkpointing, then:
  * converts the trained params to pre-quantized W8A8 (the paper's scheme,
    per-channel scales codified as integer scale + shift) with its manifest,
  * verifies the quantized model's loss and greedy next token track the
    float model's: the loss drift must stay under 0.15.

``launch.train.train`` draws the float32 masters from a ``torch.Generator``
seeded with 0 on the training device (``repro``'s draws from
``jax.random.PRNGKey(0)``); the data pipeline is numpy's, as in ``repro``.

Run:  PYTHONPATH=src python -m repro_torch.examples.train_qat [--steps 200] [--device cpu]
"""
import argparse
import math
import tempfile

import torch

from repro_torch.configs import get_config
from repro_torch.core.compile import resolve_device
from repro_torch.core.convert import convert_params_w8a8, export_arch_quant_manifest
from repro_torch.data.pipeline import DataConfig, Pipeline
from repro_torch.examples import add_device_arg, finish
from repro_torch.kernels import launch_counts, reset_launch_counts
from repro_torch.launch.train import train
from repro_torch.models import model as M

ARCH = "qwen3_1_7b"
#: The largest |W8A8 loss − float32 loss| the exported model may show.
MAX_DRIFT = 0.15
#: The eval batch's step index in the data pipeline (past any training step).
EVAL_STEP = 10_000
CHUNK = 32  # q_chunk = kv_chunk of the eval forward passes


def export_w8a8(params):
    """The paper's §3 applied to the whole model: pre-quantized W8A8 params
    and the manifest that codifies them."""
    pq = convert_params_w8a8(params)
    return pq, export_arch_quant_manifest(pq)


@torch.no_grad()
def evaluate(params, pq, cfg, batch, seq):
    """float32 loss of ``params`` and of ``pq`` on ``batch``, and the share of
    sequences whose greedy next token after ``prefill`` agrees."""
    kw = dict(compute_dtype=torch.float32, q_chunk=CHUNK, kv_chunk=CHUNK)
    loss_f32, _ = M.loss_fn(params, batch, cfg, **kw)
    loss_int8, _ = M.loss_fn(pq, batch, cfg, **kw)
    n, device = batch["tokens"].shape[0], batch["tokens"].device
    la, _ = M.prefill(params, {"tokens": batch["tokens"]}, cfg,
                      M.init_cache(cfg, n, seq + 4, device=device), **kw)
    lb, _ = M.prefill(pq, {"tokens": batch["tokens"]}, cfg,
                      M.init_cache(cfg, n, seq + 4, device=device), **kw)
    agree = float((la.argmax(-1) == lb.argmax(-1)).float().mean())
    return float(loss_f32), float(loss_int8), agree


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    add_device_arg(ap)
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    reset_launch_counts()

    with tempfile.TemporaryDirectory() as ckpt:
        params, _, hist = train(
            ARCH,
            steps=args.steps,
            batch=args.batch,
            seq=args.seq,
            qat=True,
            schedule="wsd",
            ckpt_dir=ckpt,
            ckpt_interval=50,
            log_every=20,
            device=device,
        )
    print(f"[qat] loss {hist[0]:.3f} -> {hist[-1]:.3f} over {len(hist)} steps")

    cfg = get_config(ARCH, reduced=True)
    pipe = Pipeline(cfg, DataConfig(seed=123))
    batch = {k: torch.from_numpy(v).to(device)
             for k, v in pipe.batch(EVAL_STEP, args.batch, args.seq).items()}

    # -- export to pre-quantized W8A8 (paper §3 applied to the whole model) ---
    pq, manifest = export_w8a8(params)
    print(f"[export] {len(manifest['tensors'])} tensors pre-quantized, e.g.:")
    for t in manifest["tensors"][:3]:
        print("   ", t)
    loss_f32, loss_int8, agree = evaluate(params, pq, cfg, batch, args.seq)
    drift = abs(loss_int8 - loss_f32)
    print(f"[eval] loss f32={loss_f32:.4f}  W8A8={loss_int8:.4f}  Δ={drift:.4f}")
    print(f"[serve] greedy next-token agreement f32 vs W8A8: {agree:.2%}")
    finite = all(math.isfinite(v) for v in hist + [loss_f32, loss_int8])
    assert finite, "a non-finite loss"
    assert drift < MAX_DRIFT, "QAT export drifted"
    print("co-design loop closed: train (QAT) -> export pre-quantized -> serve ✓")
    return finish({
        "example": "train_qat", "device": str(device), "steps": len(hist),
        "loss_first": hist[0], "loss_last": hist[-1], "loss_delta": hist[-1] - hist[0],
        "losses_finite": finite, "loss_f32": loss_f32, "loss_w8a8": loss_int8,
        "drift": drift, "drift_ok": drift < MAX_DRIFT, "agreement": agree,
        "manifest_tensors": len(manifest["tensors"]), "launches": launch_counts(),
    })


if __name__ == "__main__":
    main()
