"""Training launcher.

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3_1_7b --steps 50 \\
        --batch 8 --seq 256 [--full] [--qat] [--ckpt-dir /tmp/ckpt] [--schedule wsd] \\
        [--device cpu]

Trains on the CUDA card unless ``--device`` names another device, or over
the ranks of a ``torch.distributed`` device mesh (``train(mesh=)``, each
rank running this function: params, moments and batches laid out as
DTensors by ``launch.specs``'s logical shardings): the same step as
``repro.launch.train`` (seeded synthetic data, ``loss_fn``, gradients,
optional QAT, AdamW with a schedule, microbatch accumulation, the config's
remat policy) and ``repro``'s checkpoints with resume, so a ``repro``
checkpoint resumes here.  Eager and float32 by
default; TF32 stays as the caller set it.
"""
from __future__ import annotations

import argparse
from typing import Optional

import torch

from ..configs import get_config
from ..configs.base import ShapeConfig
from ..core.compile import resolve_device
from ..data.pipeline import DataConfig, Pipeline
from ..distributed.fault_tolerance import CheckpointManager, CheckpointManagerConfig, StragglerMonitor
from ..distributed import sharding as shlib
from ..distributed.sharding import DeviceMesh, DTensor, use_mesh
from ..models import model as M
from ..optim import adamw
from . import specs as specs_lib
from . import steps as steps_lib


def _full(t: torch.Tensor) -> torch.Tensor:
    """A metric as a plain tensor: a DTensor's whole value."""
    return t.full_tensor() if isinstance(t, DTensor) else t


def train(
    arch: str,
    *,
    steps: int = 20,
    batch: int = 8,
    seq: int = 128,
    microbatches: int = 1,
    reduced: bool = True,
    qat: bool = False,
    schedule: str = "warmup_cosine",
    ckpt_dir: Optional[str] = None,
    ckpt_interval: int = 50,
    mesh=None,
    compute_dtype=torch.float32,
    seed: int = 0,
    log_every: int = 5,
    resume: bool = True,
    device=None,
    on_step=None,
):
    """Train ``arch`` for ``steps`` steps on ``device`` (``None``: the card)
    or, with ``mesh`` (a ``DeviceMesh``; ``device`` is then the mesh's), on
    this rank's shards of it; returns ``(params, opt_state, losses)``.
    ``on_step(step, metrics)``, when given, is called after each step with
    its metrics (plain tensors) and ``step_time_s``: the host clock from the
    batch's creation to the step's loss on the host."""
    if mesh is not None and not isinstance(mesh, DeviceMesh):
        raise TypeError(f"train(mesh=) takes a torch DeviceMesh, not {type(mesh).__name__}")
    cfg = get_config(arch, reduced=reduced)
    sc = ShapeConfig("custom", "train", seq, batch, microbatches=microbatches)
    pipe = Pipeline(cfg, DataConfig(seed=seed))
    step_fn = steps_lib.make_train_step(
        cfg, sc, compute_dtype=compute_dtype, sched=schedule, qat=qat,
        sched_kwargs=dict(peak_lr=1e-3, warmup_steps=max(2, steps // 10), total_steps=steps),
        q_chunk=min(seq, 512), kv_chunk=min(seq, 512),
    )
    manager = None
    if ckpt_dir:
        manager = CheckpointManager(CheckpointManagerConfig(ckpt_dir, interval_steps=ckpt_interval))
    monitor = StragglerMonitor()

    with use_mesh(mesh):
        dev = resolve_device(device if mesh is None else mesh.device_type)
        params = M.init_params(torch.Generator(device=dev).manual_seed(seed), cfg, device=dev)
        if mesh is not None:  # every rank drew the same values: each keeps its shard
            params = shlib.distribute(params, specs_lib.params_shardings(params, mesh))
        opt = adamw.init(params)
        start = 0
        if manager and resume and manager.has_checkpoint():
            (params, opt), start, _ = manager.restore((params, opt))
            start += 1
            print(f"[train] resumed from step {start - 1}")
        history = []
        for step in range(start, steps):
            monitor.start_step()
            data = {k: torch.from_numpy(v).to(dev) for k, v in pipe.batch(step, batch, seq).items()}
            if mesh is not None:
                data = shlib.distribute(data, specs_lib.batch_shardings(data, mesh))
            params, opt, metrics = step_fn(params, opt, data)
            metrics = {k: _full(v) for k, v in metrics.items()}
            loss = float(metrics["loss"])  # waits for the step
            mm = monitor.end_step(step)
            history.append(loss)
            if on_step is not None:
                on_step(step, {**metrics, "step_time_s": mm["step_time_s"]})
            if step % log_every == 0 or step == steps - 1:
                print(
                    f"[train] {arch} step {step:4d} loss {loss:.4f} "
                    f"gnorm {float(metrics['grad_norm']):.3f} lr {float(metrics['lr']):.2e} "
                    f"dt {mm['step_time_s']:.2f}s",
                    flush=True,
                )
            if manager:
                manager.maybe_save(step, (params, opt))
                if manager.preempted:
                    break
    return params, opt, history


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--full", action="store_true", help="full (non-reduced) config")
    ap.add_argument("--qat", action="store_true")
    ap.add_argument("--schedule", default="warmup_cosine", choices=["warmup_cosine", "wsd"])
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None, help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)
    train(
        args.arch, steps=args.steps, batch=args.batch, seq=args.seq,
        microbatches=args.microbatches, reduced=not args.full, qat=args.qat,
        schedule=args.schedule, ckpt_dir=args.ckpt_dir, seed=args.seed, device=args.device,
    )


if __name__ == "__main__":
    main()
