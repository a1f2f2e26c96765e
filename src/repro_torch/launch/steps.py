"""Train / prefill / decode step builders (shared by the launchers), as in
``repro.launch.steps``.

train_step: gradient accumulation over microbatches (bounds activation
memory), remat per config, AdamW + schedule, optional QAT (fake-quant
forward).  Eager: a step is a Python function over tensors, its gradients
from ``torch.autograd.grad`` where ``repro`` takes ``jax.value_and_grad``.
"""
from __future__ import annotations

import functools
from typing import Dict, Optional

import torch
from torch.distributed.tensor import DTensor, Replicate

from ..checkpoint.ckpt import tree_leaves, tree_unflatten
from ..configs.base import ModelConfig, ShapeConfig
from ..core import qat as qatlib
from ..models import model as M
from ..optim import adamw, schedule as schedlib


def _qat_params(params: dict, enabled: bool):
    """Every float leaf of two or more dims fake-quantized per output
    channel, except a router (the last dict key ``"router"``, as ``repro``
    names its path; a sequence index is no key)."""
    if not enabled:
        return params

    def maybe_fq(path, leaf):
        if (leaf.ndim >= 2 and (not path or path[-1] != "router")
                and leaf.dtype in (torch.float32, torch.bfloat16)):
            return qatlib.fake_quant_weight_per_channel(leaf)
        return leaf

    return M.tree_map(maybe_fq, params)


def _value_and_grad(loss):
    """``loss(params, mb) -> (l, aux)`` and its gradients with respect to
    every leaf of ``params``: ``(l, aux), grads`` (a leaf the loss does not
    reach gets zeros, as ``jax.value_and_grad`` gives)."""

    def grad_fn(params, mb):
        leaves = [p.detach().requires_grad_() for p in tree_leaves(params)]
        with torch.enable_grad():
            l, aux = loss(tree_unflatten(params, iter(leaves)), mb)
            grads = torch.autograd.grad(l, leaves, allow_unused=True, materialize_grads=True)
        return (l.detach(), {k: v.detach() for k, v in aux.items()}), list(grads)

    return grad_fn


def _microbatch(batch: Dict, n: int, i: int) -> Dict:
    """Microbatch ``i`` of ``n``: rows ``i·B/n .. (i+1)·B/n`` of every array.
    A DTensor keeps its layout: its rows are sliced whole and laid out as
    the batch was, as ``repro``'s scan over microbatches keeps the batch
    axis sharded.  DTensor's own row slice of a row-sharded batch comes
    out replicated under torch 2.13 and takes the wrong rows under 2.11."""
    if n == 1:
        return batch

    def rows(x):
        b = x.shape[0] // n
        if not isinstance(x, DTensor):
            return x[i * b:(i + 1) * b]
        whole = x.redistribute(x.device_mesh, [Replicate()] * x.device_mesh.ndim)
        return whole[i * b:(i + 1) * b].redistribute(x.device_mesh, x.placements)

    return {k: rows(v) for k, v in batch.items()}


def make_train_step(
    cfg: ModelConfig,
    sc: ShapeConfig,
    *,
    compute_dtype=torch.bfloat16,
    adamw_cfg: adamw.AdamWConfig = adamw.AdamWConfig(),
    sched: str = "warmup_cosine",
    sched_kwargs: Optional[dict] = None,
    qat: bool = False,
    q_chunk: int = 1024,
    kv_chunk: int = 1024,
):
    """``train_step(params, opt_state, batch) -> (params, opt_state,
    metrics)``.  The new params and moments are written into the tensors
    given, which come back (``repro``'s launcher donates them to its jitted
    step), so a step at full width holds one copy of each."""
    skw = sched_kwargs or dict(peak_lr=3e-4, warmup_steps=100, total_steps=10_000)
    if sched == "wsd" and "stable_steps" not in skw:
        skw = dict(peak_lr=skw.get("peak_lr", 3e-4), warmup_steps=100, stable_steps=8_000, decay_steps=1_900)
    sched_fn = functools.partial(schedlib.SCHEDULES[sched], **skw)
    n_micro = max(1, sc.microbatches)

    def loss(params, mb):
        p = _qat_params(params, qat)
        return M.loss_fn(p, mb, cfg, compute_dtype=compute_dtype, q_chunk=q_chunk, kv_chunk=kv_chunk)

    grad_fn = _value_and_grad(loss)

    def train_step(params, opt_state, batch: Dict):
        # float32 sums over the microbatches, as repro's lax.scan carries
        # them; the first microbatch's gradients start the sums (0 + g == g)
        gsum, lsum = None, None
        for i in range(n_micro):
            (l, _), g = grad_fn(params, _microbatch(batch, n_micro, i))
            if gsum is None:
                gsum, lsum = [a.to(torch.float32) for a in g], l
            else:
                gsum = [a.add_(b.to(torch.float32)) for a, b in zip(gsum, g)]
                lsum = lsum + l
            del g
        n = lsum.new_full((), float(n_micro))
        grads = tree_unflatten(params, iter([a.div_(n) for a in gsum]))
        del gsum
        lr = sched_fn(opt_state["step"])
        new_params, new_opt, om = adamw.update(grads, opt_state, params, lr, adamw_cfg, inplace=True)
        metrics = {"loss": lsum / n, **om}
        return new_params, new_opt, metrics

    return train_step


def make_grad_step(
    cfg: ModelConfig,
    sc: ShapeConfig,
    *,
    compute_dtype=torch.bfloat16,
    qat: bool = False,
    q_chunk: int = 1024,
    kv_chunk: int = 1024,
):
    """loss+grad only (no optimizer, no microbatches): ``grad_step(params,
    batch) -> (loss, grads)``, the grads in ``params``' tree; ``qat`` as in
    :func:`make_train_step` (``repro``'s grad step has no QAT)."""

    def loss(params, mb):
        p = _qat_params(params, qat)
        return M.loss_fn(p, mb, cfg, compute_dtype=compute_dtype, q_chunk=q_chunk, kv_chunk=kv_chunk)

    grad_fn = _value_and_grad(loss)

    def grad_step(params, batch):
        (l, _), g = grad_fn(params, batch)
        return l, tree_unflatten(params, iter(g))

    return grad_step


def make_prefill_step(cfg: ModelConfig, *, compute_dtype=torch.bfloat16, q_chunk: int = 1024, kv_chunk: int = 1024):
    def prefill_step(params, batch, cache):
        return M.prefill(params, batch, cfg, cache, compute_dtype=compute_dtype, q_chunk=q_chunk, kv_chunk=kv_chunk)

    return prefill_step


def make_decode_step(cfg: ModelConfig, *, compute_dtype=torch.bfloat16):
    def decode_step(params, tokens, pos, cache):
        return M.decode_step(params, tokens, pos, cache, cfg, compute_dtype=compute_dtype)

    return decode_step
