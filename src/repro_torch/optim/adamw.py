"""AdamW with decoupled weight decay over parameter trees, as in
``repro.optim.adamw`` (float32 moments shaped like the params).

:func:`update` is ``repro``'s functional step; ``inplace=True`` writes the
new params and moments into the tensors it was given, leaf by leaf, so a
step at full width holds no second copy of params and moments.  Both forms
run one in-place body, the functional one on copies.  Leaves are visited in
JAX's pytree order (dict keys sorted), so :func:`global_norm` sums the
leaves in ``repro``'s order.
Every division goes by a device tensor (CUDA divides by a host scalar as a
multiply by its reciprocal).

On a mesh the params, gradients and moments are DTensors, while ``step``
(unsharded, as ``repro`` keeps it), the bias corrections and ``lr`` stay
plain tensors: the update runs inside ``sharding.use_mesh``, whose
``implicit_replication`` takes each as the same value on every rank.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from ..checkpoint.ckpt import tree_leaves, tree_unflatten


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip_norm: Optional[float] = 1.0


def init(params) -> dict:
    leaves = tree_leaves(params)

    def zeros():
        return tree_unflatten(params, iter([torch.zeros_like(p, dtype=torch.float32) for p in leaves]))

    return {"m": zeros(), "v": zeros(),
            "step": torch.zeros((), dtype=torch.int32, device=leaves[0].device)}


def global_norm(tree) -> torch.Tensor:
    total = 0
    for leaf in tree_leaves(tree):
        total = total + torch.sum(torch.square(leaf.to(torch.float32)))
    return torch.sqrt(total)


@torch.no_grad()
def update(grads, state: dict, params, lr: torch.Tensor, cfg: AdamWConfig = AdamWConfig(), *,
           inplace: bool = False):
    """Returns (new_params, new_state, metrics).  With ``inplace`` the new
    values are written into ``params`` and ``state``'s moments, and those
    trees come back."""
    gnorm = global_norm(grads)
    scale = None
    if cfg.grad_clip_norm is not None:
        scale = torch.clamp_max(_const(gnorm, cfg.grad_clip_norm) / torch.clamp_min(gnorm, 1e-9), 1.0)
    step = state["step"] + 1
    b1, b2 = cfg.b1, cfg.b2
    bc1 = 1.0 - torch.pow(b1, step.to(torch.float32))
    bc2 = 1.0 - torch.pow(b2, step.to(torch.float32))

    def upd_(p, g, m, v):
        """One leaf's step, written into ``p``, ``m`` and ``v`` with at most
        three leaf-sized temporaries alive: at rwkv6_3b's full width (a
        2.73 GiB leaf) that decides whether a training step fits one card."""
        if scale is not None:
            g = g * scale
        g = g.to(torch.float32)
        m.mul_(b1).add_((1 - b1) * g)
        v.mul_(b2).add_((1 - b2) * g * g)
        del g
        den = (v / bc2).sqrt_().add_(cfg.eps)
        delta = (m / bc1).div_(den)
        del den
        delta.add_(cfg.weight_decay * p.to(torch.float32))
        p.copy_((p.to(torch.float32) - lr * delta).to(p.dtype))

    flat = zip(tree_leaves(params), tree_leaves(grads), tree_leaves(state["m"]), tree_leaves(state["v"]))
    if inplace:
        for p, g, m, v in flat:
            upd_(p, g, m, v)
        state["step"] = step
        return params, state, {"grad_norm": gnorm, "lr": lr}
    out = []
    for p, g, m, v in flat:
        p, m, v = p.clone(), m.clone(), v.clone()
        upd_(p, g, m, v)
        out.append((p, m, v))
    new_params = tree_unflatten(params, iter([o[0] for o in out]))
    new_state = {
        "m": tree_unflatten(params, iter([o[1] for o in out])),
        "v": tree_unflatten(params, iter([o[2] for o in out])),
        "step": step,
    }
    return new_params, new_state, {"grad_norm": gnorm, "lr": lr}


def _const(like: torch.Tensor, value: float) -> torch.Tensor:
    return like.new_full((), float(value))
