"""AdamW with decoupled weight decay over parameter trees, as in
``repro.optim.adamw`` (float32 moments shaped like the params).

:func:`update` is ``repro``'s functional step; ``inplace=True`` writes the
new params and moments into the tensors it was given, leaf by leaf, so a
step at full width holds no second copy of params and moments.  Both forms
run the same operations.  Leaves are visited in JAX's pytree order (dict
keys sorted), so :func:`global_norm` sums the leaves in ``repro``'s order.
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

    def upd(p, g, m, v):
        if scale is not None:
            g = g * scale
        g = g.to(torch.float32)
        m_new = b1 * m + (1 - b1) * g
        v_new = b2 * v + (1 - b2) * g * g
        mhat = m_new / bc1
        vhat = v_new / bc2
        delta = mhat / (torch.sqrt(vhat) + cfg.eps) + cfg.weight_decay * p.to(torch.float32)
        return (p.to(torch.float32) - lr * delta).to(p.dtype), m_new, v_new

    flat = zip(tree_leaves(params), tree_leaves(grads), tree_leaves(state["m"]), tree_leaves(state["v"]))
    if inplace:
        for p, g, m, v in flat:
            p_new, m_new, v_new = upd(p, g, m, v)
            p.copy_(p_new)
            m.copy_(m_new)
            v.copy_(v_new)
        state["step"] = step
        return params, state, {"grad_norm": gnorm, "lr": lr}
    out = [upd(*leaves) for leaves in flat]
    new_params = tree_unflatten(params, iter([o[0] for o in out]))
    new_state = {
        "m": tree_unflatten(params, iter([o[1] for o in out])),
        "v": tree_unflatten(params, iter([o[2] for o in out])),
        "step": step,
    }
    return new_params, new_state, {"grad_norm": gnorm, "lr": lr}


def _const(like: torch.Tensor, value: float) -> torch.Tensor:
    return like.new_full((), float(value))
