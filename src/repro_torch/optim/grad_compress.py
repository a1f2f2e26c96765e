"""int8 gradient compression with error feedback for the cross-pod
all-reduce — the paper's symmetric integer codification applied to the
distributed-training wire format, as in ``repro.optim.grad_compress``.

Scheme (per leaf):
  1. g_eff = g_local + residual          (error feedback)
  2. shared scale s = max(|g_eff|max over the pods) / 127
  3. q = saturate(round_half_even(g_eff / s))   int8 — the wire format
  4. wire all-reduce: sum(int32(q)) over the pods (int32 accumulation is
     exact, like the paper's MatMulInteger accumulator)
  5. g_avg = s * sum_q / n_pods
  6. residual' = g_eff − s·q               (kept locally)

The pods are the ranks of a ``torch.distributed`` process group (``group``:
a group, or ``None`` for the default one): ``all_reduce`` MAX for the
shared scale and int32 SUM for the codes.  :class:`StackedPods` runs the
same collectives over a leading pod dimension of every leaf in one process,
as ``jax.vmap(..., axis_name="pod")`` runs ``repro``'s.  Every division
goes by a device tensor (CUDA divides by a host scalar as a multiply by
its reciprocal).
"""
from __future__ import annotations

from typing import Tuple

import torch
import torch.distributed as dist

from ..checkpoint.ckpt import tree_leaves, tree_unflatten
from ..core.qlayers import div127


class StackedPods:
    """The pods as the leading dimension of every leaf, in one process: a
    collective reduces over that dimension and hands each pod the result."""

    def size(self, like: torch.Tensor) -> int:
        return like.shape[0]

    def max(self, t: torch.Tensor) -> torch.Tensor:
        return t.amax(dim=0, keepdim=True).expand_as(t)

    def sum(self, t: torch.Tensor) -> torch.Tensor:
        return t.sum(dim=0, keepdim=True, dtype=t.dtype).expand_as(t)

    def local_max(self, t: torch.Tensor) -> torch.Tensor:
        """|t|max within each pod, shaped to broadcast against ``t``."""
        return t.abs().amax(dim=tuple(range(1, t.ndim)), keepdim=True)


class _ProcessGroup:
    """The pods as the ranks of a ``torch.distributed`` process group."""

    def __init__(self, group) -> None:
        self.group = group

    def size(self, like: torch.Tensor) -> int:
        return dist.get_world_size(self.group)

    def _all_reduce(self, t: torch.Tensor, op) -> torch.Tensor:
        t = t.clone()
        dist.all_reduce(t, op=op, group=self.group)
        return t

    def max(self, t: torch.Tensor) -> torch.Tensor:
        return self._all_reduce(t, dist.ReduceOp.MAX)

    def sum(self, t: torch.Tensor) -> torch.Tensor:
        return self._all_reduce(t, dist.ReduceOp.SUM)

    def local_max(self, t: torch.Tensor) -> torch.Tensor:
        return t.abs().amax()


def _pods(group):
    return group if isinstance(group, StackedPods) else _ProcessGroup(group)


def _compress_leaf(g: torch.Tensor, res: torch.Tensor, pods) -> Tuple[torch.Tensor, torch.Tensor]:
    g_eff = g.to(torch.float32) + res
    s = div127(pods.max(pods.local_max(g_eff))) + 1e-20
    q = torch.clamp(torch.round(g_eff / s), -128, 127)  # int8 wire values
    q_sum = pods.sum(q.to(torch.int32))  # exact int32 accumulation
    n = g_eff.new_full((), float(pods.size(g_eff)))
    g_avg = (s * q_sum.to(torch.float32)) / n
    new_res = g_eff - s * q
    return g_avg.to(g.dtype), new_res


def compressed_cross_pod_mean(grads, residuals, *, group=None):
    """All-reduce-mean ``grads`` across the pods in int8 with error
    feedback.  Returns (averaged grads, new residuals)."""
    pods = _pods(group)
    out = [_compress_leaf(g, r, pods) for g, r in zip(tree_leaves(grads), tree_leaves(residuals))]
    return (tree_unflatten(grads, iter([o[0] for o in out])),
            tree_unflatten(grads, iter([o[1] for o in out])))


def init_residuals(grads):
    return tree_unflatten(grads, iter([torch.zeros(g.shape, dtype=torch.float32, device=g.device)
                                       for g in tree_leaves(grads)]))


def uncompressed_cross_pod_mean(grads, *, group=None):
    pods = _pods(group)
    leaves = tree_leaves(grads)
    return tree_unflatten(grads, iter([pods.sum(g) / g.new_full((), float(pods.size(g)))
                                       for g in leaves]))
