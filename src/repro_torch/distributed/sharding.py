"""Logical-axis sharding rules for the production meshes, on one card.

``repro``'s module maps each tensor's *logical* axes (``batch``, ``heads``,
``mlp``, ...) to physical mesh axes (``pod``, ``data``, ``model``) through
:data:`DEFAULT_RULES`, and ``shard`` pins an intermediate to the resolved
layout.  The port serves on one card, where there is no mesh: ``shard`` is
the identity and :func:`active_mesh` is ``None`` (so the MoE dispatch runs
as one group, as ``repro``'s does outside a mesh).  Activating a mesh is
refused until the mesh slice of the port (``launch/mesh.py``, with
``spec_for`` and ``tree_shardings``) lands.
"""
from __future__ import annotations

import contextlib
import threading
from typing import Optional

import torch

# logical axis -> ordered physical-axis candidates (first that divides wins).
# () means "replicate".  Tuples inside candidates mean "shard over both axes".
DEFAULT_RULES: dict = {
    # activations
    "batch": (("pod", "data"), ("data",)),
    "seq": (),
    "seq_shard": (("model",),),  # sequence parallelism (hillclimb option)
    "embed_act": (),  # activation d_model: replicated across model (TP gathers)
    "heads_act": (("model",),),
    "kv_heads_act": (("model",),),
    "mlp_act": (("model",),),
    "vocab_act": (("model",),),
    "expert_act": (("model",),),
    # params: FSDP over data on one dim, TP over model on another
    "embed": (("data",),),
    "embed_fsdp": (("data",),),
    "heads": (("model",),),
    "kv_heads": (("model",),),
    "mlp": (("model",),),
    "vocab": (("model",),),
    "expert": (("model",),),
    "expert_fsdp": (("data",),),
    # never sharded
    "layers": (),
    "norm": (),
    "state": (),
    "cap": (),
}


class _Ctx(threading.local):
    def __init__(self):
        self.mesh = None
        self.rules: dict = DEFAULT_RULES


_CTX = _Ctx()


@contextlib.contextmanager
def use_mesh(mesh, rules: Optional[dict] = None):
    """Activate rules for logical sharding annotations.  Only ``mesh=None``
    (one card) is supported; a mesh raises ``NotImplementedError``."""
    if mesh is not None:
        raise NotImplementedError(
            "repro_torch serves on one card: device meshes come with the port's mesh slice "
            "(launch/mesh.py, sharding.spec_for / tree_shardings)"
        )
    prev_mesh, prev_rules = _CTX.mesh, _CTX.rules
    _CTX.rules = {**DEFAULT_RULES, **(rules or {})}
    try:
        yield
    finally:
        _CTX.mesh, _CTX.rules = prev_mesh, prev_rules


def active_mesh():
    """The active mesh: always ``None`` on one card."""
    return _CTX.mesh


def shard(x: torch.Tensor, *logical_axes: Optional[str]) -> torch.Tensor:
    """Annotate an intermediate with a logical sharding constraint: the
    identity with no mesh, as ``repro``'s is outside a mesh context."""
    return x
