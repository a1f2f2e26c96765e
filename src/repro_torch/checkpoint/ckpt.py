"""Sharded, atomic, elastic checkpoints (numpy container format).

Layout:  <dir>/step_<N>/
            manifest.json          — tree structure, shapes, dtypes, step
            leaf_<i>.npy           — one file per tree leaf
         <dir>/LATEST              — atomic pointer (written last)

Fault-tolerance properties:
  * atomic: leaves + manifest land in a temp dir, then a single rename +
    LATEST pointer update — a crash mid-save never corrupts the previous
    checkpoint;
  * elastic restore: leaves are loaded host-side and moved to the device
    ``shardings`` names (or the target leaf's own device), or laid out as
    a DTensor over the mesh of a ``sharding.NamedSharding`` (or of a
    DTensor target leaf) — the restoring process may run on other devices
    or another mesh than the saving one (a checkpoint written from the CPU
    restores onto the card; one saved from 4 ranks into 2);
  * sharded save: a DTensor leaf is gathered whole (``full_tensor``) on
    every rank, and only rank 0 of the process group writes; the ranks
    meet at a barrier before ``save`` returns;
  * self-describing: restore needs no model code, only the manifest.

The container format is ``repro.checkpoint.ckpt``'s, byte for byte: trees of
dict / list / tuple / None flatten in JAX's pytree order (dict keys sorted,
None an empty node with no leaf, paths like ``a/1/0``), and the manifest's
``treedef`` string is the one ``jax.tree_util`` prints for the same tree.  A
checkpoint written by either package restores through the other.  Anything
that is not one of those four containers is a leaf.
"""
from __future__ import annotations

import json
import os
import shutil
import tempfile
from typing import Any, List, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor, distribute_tensor

_CONTAINERS = (dict, list, tuple)


def _children(node) -> List[Tuple[str, Any]]:
    """(path key, child) pairs of a container node, in pytree order."""
    if type(node) is dict:
        return [(str(k), node[k]) for k in sorted(node)]
    return [(str(i), c) for i, c in enumerate(node)]


def _flatten(tree, prefix: Tuple[str, ...] = ()):
    """Yield (path tuple, leaf) in pytree order."""
    if tree is None:
        return
    if type(tree) in _CONTAINERS:
        for key, child in _children(tree):
            yield from _flatten(child, prefix + (key,))
        return
    yield prefix, tree


def _treedef_str(tree) -> str:
    """The structure as ``jax.tree_util.tree_structure`` prints it (without
    the ``PyTreeDef(...)`` wrapper)."""
    if tree is None:
        return "None"
    if type(tree) is dict:
        return "{" + ", ".join(f"{k!r}: {_treedef_str(tree[k])}" for k in sorted(tree)) + "}"
    if type(tree) is list:
        return "[" + ", ".join(_treedef_str(c) for c in tree) + "]"
    if type(tree) is tuple:
        inner = ", ".join(_treedef_str(c) for c in tree)
        return f"({inner},)" if len(tree) == 1 else f"({inner})"
    return "*"


def tree_leaves(tree) -> list:
    """The leaves of a dict/list/tuple/None tree in JAX's pytree order (dict
    keys sorted, ``None`` a node with no leaf)."""
    return [leaf for _, leaf in _flatten(tree)]


def tree_unflatten(tree, leaves):
    """A tree of ``tree``'s structure whose leaves are taken in order from
    the iterator ``leaves``."""
    if tree is None:
        return None
    if type(tree) is dict:
        return {k: tree_unflatten(tree[k], leaves) for k in sorted(tree)}
    if type(tree) in (list, tuple):
        return type(tree)(tree_unflatten(c, leaves) for c in tree)
    return next(leaves)


def _flatten_up_to(tree, other) -> list:
    """The subtrees of ``other`` at the leaf positions of ``tree`` (the two
    must share the containers above those positions)."""
    if tree is None:
        return []
    if type(tree) in _CONTAINERS:
        if type(other) is not type(tree) or len(other) != len(tree) or (
            type(tree) is dict and sorted(other) != sorted(tree)
        ):
            raise ValueError(
                f"shardings do not match the target tree: {_treedef_str(other)} "
                f"against {_treedef_str(tree)}"
            )
        out = []
        for (_, t), (_, o) in zip(_children(tree), _children(other)):
            out += _flatten_up_to(t, o)
        return out
    return [other]


def _paths_and_leaves(tree):
    flat = list(_flatten(tree))
    return ["/".join(path) for path, _ in flat], [leaf for _, leaf in flat]


def _host_array(leaf) -> np.ndarray:
    if isinstance(leaf, DTensor):
        leaf = leaf.full_tensor()  # a collective: every rank gathers
    if isinstance(leaf, torch.Tensor):
        if leaf.dtype == torch.bfloat16:
            raise TypeError(
                "a bfloat16 tensor has no numpy dtype here; cast the leaf "
                "(e.g. to float32) before saving it"
            )
        return leaf.detach().cpu().contiguous().numpy()
    return np.asarray(leaf)


def _world() -> Tuple[int, int]:
    """(rank, ranks) of the default process group; (0, 1) without one."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def save(ckpt_dir: str, step: int, tree: Any, extra: Optional[dict] = None) -> str:
    """Atomically save a tree as step_<step>.  Under a process group every
    rank calls this (a DTensor leaf is gathered by all of them) and rank 0
    writes."""
    rank, ranks = _world()
    paths, leaves = _paths_and_leaves(tree)
    final = os.path.join(ckpt_dir, f"step_{step}")
    tmp = None
    if rank == 0:
        os.makedirs(ckpt_dir, exist_ok=True)
        tmp = tempfile.mkdtemp(dir=ckpt_dir, prefix=".tmp_")
    try:
        for i, leaf in enumerate(leaves):
            a = _host_array(leaf)
            if tmp is not None:
                np.save(os.path.join(tmp, f"leaf_{i}.npy"), a)
        if tmp is not None:
            manifest = {
                "step": step,
                "paths": paths,
                "treedef": f"PyTreeDef({_treedef_str(tree)})",
                "num_leaves": len(leaves),
                "extra": extra or {},
            }
            with open(os.path.join(tmp, "manifest.json"), "w") as f:
                json.dump(manifest, f)
            if os.path.exists(final):
                shutil.rmtree(final)
            os.rename(tmp, final)
    except BaseException:
        if tmp is not None:
            shutil.rmtree(tmp, ignore_errors=True)
        raise
    if rank == 0:
        # LATEST pointer last — readers never see a partial checkpoint
        latest_tmp = os.path.join(ckpt_dir, ".LATEST.tmp")
        with open(latest_tmp, "w") as f:
            f.write(str(step))
        os.replace(latest_tmp, os.path.join(ckpt_dir, "LATEST"))
    if ranks > 1:
        dist.barrier()
    return final


def latest_step(ckpt_dir: str) -> Optional[int]:
    try:
        with open(os.path.join(ckpt_dir, "LATEST")) as f:
            return int(f.read().strip())
    except (FileNotFoundError, ValueError):
        return None


def restore(
    ckpt_dir: str,
    target_tree: Any,
    *,
    step: Optional[int] = None,
    shardings: Any = None,
) -> Tuple[Any, int, dict]:
    """Restore into the structure of ``target_tree``; every leaf comes back
    as a tensor.  ``shardings`` names the devices: one ``torch.device`` (or
    device string) for every leaf, or a tree of them matching the target's,
    whose entries may also be ``sharding.NamedSharding``s: such a leaf is
    laid out over that mesh (``distribute_tensor``; every rank reads the
    file, so no rank sends).  A None entry, or ``shardings=None``, follows
    the target leaf: a DTensor target's mesh and placements, a tensor's
    device, the CPU for a leaf that is not a tensor.  The saving devices and
    mesh do not matter (elastic restart)."""
    if step is None:
        step = latest_step(ckpt_dir)
        if step is None:
            raise FileNotFoundError(f"no checkpoint in {ckpt_dir}")
    d = os.path.join(ckpt_dir, f"step_{step}")
    with open(os.path.join(d, "manifest.json")) as f:
        manifest = json.load(f)
    n = manifest["num_leaves"]
    _, targets = _paths_and_leaves(target_tree)
    if len(targets) != n:
        raise ValueError(f"checkpoint has {n} leaves; target expects {len(targets)}")
    if isinstance(shardings, (str, torch.device)):
        places = [shardings] * n
    elif shardings is not None:
        places = _flatten_up_to(target_tree, shardings)
    else:
        places = [None] * n
    placed = [_place(np.load(os.path.join(d, f"leaf_{i}.npy")), where, t)
              for i, (where, t) in enumerate(zip(places, targets))]
    return tree_unflatten(target_tree, iter(placed)), step, manifest.get("extra", {})


def _place(a: np.ndarray, where, target) -> torch.Tensor:
    """A loaded leaf on ``where`` (a device, a ``NamedSharding`` or None:
    as ``target``)."""
    if where is None:
        if isinstance(target, DTensor):
            mesh, placements = target.device_mesh, target.placements
            return distribute_tensor(torch.from_numpy(a).to(mesh.device_type), mesh, placements,
                                     src_data_rank=None)
        where = target.device if isinstance(target, torch.Tensor) else "cpu"
    if hasattr(where, "placements"):  # a sharding.NamedSharding
        return distribute_tensor(torch.from_numpy(a).to(where.mesh.device_type), where.mesh,
                                 where.placements, src_data_rank=None)
    return torch.from_numpy(a).to(where)
