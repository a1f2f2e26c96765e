"""Logical-axis sharding rules (MaxText-style) for the production meshes, as
DTensor placements over a ``torch.distributed`` :class:`DeviceMesh`.

Physical mesh axes:
  * ``pod``   — pure data parallelism across pods (gradient all-reduce over DCN)
  * ``data``  — FSDP: batch for activations, weight/optimizer sharding for params
  * ``model`` — tensor parallelism: heads / d_ff / vocab / expert-internal dims

Every tensor annotates *logical* axes; rules map them to physical axes with a
divisibility check — if a dim doesn't divide the physical axis size the rule
falls back to the next candidate (or replication).  This is what lets one
rule-set serve all 10 architectures (8-head gemma2 and 48-head mixtral alike)
without per-arch sharding code.

The rules and their resolution are ``repro``'s.  What differs is the layout
object.  A :class:`PartitionSpec` maps *tensor dim → mesh axes*, as JAX's
does; a DTensor's placements map *mesh dim → tensor dim*.
:attr:`NamedSharding.placements` turns one into the other: a tensor dim
sharded over ``("pod", "data")`` becomes ``Shard(d)`` on both mesh dims,
split major to minor in mesh-dim order, which is JAX's order for that tuple.
A torch ``DeviceMesh``'s ``.shape`` is a tuple where JAX's is a dict, so
sizes are read through :func:`axis_sizes`.
"""
from __future__ import annotations

import contextlib
import threading
from typing import Optional, Sequence

import numpy as np
import torch
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import DTensor, Replicate, Shard, distribute_tensor
from torch.distributed.tensor.experimental import implicit_replication

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


class PartitionSpec(tuple):
    """Tensor dim → mesh axis name, a tuple of names (major to minor), or
    ``None`` (replicated); trailing replicated dims are dropped.  Prints as
    ``jax.sharding.PartitionSpec`` does."""

    def __new__(cls, *parts):
        return super().__new__(cls, parts)

    def __repr__(self) -> str:
        return "PartitionSpec" + tuple.__repr__(self)


P = PartitionSpec


class NamedSharding:
    """A :class:`PartitionSpec` over a :class:`DeviceMesh`; ``placements``
    is the same layout as DTensor placements (one per mesh dim)."""

    def __init__(self, mesh: DeviceMesh, spec: PartitionSpec):
        self.mesh = mesh
        self.spec = spec

    @property
    def placements(self) -> tuple:
        """One per mesh dim.  A mesh dim of size 1 gets ``Replicate()``: its
        one rank holds the whole dim either way, and DTensor's rules (older
        versions' einsum among them) take a replicated dim where they may
        refuse a trivially sharded one."""
        names = list(mesh_dim_names(self.mesh))
        sizes = tuple(self.mesh.shape)
        out = [Replicate()] * len(names)
        for d, part in enumerate(self.spec):
            if part is None:
                continue
            dims = [names.index(a) for a in (part if isinstance(part, tuple) else (part,))]
            if dims != sorted(dims):
                # DTensor splits a dim over its mesh dims in mesh-dim order;
                # another order needs _StridedShard, which no rule asks for
                raise ValueError(f"axes {part} of {self.spec} are not in the mesh's order {tuple(names)}")
            for i in dims:
                if sizes[i] > 1:
                    out[i] = Shard(d)
        return tuple(out)

    def __eq__(self, other) -> bool:
        return isinstance(other, NamedSharding) and other.mesh == self.mesh and other.spec == self.spec

    def __hash__(self) -> int:
        return hash((id(self.mesh), self.spec))

    def __repr__(self) -> str:
        return f"NamedSharding(mesh={axis_sizes(self.mesh)}, spec={self.spec!r})"


def mesh_dim_names(mesh: DeviceMesh) -> tuple:
    if not mesh.mesh_dim_names:
        raise ValueError("a sharding mesh needs named dims (mesh_dim_names)")
    return tuple(mesh.mesh_dim_names)


def axis_sizes(mesh: DeviceMesh) -> dict:
    """``{axis name: size}``: what ``repro`` reads as ``mesh.shape``."""
    return dict(zip(mesh_dim_names(mesh), mesh.shape))


class _Ctx(threading.local):
    def __init__(self):
        self.mesh: Optional[DeviceMesh] = None
        self.rules: dict = DEFAULT_RULES


_CTX = _Ctx()


@contextlib.contextmanager
def use_mesh(mesh: Optional[DeviceMesh], rules: Optional[dict] = None):
    """Activate a mesh + rules for logical sharding annotations.  Under a
    mesh, a plain tensor beside a DTensor in one op is a replicated value
    (DTensor's ``implicit_replication``): the constants a step makes on the
    fly (positions, masks, a schedule's lr) are the same on every rank."""
    if mesh is not None and not isinstance(mesh, DeviceMesh):
        raise TypeError(f"use_mesh takes a torch DeviceMesh or None, not {type(mesh).__name__}")
    prev_mesh, prev_rules = _CTX.mesh, _CTX.rules
    _CTX.mesh = mesh
    _CTX.rules = {**DEFAULT_RULES, **(rules or {})}
    try:
        if mesh is not None:
            with implicit_replication():
                yield
        else:
            yield
    finally:
        _CTX.mesh, _CTX.rules = prev_mesh, prev_rules


def active_mesh() -> Optional[DeviceMesh]:
    return _CTX.mesh


def bind_mesh(fn):
    """``fn`` run under the mesh and rules active now, on whatever thread
    calls it.  The mesh is thread-local, and autograd recomputes a
    checkpointed function on its own device thread (CUDA, meta), where no
    mesh is active; without this the recompute would lay its
    intermediates out otherwise than the forward did."""
    mesh, rules = _CTX.mesh, _CTX.rules
    if mesh is None:
        return fn

    def bound(*args, **kwargs):
        if _CTX.mesh is mesh and _CTX.rules is rules:
            return fn(*args, **kwargs)
        with use_mesh(mesh, rules):
            return fn(*args, **kwargs)

    return bound


def _resolve_axis(logical: Optional[str], dim: int, sizes: dict, rules: dict, used: set):
    """First candidate whose axes all exist, are unused, and divide ``dim``."""
    if logical is None:
        return None
    for cand in rules.get(logical, ()):
        axes = cand if isinstance(cand, tuple) else (cand,)
        if not axes:
            continue
        if any(a not in sizes or a in used for a in axes):
            continue
        total = int(np.prod([sizes[a] for a in axes]))
        if dim % total == 0:
            used.update(axes)
            return axes if len(axes) > 1 else axes[0]
    return None


def spec_for(shape: Sequence[int], logical_axes: Sequence[Optional[str]], mesh: Optional[DeviceMesh] = None,
             rules: Optional[dict] = None) -> PartitionSpec:
    """Resolve logical axes to a PartitionSpec with divisibility fallback."""
    mesh = _CTX.mesh if mesh is None else mesh
    rules = rules or _CTX.rules
    if mesh is None:
        return P()
    assert len(shape) == len(logical_axes), (shape, logical_axes)
    sizes = axis_sizes(mesh)
    used: set = set()
    parts = [_resolve_axis(la, d, sizes, rules, used) for d, la in zip(shape, logical_axes)]
    while parts and parts[-1] is None:
        parts.pop()
    return P(*parts)


def sharding_for(shape: Sequence[int], logical_axes: Sequence[Optional[str]], mesh: Optional[DeviceMesh] = None,
                 rules: Optional[dict] = None) -> Optional[NamedSharding]:
    mesh = _CTX.mesh if mesh is None else mesh
    if mesh is None:
        return None
    return NamedSharding(mesh, spec_for(shape, logical_axes, mesh, rules))


def shard(x: torch.Tensor, *logical_axes: Optional[str]) -> torch.Tensor:
    """Pin an intermediate to its logical sharding: a differentiable
    ``redistribute`` of a DTensor under an active mesh (``repro``'s
    ``with_sharding_constraint``), the identity otherwise."""
    mesh = _CTX.mesh
    if mesh is None or not isinstance(x, DTensor):
        return x
    placements = NamedSharding(mesh, spec_for(x.shape, logical_axes)).placements
    if tuple(x.placements) == placements:
        return x
    if any(p.is_partial() for p in x.placements):
        return _FromPartial.apply(x, placements)
    return x.redistribute(mesh, placements)


class _FromPartial(torch.autograd.Function):
    """``x.redistribute(mesh, placements)`` from a partial sum, whose
    backward sends the gradient to ``Replicate()`` on each mesh dim where
    ``x`` was partial, as torch 2.13's does; torch 2.11's turns a sharded
    gradient back into a partial sum and refuses ("redistribute from S(1)
    to P(sum) not supported yet": a matmul's partial output pinned by
    :func:`shard` on a (2, 2) mesh)."""

    @staticmethod
    def forward(ctx, x, placements):
        ctx.back = [Replicate() if p.is_partial() else p for p in x.placements]
        return x.redistribute(x.device_mesh, placements)

    @staticmethod
    def backward(ctx, g):
        return g.redistribute(g.device_mesh, ctx.back), None


def unshard(x: torch.Tensor, *dims: int) -> torch.Tensor:
    """``x`` with tensor dims ``dims`` whole on every rank: an explicit
    redistribute of a DTensor sharded on one of them to ``Replicate()`` on
    that mesh dim, for an op whose DTensor rule fails on a sharded operand
    (each caller says which).  The identity on a plain tensor."""
    if not isinstance(x, DTensor):
        return x
    dims = {d % x.ndim for d in dims}
    placements = [Replicate() if p.is_shard() and p.dim in dims else p for p in x.placements]
    if placements == list(x.placements):
        return x
    return x.redistribute(x.device_mesh, placements)


def unshard_for_split(x: torch.Tensor, dim: int, groups: int) -> torch.Tensor:
    """``x`` ready for a reshape that splits tensor dim ``dim`` into
    ``groups`` × rest: that dim gathered whole (:func:`unshard`) when the
    ranks sharding it do not divide ``groups``, as when 8 KV heads meet a
    16-way ``model`` axis.  DTensor refuses such an unflatten; GSPMD
    reshards on its own.  Otherwise ``x`` as it is."""
    if not isinstance(x, DTensor):
        return x
    sizes = x.device_mesh.shape
    ranks = int(np.prod([sizes[i] for i, p in enumerate(x.placements) if p.is_shard(dim % x.ndim)]))
    return x if groups % ranks == 0 else unshard(x, dim)


class _UnshardGradForSplit(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, groups):
        ctx.dim, ctx.groups = dim, groups
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return unshard_for_split(g, ctx.dim, ctx.groups), None, None


def unshard_grad_for_split(x: torch.Tensor, dim: int, groups: int) -> torch.Tensor:
    """The identity, whose backward applies :func:`unshard_for_split` to the
    gradient: for the output of a reshape that merged ``groups`` × rest into
    tensor dim ``dim``, whose backward splits the gradient again.  A plain
    tensor passes through untouched."""
    return _UnshardGradForSplit.apply(x, dim, groups) if isinstance(x, DTensor) else x


class _GradAsPlaced(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        ctx.mesh, ctx.placements = x.device_mesh, tuple(x.placements)
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g.redistribute(ctx.mesh, ctx.placements)


def grad_as_placed(x: torch.Tensor) -> torch.Tensor:
    """The identity, whose backward lays the gradient out as ``x`` is laid
    out (a partial sum reduced onto the shards).  For a parameter used
    twice, as a tied embedding is by the lookup and the readout: autograd
    adds the two gradients, and torch 2.11's add meets the readout's
    partial sum, (P(sum), S(0)), beside the lookup's (S(1), R) by turning
    the sharded one into a partial sum, which it refuses.  A plain tensor
    passes through untouched."""
    return _GradAsPlaced.apply(x) if isinstance(x, DTensor) else x


class _ContiguousGrad(torch.autograd.Function):
    """The identity, whose backward makes the gradient contiguous: an
    einsum's backward can hand a local shard's gradient back transposed,
    and DTensor views the local tensor of a gradient as its global shape
    says, which a strided one refuses."""

    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g.contiguous()


def local_einsum(eq: str, *ops: torch.Tensor) -> torch.Tensor:
    """``torch.einsum(eq, *ops)`` on DTensors without DTensor merging two
    sharded dims into one, which torch 2.11 refuses (its einsum flattens
    the batch letters into one ``bmm`` dim: ``aten._unsafe_view`` of
    (2, 2, 2, 16, 64, 1) sharded (S(0), S(1)) on a (2, 2) mesh).

    Only where two such batch letters (those every operand and the output
    carry: attention's batch and heads) are sharded does anything change.
    Then, where each mesh dim shards at most one letter and that letter
    is a batch letter, each rank runs the einsum on its shards (an
    operand replicated on that mesh dim is sliced to its shard, with no
    communication); elsewhere, on a mesh dim where that fails, the
    operands' shards of batch letters are gathered first and DTensor's
    einsum runs (a decode step's heads against a cache sharded on its
    sequence).  Otherwise, and for plain tensors: ``torch.einsum`` as it
    is."""
    if not all(isinstance(o, DTensor) for o in ops) or len({o.device_mesh for o in ops}) != 1:
        return torch.einsum(eq, *ops)
    subs, out = eq.replace(" ", "").split("->")
    subs = subs.split(",")
    mesh = ops[0].device_mesh
    batch = set(out).intersection(*map(set, subs))
    if len({sub[p.dim] for o, sub in zip(ops, subs) for p in o.placements
            if p.is_shard() and sub[p.dim] in batch}) < 2:
        return torch.einsum(eq, *ops)  # DTensor flattens at most one sharded dim: any torch takes it
    letters, bad = [], set()
    for m in range(mesh.ndim):
        shards = {sub[o.placements[m].dim] for o, sub in zip(ops, subs) if o.placements[m].is_shard()}
        if any(o.placements[m].is_partial() for o in ops) or len(shards) > 1 or not shards <= batch:
            bad.add(m)
        letters.append(next(iter(shards)) if len(shards) == 1 else None)
    if bad:
        ops = [o.redistribute(mesh, [Replicate() if m in bad and p.is_shard() and sub[p.dim] in batch else p
                                     for m, p in enumerate(o.placements)])
               for o, sub in zip(ops, subs)]
        return torch.einsum(eq, *ops)
    local = []
    for o, sub in zip(ops, subs):
        want = [Shard(sub.index(c)) if c else Replicate() for c in letters]
        local.append(_ContiguousGrad.apply((o if list(o.placements) == want else o.redistribute(mesh, want)).to_local()))
    size = {c: n for o, sub in zip(ops, subs) for c, n in zip(sub, o.shape)}
    shape = torch.Size(size[c] for c in out)
    stride = tuple(int(np.prod(shape[i + 1:])) for i in range(len(shape)))
    return DTensor.from_local(torch.einsum(eq, *local), mesh,
                              [Shard(out.index(c)) if c else Replicate() for c in letters],
                              run_check=False, shape=shape, stride=stride)


def pad_as(x: torch.Tensor, like: torch.Tensor, pad: Sequence[int]) -> torch.Tensor:
    """``F.pad(x, pad)`` (zeros), laid out as ``like``, which has the padded
    shape.  On DTensors each rank pads whole rows: ``x`` is gathered along
    the padded dims (and laid out as ``like`` along the rest), padded on
    each rank, then sliced to ``like``'s shards.  torch 2.11's DTensor
    ``pad`` fails to plan its own redistribution (an ``IndexError`` in
    ``generate_greedy_transform_infos``: a prefill's K written into a cache
    sharded on its sequence over a (2, 2) mesh)."""
    if not (isinstance(x, DTensor) and isinstance(like, DTensor)):
        return torch.nn.functional.pad(x, pad)
    padded = {x.ndim - 1 - i // 2 for i in range(0, len(pad), 2) if pad[i] or pad[i + 1]}
    whole = [Replicate() if p.is_shard() and p.dim in padded else p for p in like.placements]
    if list(x.placements) != whole:
        x = x.redistribute(like.device_mesh, whole)
    out = DTensor.from_local(torch.nn.functional.pad(x.to_local(), pad), like.device_mesh, whole,
                             run_check=False, shape=like.shape, stride=like.stride())
    return out if whole == list(like.placements) else out.redistribute(like.device_mesh, like.placements)


def split_last(x: torch.Tensor, *sizes: int) -> torch.Tensor:
    """``x.reshape(x.shape[:-1] + sizes)`` under a mesh too: the last dim is
    gathered first when its shards do not divide ``sizes[0]`` (the leading
    group: heads, or rwkv6's five interpolation targets), and so is the
    gradient that merges it again."""
    x = unshard_for_split(x, -1, sizes[0])
    return unshard_grad_for_split(x.reshape(x.shape[:-1] + sizes), -len(sizes), sizes[0])


def tree_shardings(tree, logical_fn, mesh: Optional[DeviceMesh] = None):
    """Build a sharding tree for ``tree`` where ``logical_fn(path, leaf)``
    returns the logical axes tuple for each leaf (``path`` as
    ``models.model.tree_map`` gives it)."""
    from ..models.model import tree_map

    mesh = _CTX.mesh if mesh is None else mesh
    return tree_map(lambda path, leaf: sharding_for(leaf.shape, logical_fn(path, leaf), mesh), tree)


def distribute(tree, shardings):
    """Lay each tensor leaf of ``tree`` out as its ``NamedSharding`` in
    ``shardings`` (a matching tree) says: a DTensor on that mesh (``repro``'s
    ``jax.device_put``).  Every rank must hold the whole value already (the
    same seed, batch or file); each keeps its shard, and no rank sends.  A
    DTensor leaf is redistributed; a leaf whose sharding is ``None`` stays as
    it is."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: distribute(v, shardings[k]) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(distribute(v, sh) for v, sh in zip(tree, shardings))
    if shardings is None:
        return tree
    if isinstance(tree, DTensor):
        return tree.redistribute(shardings.mesh, shardings.placements)
    return distribute_tensor(tree, shardings.mesh, list(shardings.placements), src_data_rank=None)
