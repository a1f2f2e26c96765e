"""Multi-pod dry-run: run every (architecture × input-shape) cell's step once
on the production meshes (16×16 single-pod, 2×16×16 multi-pod) over a
256- or 512-rank ``fake`` process group, on ``meta`` DTensors, then report
memory / cost / collective analysis — as ``repro.launch.dryrun`` lowers and
compiles on 512 forced host devices.

Usage:
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch gemma2_2b --shape train_4k
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--multi-pod] [--out out.json]

It runs on the CPU and allocates nothing: every tensor is a ``meta`` tensor
(shape and dtype), laid out as a DTensor over the mesh, and the world is
``torch.distributed``'s ``fake`` backend, whose collectives do nothing.
This process is rank 0 of that world, so every per-rank number is rank 0's.

A cell PASSES when its step runs on the mesh: every op has a DTensor
sharding rule, or the model redistributes around it explicitly (see
``distributed.sharding.unshard``).  The counterparts of ``repro``'s
analyses:

* ``memory``: ``argument_bytes`` sums the local shards of the step's
  arguments; ``output_bytes`` those of its outputs; ``temp_bytes`` is the
  peak of the bytes held by the step's live intermediates, tracked by a
  dispatch mode that adds each output's storage when an op makes it and
  subtracts it when the last tensor on it dies; ``peak_bytes`` is
  ``argument_bytes + temp_bytes``;
* ``cost``: ``flops`` from ``torch.utils.flop_counter.FlopCounterMode``,
  which counts the step's operations on the global shapes (XLA's cost
  analysis counts one device's share); ``bytes_accessed`` and
  ``transcendentals`` are ``None``, as the ``note`` says;
* ``collectives``: the count from ``CommDebugMode`` and, under ``repro``'s
  five names, the output bytes of each collective on this rank.  There is
  no HLO text here, so ``repro``'s ``collective_bytes_from_hlo`` and
  ``_tensor_bytes`` have no counterpart: the dispatch mode sees each
  collective as it is issued.  The CPU's process groups have no
  all-to-all; DTensor issues an all-gather in its place, counted as one.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import sys
import time
import traceback
import weakref
from typing import Dict

import torch
import torch.distributed as dist
from torch._subclasses.fake_tensor import FakeTensor
from torch.utils._python_dispatch import TorchDispatchMode

from ..checkpoint.ckpt import tree_leaves
from ..configs import ARCH_IDS, get_config
from ..configs.base import SHAPE_BY_NAME, SHAPES
from ..distributed import sharding as shlib
from . import specs as S
from . import steps
from .mesh import make_production_mesh

_COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all", "collective-permute")

#: ``_c10d_functional`` op name → ``repro``'s collective name.
_FUNCOL = {
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "all_reduce": "all-reduce",
    "all_reduce_coalesced": "all-reduce",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_to_all_single": "all-to-all",
}

_COST_NOTE = ("bytes_accessed and transcendentals: None; an eager run on meta tensors has no "
              "compiled program to analyse, and FlopCounterMode counts only FLOPs")


@contextlib.contextmanager
def fake_world(size: int):
    """A ``size``-rank ``fake`` process group with this process as rank 0
    (the counterpart of ``--xla_force_host_platform_device_count``).
    ``FakeStore`` lives in a private module of ``torch``; the tests pin it."""
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        raise RuntimeError("the dry-run builds its own fake world: no process group may be initialised")
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=size)
    try:
        yield
    finally:
        dist.destroy_process_group()


def _local(t: torch.Tensor) -> torch.Tensor:
    return t._local_tensor if isinstance(t, shlib.DTensor) else t


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def local_bytes(tree) -> int:
    """Bytes of the local shards of every tensor leaf of ``tree``."""
    return sum(_nbytes(_local(t)) for t in tree_leaves(tree) if isinstance(t, torch.Tensor))


class _Accounting(TorchDispatchMode):
    """Per-rank counts of one step: the FLOPs of its local ops (by
    ``FlopCounterMode``'s formulas), the peak of the bytes its live local
    intermediates hold, and each collective's output bytes.  It defers a
    DTensor op to DTensor (as ``CommDebugMode`` does), so it sees the local
    ops and the collectives that op turns into, on this rank's shards."""

    def __init__(self, held):
        super().__init__()
        self.known = {_local(t).untyped_storage()._cdata for t in tree_leaves(held)
                      if isinstance(t, torch.Tensor)}
        self.refs: Dict[int, int] = {}
        self.live = self.peak = self.flops = 0
        self.coll = {k: 0 for k in _COLLECTIVES}
        self.coll["count"] = 0

    def _release(self, key: int, nbytes: int) -> None:
        self.refs[key] -= 1
        if not self.refs[key]:
            del self.refs[key]
            self.live -= nbytes

    def _track(self, t: torch.Tensor) -> None:
        storage = t.untyped_storage()
        key = storage._cdata
        if key in self.known:
            return
        if key not in self.refs:
            self.refs[key] = 0
            self.live += storage.nbytes()
            self.peak = max(self.peak, self.live)
        self.refs[key] += 1
        weakref.finalize(t, self._release, key, storage.nbytes())

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.utils.flop_counter import flop_registry

        if any(issubclass(t, shlib.DTensor) for t in types):
            return NotImplemented
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        leaves = tree_leaves(out if isinstance(out, (tuple, list)) else [out])
        if any(isinstance(t, FakeTensor) for t in leaves):  # DTensor's shape inference, on global shapes
            return out
        count = flop_registry.get(func._overloadpacket)
        if count is not None:
            self.flops += count(*args, **kwargs, out_val=out)
        name = _FUNCOL.get(func._schema.name.split("::")[-1]) if func.namespace == "_c10d_functional" else None
        for t in leaves:
            if isinstance(t, torch.Tensor):
                self._track(t)
                if name is not None:
                    self.coll[name] += _nbytes(t)
        if name is not None:
            self.coll["count"] += 1
        return out


def _run(fn, args):
    """``fn(*args)`` under CommDebugMode, the per-rank accounting and (on
    top, so it sees the DTensor ops on global shapes) the flop counter;
    returns (outputs, global FLOPs, collective count, accounting)."""
    from torch.distributed.tensor.debug import CommDebugMode
    from torch.utils.flop_counter import FlopCounterMode

    comms, acct, flops = CommDebugMode(), _Accounting(args), FlopCounterMode(display=False)
    with comms, acct, flops:
        out = fn(*args)
    return out, flops.get_total_flops(), comms.get_total_counts(), acct


def lower_cell(arch: str, shape_name: str, *, multi_pod: bool = False, q_chunk: int = 1024, kv_chunk: int = 1024,
               w8a8: bool = False):
    """Lay one cell's inputs out on the mesh and run its step once.  Returns
    a result dict (see :func:`dryrun_cell`).  Needs a fake world of the
    mesh's size (:func:`fake_world`)."""
    cfg = get_config(arch)
    sc = SHAPE_BY_NAME[shape_name]
    skip = S.skip_reason(cfg, sc)
    if skip:
        return {"arch": arch, "shape": shape_name, "status": "skip", "reason": skip}

    mesh = make_production_mesh(multi_pod=multi_pod, device_type="cpu")
    t0 = time.time()
    with shlib.use_mesh(mesh):
        p_specs = S.params_specs(cfg)
        if w8a8 and sc.kind != "train":
            from ..core.convert import convert_params_w8a8

            p_specs = convert_params_w8a8(p_specs)
        p_sh = S.params_shardings(p_specs, mesh)
        params = shlib.distribute(p_specs, p_sh)
        if sc.kind == "train":
            from ..optim import adamw

            o_specs = adamw.init(p_specs)
            opt = shlib.distribute(o_specs, {"m": p_sh, "v": p_sh, "step": None})
            b_specs = S.train_batch_specs(cfg, sc)
            batch = shlib.distribute(b_specs, S.batch_shardings(b_specs, mesh))
            fn = steps.make_train_step(cfg, sc, q_chunk=q_chunk, kv_chunk=kv_chunk)
            args = (params, opt, batch)
        elif sc.kind == "prefill":
            b_specs, c_specs = S.prefill_input_specs(cfg, sc)
            batch = shlib.distribute(b_specs, S.batch_shardings(b_specs, mesh))
            cache = shlib.distribute(c_specs, S.cache_shardings(c_specs, mesh))
            fn = steps.make_prefill_step(cfg, q_chunk=q_chunk, kv_chunk=kv_chunk)
            args = (params, batch, cache)
        else:  # decode
            toks, pos, c_specs = S.decode_input_specs(cfg, sc)
            t_in = shlib.distribute({"tokens": toks, "pos": pos},
                                    S.batch_shardings({"tokens": toks, "pos": pos}, mesh))
            cache = shlib.distribute(c_specs, S.cache_shardings(c_specs, mesh))
            fn = steps.make_decode_step(cfg)
            args = (params, t_in["tokens"], t_in["pos"], cache)
        t_lower = time.time() - t0
        t0 = time.time()
        out, flops, n_comms, acct = _run(fn, args)
        t_run = time.time() - t0
    return {
        "arch": arch, "shape": shape_name, "status": "ok", "multi_pod": multi_pod,
        "args": args, "out": out, "flops": flops, "comm_count": n_comms, "accounting": acct,
        "t_lower_s": round(t_lower, 1), "t_compile_s": round(t_run, 1),
    }


def dryrun_cell(arch: str, shape_name: str, *, multi_pod: bool = False, w8a8: bool = False,
                q_chunk: int = 1024, kv_chunk: int = 1024) -> Dict:
    """Full dry-run for one cell, in a fake world of its mesh's size: the
    step run once, then memory/cost/collective analysis.  ``q_chunk`` /
    ``kv_chunk`` are the attention chunks, ``repro``'s 1024 by default."""
    try:
        with fake_world(512 if multi_pod else 256):
            res = lower_cell(arch, shape_name, multi_pod=multi_pod, w8a8=w8a8, q_chunk=q_chunk, kv_chunk=kv_chunk)
            if res["status"] != "ok":
                return res
            acct = res.pop("accounting")
            args, out = res.pop("args"), res.pop("out")
            arg_bytes, out_bytes = local_bytes(args), local_bytes(out)
            if acct.coll["count"] != res["comm_count"]:
                raise AssertionError(f"collectives: CommDebugMode counted {res['comm_count']}, "
                                     f"the byte accounting {acct.coll['count']}")
    except Exception as e:  # a failure here is a bug in our sharding config
        return {
            "arch": arch, "shape": shape_name, "multi_pod": multi_pod,
            "status": "fail", "error": f"{type(e).__name__}: {e}",
            "trace": traceback.format_exc()[-2000:],
        }
    del args, out
    res.pop("comm_count")
    res.update(
        {
            "memory": {
                "argument_bytes": arg_bytes,
                "output_bytes": out_bytes,
                "temp_bytes": acct.peak,
                "peak_bytes": arg_bytes + acct.peak,
            },
            "cost": {"flops": acct.flops, "global_flops": res.pop("flops"), "bytes_accessed": None, "transcendentals": None,
                     "note": _COST_NOTE},
            "collectives": acct.coll,
        }
    )
    return res


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--out", default=None)
    ap.add_argument("--w8a8", action="store_true", help="pre-quantized W8A8 serving params")
    args = ap.parse_args(argv)

    archs = ARCH_IDS if (args.all or not args.arch) else [args.arch]
    shapes = [s.name for s in SHAPES] if (args.all or not args.shape) else [args.shape]
    meshes = [False, True] if args.both_meshes else [args.multi_pod]
    results = []
    for mp in meshes:
        for a in archs:
            for s in shapes:
                r = dryrun_cell(a, s, multi_pod=mp, w8a8=args.w8a8)
                results.append(r)
                tag = "POD2" if mp else "POD1"
                status = r["status"].upper()
                extra = ""
                if r["status"] == "ok":
                    gb = (r["memory"]["temp_bytes"] or 0) / 2**30
                    extra = f" flops={r['cost']['flops']:.3e} temp={gb:.2f}GiB coll={r['collectives']['count']} t={r['t_compile_s']}s"
                elif r["status"] == "fail":
                    extra = " " + r["error"][:200]
                print(f"[{tag}] {a:24s} {s:12s} {status}{extra}", flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(results, f, indent=1)
    bad = [r for r in results if r["status"] == "fail"]
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
