"""The port's dry-run (``repro_torch.launch.dryrun``) on the CPU: each cell's
step run once on ``meta`` DTensors over a 256-rank (single-pod) or 512-rank
(multi-pod) ``fake`` process group, as ``repro``'s lowers and compiles on
512 forced host devices.

* The ``fake`` world: ``FakeStore`` comes from a private module of
  ``torch`` (``torch.testing._internal.distributed.fake_pg``); pinned here.
* ``qwen3_1_7b``'s cells on both meshes: ``train_4k`` (single-pod only, see
  below), ``prefill_32k`` and ``decode_32k`` come out ``ok`` with collectives counted (> 0), FLOPs and per-rank
  argument bytes equal to those worked out from ``repro``'s
  ``params_specs`` / ``*_input_specs`` and ``repro``'s ``spec_for``;
  ``long_500k`` comes out ``skip``.  To keep each cell well under two
  minutes on the CPU the tests run attention in one chunk per sequence
  (``q_chunk = kv_chunk = seq_len``): the chunk sets how many eager ops
  the step dispatches, not its layout or its arguments (the CLI keeps
  ``repro``'s 1024).  The multi-pod ``train_4k`` cell is left to the CLI
  (``--arch qwen3_1_7b --both-meshes``): on the 3-D mesh DTensor plans the
  backward's redistributions by a graph search
  (``generate_graph_based_transform_infos``) and the cell takes about 17
  minutes on one CPU core, against 85 s on the single-pod mesh.
* Other architectures' cells: ``test_torch_dryrun_archs.py`` (a file of
  its own, so its minutes run on another worker).
* The global FLOPs of a decode step on the mesh equal the FLOPs of the same
  step on plain meta tensors (the mesh changes the layout, not the work),
  and the per-rank FLOPs are no more than the global.
* The CLI: ``--arch qwen3_1_7b --shape decode_32k --both-meshes --out``
  exits 0 and writes both cells.
"""
import json

import numpy as np
import pytest
import torch

from repro.configs import get_config as repro_get_config
from repro.configs.base import SHAPE_BY_NAME
from repro.distributed.sharding import spec_for as repro_spec_for
from repro.launch import specs as JS
from repro.models import model as JM
from repro_torch.configs import get_config
from repro_torch.launch import dryrun as D
from repro_torch.launch import specs as TS
from repro_torch.launch import steps as Tsteps

POD1 = {"data": 16, "model": 16}
POD2 = {"pod": 2, "data": 16, "model": 16}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _local_bytes(leaf, axes, sizes):
    import types

    spec = repro_spec_for(leaf.shape, axes, types.SimpleNamespace(shape=sizes))
    shape = list(leaf.shape)
    for d, part in enumerate(spec):
        for a in (() if part is None else part if isinstance(part, tuple) else (part,)):
            shape[d] //= sizes[a]
    return int(np.prod(shape)) * np.dtype(leaf.dtype).itemsize


def _tree_bytes(tree, axes_tree, sizes):
    import jax

    leaves = jax.tree_util.tree_leaves(tree)
    axes = jax.tree_util.tree_structure(tree).flatten_up_to(axes_tree)
    return sum(_local_bytes(leaf, ax, sizes) for leaf, ax in zip(leaves, axes))


def _batch_bytes(batch, sizes):
    return sum(_local_bytes(v, ("batch",) + (None,) * (len(v.shape) - 1), sizes) for v in batch.values())


def repro_argument_bytes(arch, shape_name, sizes):
    """Per-rank bytes of a cell's step arguments, from ``repro``'s specs and
    ``spec_for``: params (+ AdamW's m, v and step for train), the batch,
    the cache."""
    cfg, sc = repro_get_config(arch), SHAPE_BY_NAME[shape_name]
    p = JS.params_specs(cfg)
    total = _tree_bytes(p, JM.param_logical_axes(p), sizes)
    if sc.kind == "train":
        return 3 * total + 4 + _batch_bytes(JS.train_batch_specs(cfg, sc), sizes)
    if sc.kind == "prefill":
        batch, cache = JS.prefill_input_specs(cfg, sc)
    else:
        toks, pos, cache = JS.decode_input_specs(cfg, sc)
        batch = {"tokens": toks, "pos": pos}
    return total + _batch_bytes(batch, sizes) + _tree_bytes(cache, JM.cache_logical_axes(cache), sizes)


def run_cell(arch, shape_name, multi_pod):
    seq = SHAPE_BY_NAME[shape_name].seq_len
    return D.dryrun_cell(arch, shape_name, multi_pod=multi_pod, q_chunk=seq, kv_chunk=seq)


def check_cell(arch, shape_name, multi_pod):
    r = run_cell(arch, shape_name, multi_pod)
    if shape_name == "long_500k":
        assert r["status"] == "skip" and "full-attention" in r["reason"]
        return r
    assert r["status"] == "ok", r.get("error", "") + r.get("trace", "")
    assert r["multi_pod"] is multi_pod
    coll = r["collectives"]
    assert coll["count"] > 0 and sum(coll[k] for k in D._COLLECTIVES) > 0
    assert set(coll) == set(D._COLLECTIVES) | {"count"}
    assert 0 < r["cost"]["flops"] <= r["cost"]["global_flops"]
    assert r["cost"]["bytes_accessed"] is None and r["cost"]["transcendentals"] is None and r["cost"]["note"]
    mem = r["memory"]
    assert mem["argument_bytes"] == repro_argument_bytes(arch, shape_name, POD2 if multi_pod else POD1)
    assert mem["peak_bytes"] == mem["argument_bytes"] + mem["temp_bytes"] and mem["temp_bytes"] > 0
    assert mem["output_bytes"] > 0
    return r


def test_the_fake_world_is_there():
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore  # noqa: F401  (pinned)

    with D.fake_world(512):
        assert dist.get_world_size() == 512 and dist.get_rank() == 0
        assert dist.get_backend() == "fake"
        with pytest.raises(RuntimeError, match="fake world"):
            with D.fake_world(4):
                pass
    assert not dist.is_initialized()


@pytest.mark.parametrize("shape_name", ["train_4k", "prefill_32k", "decode_32k", "long_500k"])
def test_qwen3_single_pod_cells(shape_name):
    check_cell("qwen3_1_7b", shape_name, multi_pod=False)


@pytest.mark.parametrize("shape_name", ["prefill_32k", "decode_32k", "long_500k"])
def test_qwen3_multi_pod_cells(shape_name):
    check_cell("qwen3_1_7b", shape_name, multi_pod=True)


def test_mesh_keeps_the_work_of_a_decode_step():
    from torch.utils.flop_counter import FlopCounterMode

    r = D.dryrun_cell("qwen3_1_7b", "decode_32k")
    cfg, sc = get_config("qwen3_1_7b"), SHAPE_BY_NAME["decode_32k"]
    toks, pos, cache = TS.decode_input_specs(cfg, sc)
    fc = FlopCounterMode(display=False)
    with fc:
        Tsteps.make_decode_step(cfg)(TS.params_specs(cfg), toks, pos, cache)
    assert r["cost"]["global_flops"] == fc.get_total_flops() > 0
    assert r["cost"]["flops"] < r["cost"]["global_flops"]


def test_cli_runs_both_meshes(tmp_path):
    out = tmp_path / "dryrun.json"
    assert D.main(["--arch", "qwen3_1_7b", "--shape", "decode_32k", "--both-meshes", "--out", str(out)]) == 0
    cells = json.loads(out.read_text())
    assert [(c["status"], c["multi_pod"]) for c in cells] == [("ok", False), ("ok", True)]
    assert cells[0]["memory"]["argument_bytes"] == repro_argument_bytes("qwen3_1_7b", "decode_32k", POD1)
    assert cells[1]["memory"]["argument_bytes"] == repro_argument_bytes("qwen3_1_7b", "decode_32k", POD2)
