"""The port's mesh (``repro_torch.distributed.sharding``, ``launch/{mesh,specs}``)
against ``repro``'s, and the sharded steps, checkpoints and gradient
compression over ``torch.distributed`` device meshes on the CPU.

* ``spec_for`` / ``sharding_for`` equal ``repro``'s for every parameter and
  cache leaf of every architecture at its full config, on meshes (2,2),
  (2,4), (2,2,2), (16,16) and (2,16,16).  ``repro``'s ``spec_for`` reads any
  object with a ``.shape`` dict and the port's any with
  ``mesh_dim_names`` and a ``.shape`` tuple, so no devices are needed; the
  DTensor placements of each spec are held against the spec read by hand
  (tensor dim → mesh axes becomes mesh dim → ``Shard(dim)``).
* ``params_specs`` / ``cache_specs`` / the batch, prefill and decode input
  specs equal ``repro``'s ``jax.eval_shape`` in shape and dtype for every
  architecture and shape.
* ``tests/test_distributed.py::TestShardingRules``'s two cases, on real
  ``DeviceMesh``es over a ``fake`` process group.
* Multi-rank cases run as spawned processes on ``gloo`` (a file store
  under the test's tmp dir, one intra-op thread per rank):
  - one train step of ``qwen3_1_7b`` at ``reduced()`` on a 4-rank (2,2)
    mesh (``ShapeConfig("t", "train", 32, 4, microbatches=2)``, float32,
    chunks of 16) against the same step on one CPU device: loss within
    1e-3 and every parameter within 2e-4 absolute, ``repro``'s bounds in
    ``TestShardedTrainStep`` (measured: equal); each local shard's shape is
    what its spec says;
  - ``grad_compress`` over the ``pod`` group of a 4-rank (4,) mesh equals
    ``StackedPods`` over the same four pods bit for bit;
  - elastic restore: parameters saved from 4 ranks on (2,2), restored into
    2 ranks on (1,2) with ``shardings=``, bit for bit;
  - prefill + 3 decode steps with params and caches laid out by
    ``params_shardings`` / ``cache_shardings`` on (2,2) against one device,
    float32 compute: logits within 1e-5 · max(1, max |ref|).
"""
import os
import subprocess
import sys
import textwrap
import types
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from repro.configs import ARCH_IDS, get_config as repro_get_config
from repro.configs.base import SHAPES
from repro.distributed import sharding as jsh
from repro.launch import specs as JS
from repro.models import model as JM
from repro_torch.checkpoint.ckpt import _flatten_up_to, tree_leaves
from repro_torch.configs import get_config
from repro_torch.configs.base import ShapeConfig
from repro_torch.data.pipeline import DataConfig, Pipeline
from repro_torch.distributed import sharding as tsh
from repro_torch.launch import specs as TS
from repro_torch.launch import steps as Tsteps
from repro_torch.launch.dryrun import fake_world
from repro_torch.launch.mesh import make_test_mesh
from repro_torch.models import model as TM
from repro_torch.optim import adamw, grad_compress

ROOT = Path(__file__).resolve().parents[1]

MESHES = {
    "2x2": (("data", "model"), (2, 2)),
    "2x4": (("data", "model"), (2, 4)),
    "2x2x2": (("pod", "data", "model"), (2, 2, 2)),
    "16x16": (("data", "model"), (16, 16)),
    "2x16x16": (("pod", "data", "model"), (2, 16, 16)),
}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _meshes(key):
    names, shape = MESHES[key]
    return (types.SimpleNamespace(shape=dict(zip(names, shape))),
            types.SimpleNamespace(mesh_dim_names=names, shape=shape))


def _placements_by_hand(spec, names):
    out = ["R"] * len(names)
    for d, part in enumerate(spec):
        for a in (() if part is None else part if isinstance(part, tuple) else (part,)):
            out[names.index(a)] = f"S({d})"
    return out


def _show(placements):
    return ["R" if p.is_replicate() else f"S({p.dim})" for p in placements]


def _flat(tree):
    return jax.tree_util.tree_flatten_with_path(tree)[0]


@pytest.mark.parametrize("mesh_key", list(MESHES))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_spec_for_equals_repro_for_every_leaf(arch, mesh_key):
    jmesh, tmesh = _meshes(mesh_key)
    names = MESHES[mesh_key][0]
    jcfg, tcfg = repro_get_config(arch), get_config(arch)
    cases = [
        (JS.params_specs(jcfg), TS.params_specs(tcfg), JM.param_logical_axes, TM.param_logical_axes),
        (JS.cache_specs(jcfg, 128, 4096, src_len=4096 if jcfg.family == "encdec" else 0),
         TS.cache_specs(tcfg, 128, 4096, src_len=4096 if tcfg.family == "encdec" else 0),
         JM.cache_logical_axes, TM.cache_logical_axes),
    ]
    n = 0
    for jtree, ttree, jaxes, taxes in cases:
        jl = _flat(jtree)
        jax_axes = jax.tree_util.tree_structure(jtree).flatten_up_to(jaxes(jtree))
        t_leaves, t_axes = tree_leaves(ttree), _flatten_up_to(ttree, taxes(ttree))
        assert len(jl) == len(t_leaves) == len(jax_axes) == len(t_axes)
        for (path, jleaf), jax_ax, tleaf, tax in zip(jl, jax_axes, t_leaves, t_axes):
            assert tuple(tleaf.shape) == tuple(jleaf.shape), path
            assert tuple(tax) == tuple(jax_ax), path
            want = jsh.spec_for(jleaf.shape, jax_ax, jmesh)
            got = tsh.spec_for(tleaf.shape, tax, tmesh)
            assert tuple(got) == tuple(want) and repr(got) == repr(want), (path, got, want)
            sh = tsh.sharding_for(tleaf.shape, tax, tmesh)
            assert sh.spec == got
            assert _show(sh.placements) == _placements_by_hand(want, names), (path, want)
            n += 1
    assert n > 10


def _same_specs(jtree, ttree, what):
    jl, tl = jax.tree_util.tree_leaves(jtree), tree_leaves(ttree)
    assert len(jl) == len(tl), what
    for j, t in zip(jl, tl):
        assert t.device.type == "meta", what
        assert tuple(t.shape) == tuple(j.shape), (what, t.shape, j.shape)
        assert str(t.dtype).removeprefix("torch.") == str(j.dtype), (what, t.dtype, j.dtype)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_specs_match_repro_eval_shape(arch):
    jcfg, tcfg = repro_get_config(arch), get_config(arch)
    _same_specs(JS.params_specs(jcfg), TS.params_specs(tcfg), "params")
    for sc in SHAPES:
        if sc.kind == "train":
            _same_specs(JS.train_batch_specs(jcfg, sc), TS.train_batch_specs(tcfg, sc), sc.name)
        elif sc.kind == "prefill":
            _same_specs(JS.prefill_input_specs(jcfg, sc), TS.prefill_input_specs(tcfg, sc), sc.name)
        else:
            _same_specs(JS.decode_input_specs(jcfg, sc), TS.decode_input_specs(tcfg, sc), sc.name)
        assert TS.skip_reason(tcfg, sc) == JS.skip_reason(jcfg, sc)
    assert (TS.F32, TS.BF16, TS.I32) == (torch.float32, torch.bfloat16, torch.int32)


class TestShardingRules:
    """``tests/test_distributed.py::TestShardingRules`` on real meshes."""

    def test_divisibility_fallback(self):
        with fake_world(8):
            mesh = make_test_mesh((2, 4), device_type="cpu")
            with tsh.use_mesh(mesh):
                ok = tsh.spec_for((16, 32), ("embed", "heads"))  # both divide
                fb = tsh.spec_for((16, 6), ("embed", "heads"))  # 6 % 4 != 0 -> fallback
                b = tsh.spec_for((8, 128), ("batch", None))
                assert tsh.active_mesh() is mesh
            assert tsh.active_mesh() is None
        assert "data" in str(ok) and "model" in str(ok)
        assert "model" not in str(fb)
        assert "data" in str(b)
        assert ok == tsh.P("data", "model") and fb == tsh.P("data") and b == tsh.P("data")

    def test_multipod_batch_spans_pod_and_data(self):
        with fake_world(8):
            mesh = make_test_mesh((2, 2, 2), ("pod", "data", "model"), device_type="cpu")
            with tsh.use_mesh(mesh):
                s = tsh.spec_for((8, 64), ("batch", None))
                sh = tsh.sharding_for((8, 64), ("batch", None))
        assert "pod" in str(s) and "data" in str(s)
        assert s == tsh.P(("pod", "data"))
        # major to minor: dim 0 split over pod, then data, as jax orders the tuple
        assert _show(sh.placements) == ["S(0)", "S(0)", "R"]

    def test_shardings_of_a_tree_follow_its_logical_axes(self):
        cfg = get_config("qwen3_1_7b", reduced=True)
        with fake_world(4):
            mesh = make_test_mesh((2, 2), device_type="cpu")
            p = TS.params_specs(cfg)
            sh = tsh.tree_shardings(p, lambda path, leaf: ("embed", "mlp") if leaf.ndim == 2 else (None,) * leaf.ndim,
                                    mesh)
            assert sh["embed"]["table"].spec == tsh.P("data", "model")
            assert sh["final_norm"].spec == tsh.P() and sh["final_norm"].mesh is mesh
            ps = TS.params_shardings(p, mesh)
            assert [s.spec for s in tree_leaves(ps)] == [
                tsh.spec_for(a.shape, ax, mesh) for a, ax in zip(tree_leaves(p), _flatten_up_to(p, TM.param_logical_axes(p)))]

    def test_a_bound_function_sees_the_mesh_on_another_thread(self):
        """Autograd recomputes a checkpointed layer on its device thread
        (CUDA's), where the thread-local mesh is unset; ``bind_mesh``
        carries the forward's mesh there."""
        import threading

        seen = {}
        with fake_world(4):
            mesh = make_test_mesh((2, 2), device_type="cpu")
            with tsh.use_mesh(mesh):
                bound = tsh.bind_mesh(tsh.active_mesh)
                plain = tsh.active_mesh
                t = threading.Thread(target=lambda: seen.update(bound=bound(), plain=plain()))
                t.start()
                t.join()
        assert seen == {"bound": mesh, "plain": None}
        assert tsh.bind_mesh(plain) is plain  # no mesh: the function itself

    def test_a_mesh_must_be_a_device_mesh(self):
        with pytest.raises(TypeError, match="DeviceMesh"):
            with tsh.use_mesh(object()):
                pass

    def test_shard_is_the_identity_without_a_mesh(self):
        x = torch.arange(6.0).reshape(2, 3)
        assert tsh.shard(x, "batch", None) is x
        assert tsh.sharding_for((2, 3), ("batch", None)) is None
        assert tsh.spec_for((2, 3), ("batch", None)) == tsh.P()


# ---------------------------------------------------------------------------
# multi-rank cases: spawned gloo processes
# ---------------------------------------------------------------------------

_WORKER = textwrap.dedent("""
    import sys
    import numpy as np, torch, torch.distributed as dist
    torch.set_num_threads(1)
    mode, rank, world, store, out = sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), sys.argv[4], sys.argv[5]
    dist.init_process_group("gloo", init_method="file://" + store, rank=rank, world_size=world)
    from repro_torch.checkpoint import ckpt
    from repro_torch.checkpoint.ckpt import _flatten_up_to, tree_leaves
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.data.pipeline import DataConfig, Pipeline
    from repro_torch.distributed import sharding as sh
    from repro_torch.launch import specs as SP, steps as S
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.models import model as M
    from repro_torch.optim import adamw, grad_compress

    def local_shape_errors(tree, shardings):
        bad, sharded = 0, 0
        for leaf, s in zip(tree_leaves(tree), tree_leaves(shardings)):
            sizes = sh.axis_sizes(s.mesh)
            want = list(leaf.shape)
            for d, part in enumerate(s.spec):
                for a in (() if part is None else part if isinstance(part, tuple) else (part,)):
                    want[d] //= sizes[a]
            bad += tuple(leaf.to_local().shape) != tuple(want)
            sharded += tuple(want) != tuple(leaf.shape)
        return bad, sharded

    def save_full(tree, **extra):
        arrays = {f"leaf{i}": (a.full_tensor() if isinstance(a, sh.DTensor) else a).numpy()
                  for i, a in enumerate(tree_leaves(tree))}
        if rank == 0:
            np.savez(out, **arrays, **extra)

    cfg = get_config("qwen3_1_7b", reduced=True)
    try:
        if mode == "train":
            mesh = make_test_mesh((2, 2), device_type="cpu")
            sc = ShapeConfig("t", "train", 32, 4, microbatches=2)
            step = S.make_train_step(cfg, sc, compute_dtype=torch.float32, q_chunk=16, kv_chunk=16)
            batch = {k: torch.from_numpy(v) for k, v in Pipeline(cfg, DataConfig(0)).batch(0, 4, 32).items()}
            params = M.init_params(torch.Generator().manual_seed(0), cfg, device="cpu")
            with sh.use_mesh(mesh):
                p_sh = SP.params_shardings(SP.params_specs(cfg), mesh)
                params = sh.distribute(params, p_sh)
                opt = adamw.init(params)
                batch = sh.distribute(batch, SP.batch_shardings(batch, mesh))
                params, opt, m = step(params, opt, batch)
            bad_p, sharded = local_shape_errors(params, p_sh)
            bad_m, _ = local_shape_errors(opt["m"], p_sh)
            dt = all(isinstance(a, sh.DTensor) for a in tree_leaves(params) + tree_leaves(opt["m"]) + tree_leaves(opt["v"]))
            save_full(params, loss=m["loss"].full_tensor().numpy(), gnorm=m["grad_norm"].full_tensor().numpy(),
                      bad=np.int64(bad_p + bad_m), sharded=np.int64(sharded), all_dtensor=np.bool_(dt),
                      step=opt["step"].numpy())
        elif mode == "pod":
            mesh = make_test_mesh((4,), ("pod",), device_type="cpu")
            data = np.load(out + ".in.npz")
            g = {k[2:]: torch.from_numpy(data[k][rank]) for k in data.files}
            r = grad_compress.init_residuals(g)
            res = {}
            for rnd in range(3):
                g_avg, r = grad_compress.compressed_cross_pod_mean(g, r, group=mesh.get_group("pod"))
                res.update({f"a{rnd}_{k}": v.numpy() for k, v in g_avg.items()})
                res.update({f"r{rnd}_{k}": v.numpy() for k, v in r.items()})
            np.savez(out + f".{rank}.npz", **res)
        elif mode in ("save", "restore"):
            shape = (2, 2) if mode == "save" else (1, 2)
            mesh = make_test_mesh(shape, device_type="cpu")
            specs = SP.params_specs(cfg)
            p_sh = SP.params_shardings(specs, mesh)
            if mode == "save":
                params = M.init_params(torch.Generator().manual_seed(3), cfg, device="cpu")
                tree = {"params": sh.distribute(params, p_sh), "step": torch.tensor(7, dtype=torch.int32)}
                ckpt.save(out, 3, tree, extra={"ranks": world})
            else:
                target = {"params": specs, "step": torch.zeros((), dtype=torch.int32)}
                tree, step, extra = ckpt.restore(out + ".ck", target, shardings={"params": p_sh, "step": "cpu"})
                bad, sharded = local_shape_errors(tree["params"], p_sh)
                ok = all(isinstance(a, sh.DTensor) and a.device_mesh == mesh and tuple(a.placements) == s.placements
                         for a, s in zip(tree_leaves(tree["params"]), tree_leaves(p_sh)))
                save_full(tree["params"], step=np.int64(step), saved_by=np.int64(extra["ranks"]),
                          bad=np.int64(bad), sharded=np.int64(sharded), placed=np.bool_(ok),
                          ckpt_step=tree["step"].numpy())
        elif mode == "serve":
            mesh = make_test_mesh((2, 2), device_type="cpu")
            params = M.init_params(torch.Generator().manual_seed(0), cfg, device="cpu")
            toks = torch.from_numpy(np.random.default_rng(1).integers(0, cfg.vocab_size, (4, 24)).astype(np.int32))
            prefill = S.make_prefill_step(cfg, compute_dtype=torch.float32, q_chunk=8, kv_chunk=8)
            decode = S.make_decode_step(cfg, compute_dtype=torch.float32)
            with sh.use_mesh(mesh):
                p_sh = SP.params_shardings(SP.params_specs(cfg), mesh)
                params = sh.distribute(params, p_sh)
                c_specs = SP.cache_specs(cfg, 4, 32)
                cache = sh.distribute(M.init_cache(cfg, 4, 32, device="cpu"), SP.cache_shardings(c_specs, mesh))
                batch = {"tokens": toks[:, :16]}
                batch = sh.distribute(batch, SP.batch_shardings(batch, mesh))
                logits, cache = prefill(params, batch, cache)
                outs = [logits.full_tensor().numpy()]
                for i in range(3):
                    t_in = {"tokens": toks[:, 16 + i:17 + i], "pos": torch.full((4,), 16 + i, dtype=torch.int32)}
                    t_in = sh.distribute(t_in, SP.batch_shardings(t_in, mesh))
                    logits, cache = decode(params, t_in["tokens"], t_in["pos"], cache)
                    outs.append(logits.full_tensor().numpy())
            dt = all(isinstance(a, sh.DTensor) for a in tree_leaves(cache))
            if rank == 0:
                np.savez(out, logits=np.stack(outs), all_dtensor=np.bool_(dt))
    finally:
        dist.destroy_process_group()
""")


def _spawn(mode, world, tmp_path, out, tag=""):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), GLOO_SOCKET_IFNAME="lo", OMP_NUM_THREADS="1")
    store = tmp_path / f"store{tag}"
    procs = [subprocess.Popen([sys.executable, "-c", _WORKER, mode, str(rank), str(world), str(store), str(out)],
                              env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for rank in range(world)]
    logs = [p.communicate(timeout=300)[0] for p in procs]
    assert all(p.returncode == 0 for p in procs), "\n".join(logs)[-6000:]


def test_sharded_train_step_matches_one_device(tmp_path):
    out = tmp_path / "train.npz"
    _spawn("train", 4, tmp_path, out)
    cfg = get_config("qwen3_1_7b", reduced=True)
    sc = ShapeConfig("t", "train", 32, 4, microbatches=2)
    step = Tsteps.make_train_step(cfg, sc, compute_dtype=torch.float32, q_chunk=16, kv_chunk=16)
    batch = {k: torch.from_numpy(v) for k, v in Pipeline(cfg, DataConfig(0)).batch(0, 4, 32).items()}
    params = TM.init_params(torch.Generator().manual_seed(0), cfg, device="cpu")
    p1, o1, m1 = step(params, adamw.init(params), batch)
    got = np.load(out)
    assert abs(float(m1["loss"]) - float(got["loss"])) < 1e-3
    assert abs(float(m1["grad_norm"]) - float(got["gnorm"])) <= 1e-5 * float(m1["grad_norm"])
    mx = max(float(np.abs(got[f"leaf{i}"] - a.numpy()).max()) for i, a in enumerate(tree_leaves(p1)))
    assert mx < 2e-4, mx
    assert int(got["bad"]) == 0 and int(got["sharded"]) > 0 and bool(got["all_dtensor"])
    assert int(got["step"]) == 1


def test_grad_compress_over_a_pod_mesh_equals_stacked_pods(tmp_path):
    rng = np.random.default_rng(2)
    grads = {"w": rng.normal(size=(4, 32, 16)).astype(np.float32),
             "b": (rng.normal(size=(4, 16)) * 1e-3).astype(np.float32)}
    out = tmp_path / "pod"
    np.savez(str(out) + ".in.npz", **{f"g_{k}": v for k, v in grads.items()})
    _spawn("pod", 4, tmp_path, out)
    g = {k: torch.from_numpy(v) for k, v in grads.items()}
    r = grad_compress.init_residuals(g)
    outs = [np.load(f"{out}.{rank}.npz") for rank in range(4)]
    for rnd in range(3):
        g_avg, r = grad_compress.compressed_cross_pod_mean(g, r, group=grad_compress.StackedPods())
        for k in grads:
            np.testing.assert_array_equal(np.stack([o[f"a{rnd}_{k}"] for o in outs]), g_avg[k].numpy())
            np.testing.assert_array_equal(np.stack([o[f"r{rnd}_{k}"] for o in outs]), r[k].numpy())


def test_elastic_restore_from_four_ranks_into_two(tmp_path):
    ck = tmp_path / "restore.npz.ck"
    _spawn("save", 4, tmp_path, ck, tag="a")
    _spawn("restore", 2, tmp_path, tmp_path / "restore.npz", tag="b")
    cfg = get_config("qwen3_1_7b", reduced=True)
    want = TM.init_params(torch.Generator().manual_seed(3), cfg, device="cpu")
    got = np.load(tmp_path / "restore.npz")
    for i, a in enumerate(tree_leaves(want)):
        np.testing.assert_array_equal(got[f"leaf{i}"], a.numpy())
    assert int(got["step"]) == 3 and int(got["saved_by"]) == 4 and int(got["ckpt_step"]) == 7
    assert int(got["bad"]) == 0 and int(got["sharded"]) > 0 and bool(got["placed"])
    assert sorted(os.listdir(ck)) == ["LATEST", "step_3"]  # rank 0 alone wrote


def test_sharded_prefill_and_decode_match_one_device(tmp_path):
    out = tmp_path / "serve.npz"
    _spawn("serve", 4, tmp_path, out)
    cfg = get_config("qwen3_1_7b", reduced=True)
    params = TM.init_params(torch.Generator().manual_seed(0), cfg, device="cpu")
    toks = torch.from_numpy(np.random.default_rng(1).integers(0, cfg.vocab_size, (4, 24)).astype(np.int32))
    prefill = Tsteps.make_prefill_step(cfg, compute_dtype=torch.float32, q_chunk=8, kv_chunk=8)
    decode = Tsteps.make_decode_step(cfg, compute_dtype=torch.float32)
    logits, cache = prefill(params, {"tokens": toks[:, :16]}, TM.init_cache(cfg, 4, 32, device="cpu"))
    want = [logits.numpy()]
    for i in range(3):
        logits, cache = decode(params, toks[:, 16 + i:17 + i], torch.full((4,), 16 + i, dtype=torch.int32), cache)
        want.append(logits.numpy())
    want = np.stack(want)
    got = np.load(out)
    assert bool(got["all_dtensor"])
    real = want[..., :cfg.vocab_size]
    err = np.abs(got["logits"][..., :cfg.vocab_size] - real).max()
    assert err <= 1e-5 * max(1.0, np.abs(real).max()), err
