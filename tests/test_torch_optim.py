"""The port's optimizer side (``repro_torch.optim``) against ``repro.optim`` on
the CPU.

* Schedules (``warmup_cosine``, ``wsd``) at every step of short runs:
  ``wsd`` and the warmup within 1 float32 ulp of ``repro``'s; the cosine
  phase within 1 ulp of ``peak_lr``, absolute.  XLA's and PyTorch's float32
  ``cos`` are each within 1 ulp of the true value but can differ from each
  other by 1 ulp, and ``1 + cos`` magnifies that near the cosine's end
  (measured: up to 5 ulps of the value, 2.1e-4 at peak 1e-3).
* ``adamw.update`` from identical numpy grads, state and params, with and
  without the clip path, over several steps: new params, moments and the
  reported grad norm within 1e-6 relative (float32 sums of the norm in
  other orders); ``step`` equal.  The in-place form equals the functional
  one bit for bit.  ``repro``'s ``TestOptim`` cases, mirrored.
* ``grad_compress`` against ``repro``'s ``compressed_cross_pod_mean`` under
  ``jax.vmap(..., axis_name="pod")`` over 2 and 4 stacked pods: in one
  process (:class:`~repro_torch.optim.grad_compress.StackedPods`) and in a
  gloo group of 2 processes.  The int8 codes (recovered from each result
  as round((g_eff − residual) / s) and round(mean · n / s)) are equal;
  averages within 1e-6 · max |avg|; residuals (g_eff − s·q, a difference
  of nearly equal values that XLA may fuse into one rounding) within 1e-6
  · max |g_eff| (measured: 4.8e-8 at max |g_eff| ≈ 3).
"""
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.optim import adamw as Jadamw
from repro.optim import grad_compress as Jgc
from repro.optim import schedule as Jsched
from repro_torch.optim import adamw, grad_compress, schedule
from repro_torch.checkpoint.ckpt import tree_leaves

ROOT = Path(__file__).resolve().parents[1]

SCHEDULE_CASES = [
    ("warmup_cosine", dict(peak_lr=1e-3, warmup_steps=2, total_steps=20)),
    ("warmup_cosine", dict(peak_lr=3e-4, warmup_steps=100, total_steps=1000, final_frac=0.1)),
    ("warmup_cosine", dict(peak_lr=1.0, warmup_steps=0, total_steps=37, final_frac=0.0)),
    ("wsd", dict(peak_lr=3e-4, warmup_steps=10, stable_steps=50, decay_steps=40)),
    ("wsd", dict(peak_lr=1.0, warmup_steps=0, stable_steps=7, decay_steps=1, final_frac=0.5)),
]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Run this module's eager steps on one intra-op thread: the suite runs
    in parallel workers, and the port's small steps on PyTorch's full thread
    pool crawl when the workers oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("name,kw", SCHEDULE_CASES, ids=[f"{n}-{i}" for i, (n, _) in enumerate(SCHEDULE_CASES)])
def test_schedule_within_one_ulp_at_every_step(name, kw):
    n = kw.get("total_steps", kw.get("warmup_steps", 0) + kw.get("stable_steps", 0) + kw.get("decay_steps", 0))
    steps = np.arange(0, n + 5, dtype=np.int32)
    want = np.asarray(Jsched.SCHEDULES[name](jnp.asarray(steps), **kw))
    got = schedule.SCHEDULES[name](torch.from_numpy(steps), **kw)
    assert got.dtype == torch.float32
    assert np.abs(got.numpy() - want).max() <= np.spacing(np.float32(kw["peak_lr"]))
    exact = steps < kw["warmup_steps"] if name == "warmup_cosine" else np.ones(want.shape, bool)
    np.testing.assert_array_max_ulp(got.numpy()[exact], want[exact], maxulp=1)
    for s in (0, int(n // 2), int(n)):  # a host int step, as a launcher passes it
        a = schedule.SCHEDULES[name](s, **kw).numpy()
        assert abs(float(a) - float(Jsched.SCHEDULES[name](s, **kw))) <= np.spacing(np.float32(kw["peak_lr"]))


def _tree(rng, scale=1.0):
    return {"b": {"w": (rng.normal(size=(16, 8)) * scale).astype(np.float32),
                  "v": (rng.normal(size=(5,)) * scale).astype(np.float32)},
            "a": (rng.normal(size=(3, 4, 2)) * scale).astype(np.float32)}


def _rel(got, want):
    return float(np.abs(got - want).max()) / max(1e-30, float(np.abs(want).max()))


@pytest.mark.parametrize("clip", [None, 1.0, 1e3])
def test_adamw_update_matches_repro(clip):
    rng = np.random.default_rng(0)
    cfg_j = Jadamw.AdamWConfig(grad_clip_norm=clip)
    cfg_t = adamw.AdamWConfig(grad_clip_norm=clip)
    pj = jax.tree.map(jnp.asarray, _tree(rng))
    pt = jax.tree.map(lambda a: torch.from_numpy(np.asarray(a).copy()), pj)
    sj, st = Jadamw.init(pj), adamw.init(pt)
    for step in range(4):
        g = _tree(rng, scale=10.0 ** (step - 1))
        lr = np.float32(1e-2 * (step + 1))
        pj, sj, mj = Jadamw.update(jax.tree.map(jnp.asarray, g), sj, pj, jnp.asarray(lr), cfg_j)
        pt, st, mt = adamw.update(jax.tree.map(torch.from_numpy, g), st, pt, torch.tensor(lr), cfg_t)
        assert st["step"].dtype == torch.int32 and int(st["step"]) == int(sj["step"]) == step + 1
        assert _rel(mt["grad_norm"].numpy(), np.asarray(mj["grad_norm"])) <= 1e-6
        for tree_t, tree_j in ((pt, pj), (st["m"], sj["m"]), (st["v"], sj["v"])):
            for a, b in zip(tree_leaves(tree_t), jax.tree.leaves(tree_j)):
                assert _rel(a.numpy(), np.asarray(b)) <= 1e-6


def test_adamw_inplace_equals_functional():
    rng = np.random.default_rng(1)
    p = jax.tree.map(torch.from_numpy, _tree(rng))
    g = jax.tree.map(torch.from_numpy, _tree(rng, 100.0))
    s = adamw.init(p)
    p2 = jax.tree.map(torch.clone, p)
    s2 = {"m": jax.tree.map(torch.clone, s["m"]), "v": jax.tree.map(torch.clone, s["v"]), "step": s["step"].clone()}
    want_p, want_s, want_m = adamw.update(g, s, p, torch.tensor(0.01))
    got_p, got_s, got_m = adamw.update(g, s2, p2, torch.tensor(0.01), inplace=True)
    assert got_p is p2 and got_s is s2
    for a, b in zip(tree_leaves((got_p, got_s)), tree_leaves((want_p, want_s))):
        assert torch.equal(a, b)
    assert torch.equal(got_m["grad_norm"], want_m["grad_norm"])


def test_global_norm_sums_in_repro_leaf_order():
    t = {"z": np.float32([3.0]), "a": {"y": np.float32([4.0]), "b": np.float32([12.0])}}
    assert float(adamw.global_norm(jax.tree.map(torch.from_numpy, t))) == float(Jadamw.global_norm(t)) == 13.0
    assert [float(x) for x in tree_leaves(jax.tree.map(torch.from_numpy, t))] == [12.0, 4.0, 3.0]


class TestOptim:
    """``tests/test_substrate.py::TestOptim``, on the port."""

    def test_adamw_converges_quadratic(self):
        params = {"w": torch.tensor([3.0, -2.0])}
        opt = adamw.init(params)
        cfg = adamw.AdamWConfig(weight_decay=0.0, grad_clip_norm=None)
        for _ in range(300):
            g = {"w": 2 * params["w"]}
            params, opt, _ = adamw.update(g, opt, params, torch.tensor(0.05), cfg)
        assert float(params["w"].abs().max()) < 0.05

    def test_grad_clip(self):
        params = {"w": torch.zeros(3)}
        opt = adamw.init(params)
        g = {"w": torch.full((3,), 1e6)}
        _, _, m = adamw.update(g, opt, params, torch.tensor(1e-3), adamw.AdamWConfig(grad_clip_norm=1.0))
        assert float(m["grad_norm"]) > 1e5  # reported pre-clip

    def test_schedules(self):
        wc = schedule.warmup_cosine(torch.arange(0, 1000, 100), peak_lr=1.0, warmup_steps=100, total_steps=1000)
        assert float(wc[0]) == 0.0 and float(wc[1]) == 1.0
        assert float(wc[-1]) < 0.5
        w = schedule.wsd(torch.tensor([0, 50, 100, 500, 900, 999]), peak_lr=1.0, warmup_steps=100,
                         stable_steps=700, decay_steps=200)
        np.testing.assert_allclose(w[2:4].numpy(), [1.0, 1.0])  # stable phase
        assert float(w[-1]) < 0.2  # decay phase

    def test_wsd_stable_phase_flat_then_decays(self):
        vals = schedule.wsd(torch.arange(100, 800, 50), peak_lr=2e-4, warmup_steps=100, stable_steps=600,
                            decay_steps=100)
        assert np.allclose(vals[:-1].numpy(), 2e-4)


# ---------------------------------------------------------------------------
# grad_compress
# ---------------------------------------------------------------------------


def _pod_grads(n_pods, seed=0):
    rng = np.random.default_rng(seed)
    return ({"w": rng.normal(size=(n_pods, 16, 12)).astype(np.float32),
             "b": (rng.normal(size=(n_pods, 12)) * 1e-3).astype(np.float32)},
            {"w": (rng.normal(size=(n_pods, 16, 12)) * 1e-2).astype(np.float32),
             "b": np.zeros((n_pods, 12), np.float32)})


def _repro_rounds(grads, res, rounds):
    fn = jax.jit(jax.vmap(lambda g, r: Jgc.compressed_cross_pod_mean(g, r, axis="pod"), axis_name="pod"))
    out = []
    g, r = jax.tree.map(jnp.asarray, grads), jax.tree.map(jnp.asarray, res)
    for _ in range(rounds):
        avg, r_new = fn(g, r)
        out.append((jax.tree.map(np.asarray, avg), jax.tree.map(np.asarray, r_new), jax.tree.map(np.asarray, r)))
        r = r_new
    return out


def _codes(avg, res_new, res_old, g):
    """(per-pod codes, summed codes) recovered from a round's result."""
    g_eff = g.astype(np.float32) + res_old
    s = np.float32(np.abs(g_eff).max() / np.float32(127)) + np.float32(1e-20)
    n = g.shape[0]
    return np.rint((g_eff - res_new) / s).astype(np.int64), np.rint(avg * n / s).astype(np.int64)


def _check_round(got_avg, got_res, want, grads):
    want_avg, want_res, res_old = want
    for k in grads:
        ga, gr = np.asarray(got_avg[k]), np.asarray(got_res[k])
        g_eff = np.abs(grads[k] + res_old[k]).max()
        assert _rel(ga, want_avg[k]) <= 1e-6 and np.abs(gr - want_res[k]).max() <= 1e-6 * g_eff
        for a, b in zip(_codes(ga, gr, res_old[k], grads[k]), _codes(want_avg[k], want_res[k], res_old[k], grads[k])):
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("n_pods", [2, 4])
def test_compressed_mean_stacked_pods_matches_repro_vmap(n_pods):
    grads, res = _pod_grads(n_pods)
    want = _repro_rounds(grads, res, 3)
    r = jax.tree.map(torch.from_numpy, res)
    for rnd in range(3):
        avg, r_new = grad_compress.compressed_cross_pod_mean(
            jax.tree.map(torch.from_numpy, grads), r, group=grad_compress.StackedPods())
        _check_round(jax.tree.map(lambda t: t.numpy(), avg), jax.tree.map(lambda t: t.numpy(), r_new),
                     want[rnd], grads)
        r = r_new


def test_uncompressed_mean_and_init_residuals_stacked():
    grads, _ = _pod_grads(4)
    got = grad_compress.uncompressed_cross_pod_mean(jax.tree.map(torch.from_numpy, grads),
                                                    group=grad_compress.StackedPods())
    want = jax.vmap(lambda g: Jgc.uncompressed_cross_pod_mean(g, axis="pod"), axis_name="pod")(grads)
    for k in grads:
        assert _rel(got[k].numpy(), np.asarray(want[k])) <= 1e-6
    res = grad_compress.init_residuals(jax.tree.map(torch.from_numpy, grads))
    assert all(r.dtype == torch.float32 and not r.any() for r in tree_leaves(res))


def test_error_feedback_kills_the_bias():
    """``tests/test_distributed.py::TestGradCompression``'s property over 8
    stacked pods: one round int8-accurate, 50 rounds' sum unbiased."""
    g = torch.from_numpy(np.random.default_rng(0).normal(size=(8, 64)).astype(np.float32))
    true_mean = g.mean(dim=0)
    res = torch.zeros_like(g)
    total = torch.zeros(64)
    for _ in range(50):
        gm, r = grad_compress.compressed_cross_pod_mean({"w": g}, {"w": res}, group=grad_compress.StackedPods())
        res = r["w"]
        total += gm["w"][0]
    assert float((gm["w"][0] - true_mean).abs().max() / true_mean.abs().max()) < 0.05
    assert float((total - 50 * true_mean).abs().max() / (50 * true_mean).abs().max()) < 0.005


_WORKER = textwrap.dedent("""
    import sys, numpy as np, torch, torch.distributed as dist
    from repro_torch.optim import grad_compress
    rank, world, store, src, dst = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4], sys.argv[5]
    dist.init_process_group("gloo", init_method="file://" + store, rank=rank, world_size=world)
    try:
        data = np.load(src)
        g = {k[2:]: torch.from_numpy(data[k][rank]) for k in data if k.startswith("g_")}
        r = {k[2:]: torch.from_numpy(data[k][rank]) for k in data if k.startswith("r_")}
        out = {}
        for rnd in range(3):
            avg, r = grad_compress.compressed_cross_pod_mean(g, r)
            out.update({f"a{rnd}_{k}": v.numpy() for k, v in avg.items()})
            out.update({f"r{rnd}_{k}": v.numpy() for k, v in r.items()})
        mean = grad_compress.uncompressed_cross_pod_mean(g)
        out.update({f"m_{k}": v.numpy() for k, v in mean.items()})
        np.savez(dst, **out)
    finally:
        dist.destroy_process_group()
""")


def test_compressed_mean_gloo_group_of_two_matches_repro(tmp_path):
    grads, res = _pod_grads(2, seed=1)
    src = tmp_path / "in.npz"
    np.savez(src, **{f"g_{k}": v for k, v in grads.items()}, **{f"r_{k}": v for k, v in res.items()})
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), GLOO_SOCKET_IFNAME="lo")
    procs = [subprocess.Popen([sys.executable, "-c", _WORKER, str(rank), "2", str(tmp_path / "store"), str(src),
                               str(tmp_path / f"out{rank}.npz")], env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True) for rank in range(2)]
    logs = [p.communicate(timeout=120)[0] for p in procs]
    assert all(p.returncode == 0 for p in procs), "\n".join(logs)
    want = _repro_rounds(grads, res, 3)
    outs = [np.load(tmp_path / f"out{rank}.npz") for rank in range(2)]
    for rnd in range(3):
        avg = {k: np.stack([o[f"a{rnd}_{k}"] for o in outs]) for k in grads}
        r_new = {k: np.stack([o[f"r{rnd}_{k}"] for o in outs]) for k in grads}
        _check_round(avg, r_new, want[rnd], grads)
    for k in grads:
        mean = np.stack([o[f"m_{k}"] for o in outs])
        assert _rel(mean, np.broadcast_to(grads[k].mean(axis=0), mean.shape)) <= 1e-6
