"""The port's checkpoints and fault-tolerance runtime against the JAX
package's, on the CPU.

* port counterparts of ``tests/test_substrate.py::TestCheckpoint``: the
  round trip, the LATEST pointer and keep-last GC, atomicity (a leaf that
  fails mid-save leaves the previous checkpoint intact), the resilient
  restart loop, and the straggler monitor;
* the container format crosses packages both ways: a tree of nested
  dict / list / tuple / None with int8, int32 and float32 leaves saved by
  ``repro.checkpoint.ckpt`` restores through the port with equal values and
  dtypes, and the port's save restores through ``repro``; the two
  ``manifest.json`` files and every ``leaf_<i>.npy`` are byte-identical;
* the flattening order, paths and ``treedef`` string equal
  ``jax.tree_util``'s on assorted trees;
* ``shardings`` as one device and as a tree of devices; with none, a leaf
  follows its target leaf;
* a bfloat16 leaf is refused.

Tolerance: 0 — every leaf is stored and read back as its own bytes.
"""
import os
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import ckpt as jckpt
from repro_torch.checkpoint import ckpt
from repro_torch.distributed.fault_tolerance import (
    CheckpointManager,
    CheckpointManagerConfig,
    StragglerMonitor,
    run_resilient,
)


def _tree(k=0):
    return {"a": torch.arange(6.0).reshape(2, 3) + k, "b": {"c": torch.ones((4,), dtype=torch.int32) * k}}


class TestCheckpoint:
    def test_roundtrip(self, tmp_path):
        d = str(tmp_path)
        ckpt.save(d, 5, _tree(2), extra={"note": "x"})
        restored, step, extra = ckpt.restore(d, _tree(0))
        assert step == 5 and extra == {"note": "x"}
        assert torch.equal(restored["a"], _tree(2)["a"])
        assert torch.equal(restored["b"]["c"], _tree(2)["b"]["c"])
        assert restored["b"]["c"].dtype == torch.int32

    def test_latest_pointer_and_gc(self, tmp_path):
        d = str(tmp_path)
        mgr = CheckpointManager(CheckpointManagerConfig(d, interval_steps=1, keep_last=2))
        for s in range(1, 5):
            mgr.maybe_save(s, _tree(s))
        assert ckpt.latest_step(d) == 4
        assert sorted(p for p in os.listdir(d) if p.startswith("step_")) == ["step_3", "step_4"]

    def test_atomic_no_partial_on_failure(self, tmp_path):
        d = str(tmp_path)
        ckpt.save(d, 1, _tree(1))

        class Boom:
            def __array__(self):
                raise RuntimeError("disk died")

        with pytest.raises(RuntimeError):
            ckpt.save(d, 2, {"a": Boom()})
        assert ckpt.latest_step(d) == 1  # old checkpoint intact
        assert not [p for p in os.listdir(d) if p.startswith(".tmp_")]
        restored, step, _ = ckpt.restore(d, _tree(0))
        assert step == 1 and torch.equal(restored["a"], _tree(1)["a"])

    def test_resilient_restart_loop(self, tmp_path):
        d = str(tmp_path)
        mgr = CheckpointManager(CheckpointManagerConfig(d, interval_steps=1))
        crashes = {"n": 0}

        def make_state():
            return {"x": torch.zeros(())}

        def step_fn(state, step):
            if step == 3 and crashes["n"] == 0:
                crashes["n"] += 1
                raise RuntimeError("node failure")
            return {"x": state["x"] + 1}

        final = run_resilient(make_state, step_fn, manager=mgr, total_steps=6)
        assert crashes["n"] == 1
        assert float(final["x"]) == 6.0  # all 6 steps applied exactly once

    def test_straggler_monitor(self):
        mon = StragglerMonitor(threshold=5.0)
        for s in range(3):
            mon.start_step()
            time.sleep(0.01)
            mon.end_step(s)
        mon.start_step()
        time.sleep(0.2)
        m = mon.end_step(3)
        assert m["straggler"] == 1.0 and mon.slow_steps == [3]


def _mixed(seed=0):
    """Nested dict / list / tuple / None with int8, int32 and float32 leaves
    (numpy), keys inserted out of order."""
    rng = np.random.default_rng(seed)
    return {
        "w": {"q": rng.integers(-128, 128, (3, 5)).astype(np.int8), "bias": rng.integers(-9, 9, (5,)).astype(np.int32)},
        "kv": [rng.integers(-128, 128, (2, 4, 3)).astype(np.int8), (rng.normal(size=(4,)).astype(np.float32), None)],
        "step": np.asarray(7, np.int32),
        "empty": {},
        "opt": (np.float32(0.5) * np.ones((2, 2), np.float32), [None]),
    }


def _as(tree, leaf_fn):
    if tree is None:
        return None
    if type(tree) is dict:
        return {k: _as(v, leaf_fn) for k, v in tree.items()}
    if type(tree) in (list, tuple):
        return type(tree)(_as(v, leaf_fn) for v in tree)
    return leaf_fn(tree)


def _pairs(a, b):
    """(leaf of a, leaf of b) at each position, walking both trees by key
    and index (not by any flattening order); the containers must match."""
    if a is None:
        assert b is None
        return []
    if type(a) is dict:
        assert type(b) is dict and sorted(a) == sorted(b)
        return [p for k in a for p in _pairs(a[k], b[k])]
    if type(a) in (list, tuple):
        assert type(b) is type(a) and len(a) == len(b)
        return [p for x, y in zip(a, b) for p in _pairs(x, y)]
    return [(a, b)]


def _port_leaves_t(tree):
    return [x for _, x in ckpt._flatten(tree)]


def _assert_same(restored, original):
    pairs = _pairs(restored, original)
    assert len(pairs) == 6
    for r, o in pairs:
        r, o = np.asarray(r), np.asarray(o)
        assert r.dtype == o.dtype and r.shape == o.shape
        np.testing.assert_array_equal(r, o)


class TestCrossPackage:
    def test_files_are_byte_identical(self, tmp_path):
        tree = _mixed()
        jckpt.save(str(tmp_path / "j"), 3, _as(tree, jnp.asarray), extra={"who": "repro"})
        ckpt.save(str(tmp_path / "t"), 3, _as(tree, torch.from_numpy), extra={"who": "repro"})
        jdir, tdir = tmp_path / "j" / "step_3", tmp_path / "t" / "step_3"
        names = sorted(os.listdir(jdir))
        assert names == sorted(os.listdir(tdir))
        assert names == sorted([f"leaf_{i}.npy" for i in range(6)] + ["manifest.json"])
        for name in names:
            assert (jdir / name).read_bytes() == (tdir / name).read_bytes(), name
        assert (tmp_path / "j" / "LATEST").read_bytes() == (tmp_path / "t" / "LATEST").read_bytes()

    def test_repro_checkpoint_restores_through_the_port(self, tmp_path):
        tree = _mixed(1)
        jckpt.save(str(tmp_path), 11, _as(tree, jnp.asarray), extra={"e": 1})
        got, step, extra = ckpt.restore(str(tmp_path), _as(_mixed(2), torch.from_numpy))
        assert step == 11 and extra == {"e": 1}
        _assert_same(_as(got, lambda t: t.numpy()), tree)
        assert got["kv"][1][1] is None and got["opt"][1] == [None] and got["empty"] == {}
        assert isinstance(got["kv"][1], tuple) and isinstance(got["kv"], list)

    def test_port_checkpoint_restores_through_repro(self, tmp_path):
        tree = _mixed(3)
        ckpt.save(str(tmp_path), 4, _as(tree, torch.from_numpy))
        got, step, _ = jckpt.restore(str(tmp_path), _as(_mixed(4), jnp.asarray))
        assert step == 4
        _assert_same(got, tree)

    @pytest.mark.parametrize("tree", [
        {"b": 1.0, "a": [2.0, (3.0, None)], "c": 3},
        5.0, None, {}, [], (), (1.0,), [None], {"k": {}}, {1: 1.0, 0: 2.0},
        {"a": [1.0, [], ()], "z": (None, None)}, [[1.0]], {"a b": 1.0, "q'": 2.0, 'd"': 3.0},
        (1.0, 2.0), {"x": None}, {10: 1.0, 2: 2.0, 1: 3.0},
    ], ids=lambda t: repr(t)[:40])
    def test_flattening_equals_jax(self, tree):
        flat = jax.tree_util.tree_flatten_with_path(tree)[0]
        jpaths = ["/".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in p) for p, _ in flat]
        paths, leaves = ckpt._paths_and_leaves(tree)
        assert paths == jpaths
        assert leaves == [leaf for _, leaf in flat]
        assert f"PyTreeDef({ckpt._treedef_str(tree)})" == str(jax.tree_util.tree_structure(tree))


class TestPlacement:
    def test_shardings_one_device(self, tmp_path):
        ckpt.save(str(tmp_path), 1, _as(_mixed(), torch.from_numpy))
        for dev in ("cpu", torch.device("cpu")):
            got, _, _ = ckpt.restore(str(tmp_path), _mixed(), shardings=dev)
            assert all(x.device.type == "cpu" for x in _port_leaves_t(got))

    def test_shardings_tree_and_mismatch(self, tmp_path):
        ckpt.save(str(tmp_path), 1, _tree(5))
        sh = {"a": "cpu", "b": {"c": None}}
        got, _, _ = ckpt.restore(str(tmp_path), _tree(0), shardings=sh)
        assert got["a"].device.type == "cpu" and torch.equal(got["b"]["c"], _tree(5)["b"]["c"])
        with pytest.raises(ValueError, match="shardings do not match"):
            ckpt.restore(str(tmp_path), _tree(0), shardings={"a": "cpu"})

    def test_no_shardings_follows_the_target(self, tmp_path):
        """A tensor target leaf gives its device; any other leaf gives a CPU
        tensor.  The target's values are not read."""
        ckpt.save(str(tmp_path), 2, {"t": torch.ones(3), "n": np.arange(3, dtype=np.int8), "s": 4})
        got, _, _ = ckpt.restore(str(tmp_path), {"t": torch.zeros(3), "n": np.zeros(3, np.int8), "s": 0})
        assert all(isinstance(v, torch.Tensor) and v.device.type == "cpu" for v in got.values())
        assert got["n"].dtype == torch.int8 and int(got["s"]) == 4

    def test_leaf_count_mismatch_raises(self, tmp_path):
        ckpt.save(str(tmp_path), 1, _tree(1))
        with pytest.raises(ValueError, match="checkpoint has 2 leaves; target expects 1"):
            ckpt.restore(str(tmp_path), {"a": torch.zeros(1)})
        with pytest.raises(FileNotFoundError):
            ckpt.restore(str(tmp_path / "none"), _tree(0))


def test_bfloat16_is_refused(tmp_path):
    ckpt.save(str(tmp_path), 1, _tree(1))
    with pytest.raises(TypeError, match="bfloat16"):
        ckpt.save(str(tmp_path), 2, {"a": torch.ones(2, dtype=torch.bfloat16)})
    assert ckpt.latest_step(str(tmp_path)) == 1
    assert sorted(os.listdir(tmp_path)) == ["LATEST", "step_1"]
