"""The port's AOT plan artifacts against the JAX package's, on the CPU.

Mirrors ``tests/test_plan_artifact.py``: ``load_artifact`` rebuilds a served
compiled model **without re-running passes, fusion or lowering** (no
``compile.fuse`` / ``compile.lower`` span on load), pre-seeds the plan cache
with the hot cells recorded at save (serving them specializes nothing new),
and round-trips provenance, the tuned ``(bm, splits)`` / cluster tiles with
their ``[tuned]`` tags, and the token path's KV state slots.  Constants are
tensors on the plan's device and cross the boundary through the npz
sidecar, dtypes kept.  A document without ``"package": "repro_torch"`` — one
``repro`` saved — is refused.

Differential: a loaded port artifact serves bit-exactly against ``repro``'s
compiled model and against the unsaved port model, over the grid.
``scripts/plan_diff.py`` (unedited) reads port artifacts; a ``repro``
artifact and a port artifact of the same MLP differ only in the backend row
and the tile rows (``TestPlanDiff.test_repro_and_port_artifacts_differ_only_in_tiles``).

Tolerance: 0 — integer paths are bit-exact.
"""
import json
import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro.backend.artifact import save_artifact as jsave_artifact
from repro.core import patterns as jpatterns
from repro.core import pqir as jpqir
from repro.core import quant as jquant
from repro.core.compile import compile_model as jcompile
from repro.core.toolchain import MLPSpec, quantize_mlp
from repro_torch.backend import cost
from repro_torch.backend.artifact import (
    ARTIFACT_SCHEMA,
    PACKAGE,
    load_artifact,
    save_artifact,
    sidecar_path,
)
from repro_torch.backend.autotune import Autotuner
from repro_torch.backend.plan import bindings_key
from repro_torch.core.compile import compile_model
from repro_torch.core.pqir import Model
from repro_torch.obs import trace as _trace
from repro_torch.serving.token_path import CompiledTokenPath, TokenPathConfig

ROOT = Path(__file__).resolve().parents[1]


def _port(model) -> Model:
    return Model.from_json(model.to_json())


def _mlp_model(seed=21, name="aot_mlp", acts=("Relu", None), widths=(16, 32, 8)):
    rng = np.random.default_rng(seed)
    spec = MLPSpec(
        weights=[rng.normal(size=(a, b)).astype(np.float32) * 0.2
                 for a, b in zip(widths, widths[1:])],
        biases=[rng.normal(size=(b,)).astype(np.float32) * 0.1 for b in widths[1:]],
        activations=list(acts),
    )
    calib = rng.normal(size=(64, widths[0])).astype(np.float32)
    return quantize_mlp(spec, calib, name=name), rng


def _seq_model():
    """A ('N', 'S', 16) two-axis model: the artifact's hot cells live on a
    (batch bucket x seq bucket) grid, not a single free axis."""
    rng = np.random.default_rng(31)
    p = jquant.quantize_linear_layer(
        rng.normal(size=(16, 8)).astype(np.float32) * 0.2,
        rng.normal(size=(8,)).astype(np.float32) * 0.1, 0.05, 0.1,
    )
    gb = jpqir.GraphBuilder("aot_seq")
    x = gb.add_input("x", "int8", ("N", "S", 16))
    y = jpatterns.fc_layer(gb, x, p, "fc0", two_mul=True, activation="Relu")
    gb.add_output(y, "int8", ("N", "S", 8))
    return gb.build(), rng


def _cost_measure(step, shape, backend):
    """Deterministic timing oracle: the analytic cost model of a qmatmul;
    an attention launch's operations spread over its B·S·C blocks."""
    if "cluster" in shape:
        ops = 4.0 * shape["b"] * shape["s"] * shape["t"] * shape["dh"]
        return cost.wave_cost(ops, 0.0, shape["b"] * shape["s"] * shape["cluster"])
    return cost.qmatmul_tile_cost(shape["m"], shape["k"], shape["n"], shape["kp"], shape["np"],
                                  shape["bm"], shape["splits"], weight_bits=shape.get("bits", 8))


def _saved_mlp(tmp_path, backend="ref", batches=(2,), name="r.json", widths=(16, 32, 8), **kw):
    model, rng = _mlp_model(widths=widths, **kw)
    cm = compile_model(_port(model), backend=backend, device="cpu", batch="dynamic")
    for n in batches:
        cm.run({cm.input_names[0]: rng.integers(-128, 128, (n, widths[0])).astype(np.int8)})
    path = str(tmp_path / name)
    save_artifact(cm, path)
    return cm, path, rng


class TestRoundTrip:
    @pytest.mark.parametrize("backend", ["ref", "cuda"])
    def test_bit_exact_across_the_grid(self, tmp_path, backend):
        """A loaded artifact matches repro's compiled model and the unsaved
        port model bit-for-bit, on recorded cells and on a cell the load
        never saw."""
        model, rng = _seq_model()
        cm = compile_model(_port(model), backend=backend, device="cpu",
                           dynamic_axes={"N": None, "S": 8})
        inp = cm.input_names[0]
        feeds = {
            (n, s): rng.integers(-128, 128, (n, s, 16)).astype(np.int8)
            for n, s in [(2, 5), (4, 8), (2, 13)]
        }
        for x in feeds.values():
            cm.run({inp: x})
        path = str(tmp_path / "seq.json")
        save_artifact(cm, path)

        loaded = load_artifact(path, device="cpu")
        jcm = jcompile(model, backend="ref", dynamic_axes={"N": None, "S": 8})
        feeds[(8, 24)] = rng.integers(-128, 128, (8, 24, 16)).astype(np.int8)
        for x in feeds.values():
            got = loaded.run({inp: x})
            want = jcm.run({inp: x})
            unsaved = cm.run({inp: x})
            assert set(got) == set(want) == set(unsaved)
            for k in want:
                np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))
                assert torch.equal(got[k], unsaved[k])

    @pytest.mark.parametrize("backend", ["ref", "cuda"])
    def test_model_and_plan_structure_survive(self, tmp_path, backend):
        cm, path, _ = _saved_mlp(tmp_path, backend=backend, batches=(4,),
                                 acts=("Tanh", "Sigmoid", None), widths=(16, 32, 32, 8))
        loaded = load_artifact(path, device="cpu")
        assert loaded.input_names == cm.input_names
        assert loaded.output_names == cm.output_names
        assert loaded.plan.backend == cm.plan.backend == backend
        assert loaded.plan.num_slots == cm.plan.num_slots
        assert loaded.plan.axes == cm.plan.axes
        assert len(loaded.plan.steps) == len(cm.plan.steps)
        for a, b in zip(loaded.plan.steps, cm.plan.steps):
            assert (a.kernel, a.kind, a.name) == (b.kernel, b.kind, b.name)
            assert a.out_slots == b.out_slots and a.outputs == b.outputs
            assert a.params == b.params  # params encode losslessly
            assert len(a.consts) == len(b.consts)
            for ca, cb in zip(a.consts, b.consts):  # tensors stay tensors, dtypes kept
                assert type(ca) is type(cb)
                if isinstance(cb, torch.Tensor):
                    assert ca.dtype == cb.dtype and torch.equal(ca, cb)
                else:
                    np.testing.assert_array_equal(ca, cb)
        assert loaded.plan.pretty(verbose=True) == cm.plan.pretty(verbose=True)
        assert loaded.stats == cm.stats
        assert loaded.axis_specs == cm.axis_specs
        assert loaded.plan_cache_capacity == cm.plan_cache_capacity
        if backend == "cuda":
            assert loaded.stats["lut_epilogues"] == 2  # the folded tables came along

    def test_save_returns_path_and_writes_sidecar(self, tmp_path):
        model, _ = _mlp_model()
        cm = compile_model(_port(model), backend="ref", device="cpu", batch="dynamic")
        path = str(tmp_path / "a.json")
        assert save_artifact(cm, path) == path
        assert (tmp_path / "a.npz").exists()
        doc = json.load(open(path))
        assert doc["schema"] == ARTIFACT_SCHEMA and doc["package"] == PACKAGE
        assert all(c is None or set(c) == {"key", "tensor"}
                   for s in doc["plan"]["steps"] for c in s["consts"])
        assert sidecar_path("x/y.json") == "x/y.npz"
        assert sidecar_path("bare") == "bare.npz"

    def test_token_path_decode_plan_round_trips_its_kv_state(self, tmp_path):
        tuner = Autotuner(budget=4, measure_fn=_cost_measure)
        tp = CompiledTokenPath(TokenPathConfig(), backend="cuda", device="cpu", s_granularity=8,
                               autotune=tuner)
        rng = np.random.default_rng(5)
        n, s = 2, 16
        cache = tp.init_cache(n, s)
        for name in cache:
            cache[name] = torch.from_numpy(rng.integers(-128, 128, (n, s, 64)).astype(np.int8))
        toks = rng.integers(1, 128, (n, 1)).astype(np.int32)
        want_logits, want_cache = tp.decode_step(toks, np.array([9, 4]), cache)
        path = str(tmp_path / "decode.json")
        save_artifact(tp.decode_cm, path)
        doc = json.load(open(path))
        assert len(doc["plan"]["states"]) == 2 * 2  # (k, v) per layer
        assert [c["bindings"] for c in doc["cells"]] == [{"N": 2, "S": 16}]  # decode's own cell

        loaded = load_artifact(path, device="cpu", warm=True)
        assert loaded.plan.states == tp.decode_cm.plan.states
        feeds = tp.decode_feeds(toks, np.array([9, 4]), cache)
        outs = loaded.run(feeds)
        assert torch.equal(outs[loaded.output_names[0]][:, 0, :], want_logits)
        for st in loaded.plan.states:
            assert torch.equal(outs[st.output], want_cache[st.input])
        assert loaded.cache_stats["misses"] == 0 and loaded.cache_stats["hits"] == 1


class TestWarmStart:
    def test_load_emits_no_fuse_or_lower_span(self, tmp_path):
        """The acceptance gate: zero re-compilation on load.  Only
        backend.specialize fires (one per pre-seeded cell)."""
        _, path, _ = _saved_mlp(tmp_path, backend="cuda", batches=(2, 8))
        tracer = _trace.install()
        try:
            load_artifact(path, device="cpu")
        finally:
            _trace.uninstall()
        assert tracer.spans("compile.fuse") == []
        assert tracer.spans("compile.lower") == []
        assert len(tracer.spans("backend.specialize")) == 2

    def test_recorded_cells_serve_with_zero_new_specializations(self, tmp_path):
        _, path, rng = _saved_mlp(tmp_path, backend="cuda", batches=(2, 4, 8))
        loaded = load_artifact(path, device="cpu")
        # pre-seeding is by put, not get: the counters start clean
        assert loaded.cache_stats["hits"] == 0 and loaded.cache_stats["misses"] == 0
        assert sorted(loaded.plan_cache.keys()) == [bindings_key({"N": n}) for n in (2, 4, 8)]
        inp = loaded.input_names[0]
        for n in (2, 4, 8):
            loaded.run({inp: rng.integers(-128, 128, (n, 16)).astype(np.int8)})
        stats = loaded.cache_stats
        assert stats["misses"] == 0 and stats["hits"] == 3  # nothing re-specialized
        # an unrecorded cell still specializes lazily, exactly once
        loaded.run({inp: rng.integers(-128, 128, (16, 16)).astype(np.int8)})
        assert loaded.cache_stats["misses"] == 1

    def test_warm_true_runs_each_cell(self, tmp_path, monkeypatch):
        from repro_torch.backend.plan import ExecutionPlan

        _, path, rng = _saved_mlp(tmp_path, backend="cuda", batches=(4, 8))
        ran = []
        real = ExecutionPlan.execute
        monkeypatch.setattr(ExecutionPlan, "execute",
                            lambda self, feeds: ran.append(self.batch) or real(self, feeds))
        loaded = load_artifact(path, device="cpu", warm=True)
        assert sorted(ran) == [4, 8]  # one zero-feed run per recorded cell
        out = loaded.run({loaded.input_names[0]: rng.integers(-128, 128, (4, 16)).astype(np.int8)})
        assert loaded.cache_stats["hits"] == 1 and loaded.cache_stats["misses"] == 0
        assert out[loaded.output_names[0]].shape == (4, 8)


class TestProvenance:
    def test_passes_and_fusions_carry_over_verbatim(self, tmp_path):
        cm, path, _ = _saved_mlp(tmp_path, backend="cuda", batches=(4,))
        loaded = load_artifact(path, device="cpu")
        want = cm.plan.provenance.to_dict()
        got = loaded.plan.provenance.to_dict()
        assert got["passes"] == want["passes"]
        assert got["fusions"] == want["fusions"]
        # the live record re-accumulates the hot cells as they are re-seeded
        assert [ev["bindings"] for ev in got["specializations"]] == [
            ev["bindings"] for ev in want["specializations"]
        ]
        # the artifact JSON itself retains the saved history verbatim
        # (up to JSON's tuple -> list normalization)
        doc = json.load(open(path))
        assert doc["provenance"] == json.loads(json.dumps(want))

    def test_tuned_tile_tags_round_trip(self, tmp_path):
        """Tiles picked by a measured search come back ``[tuned]``, with the
        tuned (bm, splits) and cluster choices themselves."""
        tp = CompiledTokenPath(TokenPathConfig(d_model=128, d_ff=256), backend="cuda",
                               device="cpu", s_granularity=8,
                               autotune=Autotuner(measure_fn=_cost_measure))
        cm = tp.decode_cm
        key = cm.cache_key({"N": 4, "S": 32})
        plan, _ = cm.specialized({"N": 4, "S": 32})

        def tiles(p):
            return {s.name: (s.params["shape"].get("bm"), s.params["shape"].get("splits"),
                             s.params["shape"].get("cluster"))
                    for s in p.steps
                    if isinstance(s.params.get("shape"), dict)
                    and ("bm" in s.params["shape"] or "cluster" in s.params["shape"])}

        tuned = tiles(plan)
        heuristic = tiles(
            CompiledTokenPath(TokenPathConfig(d_model=128, d_ff=256), backend="cuda",
                              device="cpu", s_granularity=8)
            .decode_cm.specialized({"N": 4, "S": 32})[0])
        assert tuned != heuristic  # the search moved some tiles

        path = str(tmp_path / "tuned.json")
        save_artifact(cm, path)
        (cell,) = json.load(open(path))["cells"]
        assert set(cell["tiles"]) == set(tuned)
        for name, rec in cell["tiles"].items():
            assert rec["source"] == "tuned"
            assert (rec.get("bm"), rec.get("splits"), rec.get("cluster")) == tuned[name]

        loaded = load_artifact(path, device="cpu", plan_cache=None)
        lplan, _ = loaded.plan_cache.peek(bindings_key({"N": 4, "S": 32}))
        assert tiles(lplan) == tuned
        ev = loaded.plan.provenance.specializations[-1]
        assert ev.tiles and all(rec.endswith(" [tuned]") for _, rec in ev.tiles)
        assert key[1] == bindings_key({"N": 4, "S": 32})  # saved from a shared cache

    def test_loaded_model_takes_a_tuner_for_new_cells(self, tmp_path):
        _, path, rng = _saved_mlp(tmp_path, backend="cuda", batches=(2,), widths=(256, 256, 64))
        tuner = Autotuner(budget=3, measure_fn=_cost_measure)
        loaded = load_artifact(path, device="cpu", autotuner=tuner)
        loaded.run({loaded.input_names[0]: rng.integers(-128, 128, (2, 256)).astype(np.int8)})
        assert tuner.measurements == 0  # a recorded cell replays its tiles
        loaded.run({loaded.input_names[0]: rng.integers(-128, 128, (32, 256)).astype(np.int8)})
        assert tuner.measurements > 0


class TestRejection:
    def _rewrite(self, path, fn):
        doc = json.load(open(path))
        fn(doc)
        json.dump(doc, open(path, "w"))

    def test_schema_version_mismatch_rejected(self, tmp_path):
        _, path, _ = _saved_mlp(tmp_path)
        self._rewrite(path, lambda d: d.update(schema="repro-plan-v0"))
        with pytest.raises(ValueError, match="schema"):
            load_artifact(path, device="cpu")

    def test_missing_schema_rejected(self, tmp_path):
        _, path, _ = _saved_mlp(tmp_path)
        self._rewrite(path, lambda d: d.pop("schema"))
        with pytest.raises(ValueError, match="schema"):
            load_artifact(path, device="cpu")

    def test_corrupt_json_rejected(self, tmp_path):
        _, path, _ = _saved_mlp(tmp_path)
        with open(path, "w") as f:
            f.write('{"schema": "repro-plan-v1", "plan": {')
        with pytest.raises(ValueError, match="corrupt"):
            load_artifact(path, device="cpu")

    def test_sidecar_digest_mismatch_rejected(self, tmp_path):
        _, path, _ = _saved_mlp(tmp_path)
        with open(sidecar_path(path), "ab") as f:
            f.write(b"\x00")  # truncation and tampering look the same: bad digest
        with pytest.raises(ValueError, match="digest"):
            load_artifact(path, device="cpu")

    def test_missing_sidecar_rejected(self, tmp_path):
        _, path, _ = _saved_mlp(tmp_path)
        os.unlink(sidecar_path(path))
        with pytest.raises(ValueError, match="sidecar"):
            load_artifact(path, device="cpu")

    def test_callable_bucketing_policy_rejected_at_save(self, tmp_path):
        model, _ = _mlp_model()
        cm = compile_model(_port(model), backend="ref", device="cpu",
                           dynamic_axes={"N": lambda n: max(1, n)})
        with pytest.raises(ValueError, match="callable"):
            save_artifact(cm, str(tmp_path / "cb.json"))

    def test_a_repro_artifact_is_refused(self, tmp_path):
        model, rng = _mlp_model()
        jcm = jcompile(model, backend="ref", batch="dynamic")
        jcm.run({jcm.input_names[0]: rng.integers(-128, 128, (2, 16)).astype(np.int8)})
        path = str(tmp_path / "repro.json")
        jsave_artifact(jcm, path)
        assert json.load(open(path))["schema"] == ARTIFACT_SCHEMA  # same schema id
        with pytest.raises(ValueError, match="package"):
            load_artifact(path, device="cpu")

    def test_a_foreign_backend_is_refused(self, tmp_path):
        _, path, _ = _saved_mlp(tmp_path)
        self._rewrite(path, lambda d: d["plan"].update(backend="pallas"))
        with pytest.raises(ValueError, match="backend"):
            load_artifact(path, device="cpu")


class TestPlanDiff:
    def _diff(self, a, b):
        return subprocess.run(
            [sys.executable, str(ROOT / "scripts" / "plan_diff.py"), a, b],
            capture_output=True, text=True, cwd=str(ROOT), timeout=120,
        )

    def test_self_diff_is_identical(self, tmp_path):
        _, a, _ = _saved_mlp(tmp_path, backend="cuda", batches=(2, 8), name="a.json")
        r = self._diff(a, a)
        assert r.returncode == 0, r.stdout + r.stderr
        assert "structurally identical" in r.stdout

    def test_cell_set_change_is_structural(self, tmp_path):
        _, a, _ = _saved_mlp(tmp_path, backend="cuda", batches=(2, 8), name="a.json")
        _, b, _ = _saved_mlp(tmp_path, backend="cuda", batches=(2, 16), name="b.json")
        r = self._diff(a, b)
        assert r.returncode == 1, r.stdout + r.stderr
        assert "STRUCTURALLY DIFFERENT" in r.stdout
        assert "N=8" in r.stdout and "N=16" in r.stdout

    def test_repro_and_port_artifacts_differ_only_in_tiles(self, tmp_path):
        """The same MLP saved by repro (interpret) and by the port (cuda):
        the backend row, each fused step's tile row and each hot cell's tile
        rows differ — the two kernels' tilings — and nothing else."""
        model, rng = _mlp_model()
        xs = [rng.integers(-128, 128, (n, 16)).astype(np.int8) for n in (2, 8)]
        jcm = jcompile(model, backend="interpret", batch="dynamic")
        cm = compile_model(_port(model), backend="cuda", device="cpu", batch="dynamic")
        for x in xs:
            jcm.run({jcm.input_names[0]: x})
            cm.run({cm.input_names[0]: x})
        a, b = str(tmp_path / "repro.json"), str(tmp_path / "port.json")
        jsave_artifact(jcm, a)
        save_artifact(cm, b)
        r = self._diff(a, b)
        assert r.returncode == 1, r.stdout + r.stderr
        changed = [ln.strip() for ln in r.stdout.splitlines() if ln.endswith("[changed]")]
        fused = [s.name for s in cm.plan.steps if s.kind == "fused_qlinear"]
        assert len(fused) == 2
        assert changed[0] == "backend: interpret -> cuda  [changed]"
        steps = [ln for ln in changed if ln.startswith("step ")]
        assert [re.match(r"step \d+: (\S+):", ln).group(1) for ln in steps] == fused
        assert all("; " not in ln.split(": ", 1)[1] and " tiles " in ln for ln in steps)
        cells = [ln for ln in changed if ln.startswith("(")]
        assert sorted(ln.split(")")[0] for ln in cells) == ["(N=2", "(N=2", "(N=8", "(N=8"]
        assert len(changed) == 1 + len(steps) + len(cells)

    def test_non_artifact_input_rejected(self, tmp_path):
        bad = tmp_path / "x.json"
        bad.write_text('{"schema": "other"}')
        assert self._diff(str(bad), str(bad)).returncode == 2
