"""The port's measured per-cell tile autotuning against the JAX package's,
on the CPU.

Mirrors ``tests/test_autotune.py`` case by case where the port has the
counterpart: the search space is the CUDA kernels' lattice — qmatmul
``(bm, splits)`` checked by ``ops.with_tiles``, qattention cluster sizes
checked by ``qattention.check_cluster`` — the qmatmul lattice ranked by
the H100 cost model;
sessions, provenance tags, the disk cache and its warm start, the
``compile_model(autotune=...)`` sugar, ``TuneJob`` and the server's
background search.  There is no kernel to time on the CPU, so every search
here injects the analytic cost model as ``measure_fn`` (and a real
measurement of a CPU plan must raise).

Differential cases: a tuned port plan (backend ``cuda``, run through the
kernels' plain versions) equals ``repro``'s compiled ``ref`` outputs over
the MLP's batch grid, and ``CompiledTokenPath(autotune=...)`` equals
``repro``'s ``CompiledTokenPath`` on prefill and decode.  The tuner lattices
differ by design (the MXU's (bm, bk, bn) against the CUDA kernel's), so no
test compares tiles across the packages.

Tolerance: 0 — tiles change where work runs, never the integer results.
"""
import json
import os

import numpy as np
import pytest
import torch

from repro.core.compile import compile_model as jcompile
from repro.core.toolchain import MLPSpec as JMLPSpec
from repro.core.toolchain import quantize_mlp as jquantize_mlp
from repro.serving.compiled import CompiledModelServer as JServer
from repro.serving.compiled import CompiledServerConfig as JConfig
from repro.serving.token_path import CompiledTokenPath as JTokenPath
from repro.serving.token_path import TokenPathConfig as JTokenConfig
from repro.serving.token_path import make_token_params
from repro_torch.backend import cost
from repro_torch.backend.autotune import (
    CACHE_SCHEMA,
    Autotuner,
    AutotuneCache,
    TuneJob,
    attention_candidates,
    measure_device_median,
    measure_median,
    seed_attention_candidates,
    seed_candidates,
    tile_candidates,
)
from repro_torch.backend.lowering import specialize_plan
from repro_torch.core.cache import PersistentJsonStore
from repro_torch.core.compile import compile_model
from repro_torch.core.pqir import Model
from repro_torch.core.toolchain import MLPSpec, quantize_mlp
from repro_torch.kernels import ops as kops
from repro_torch.kernels import qattention as qatt
from repro_torch.kernels import qmatmul as qmm
from repro_torch.serving import CompiledModelServer, CompiledServerConfig
from repro_torch.serving.token_path import CompiledTokenPath, TokenPathConfig, params_from_numpy

from test_torch_token_path import flatten_params


def _mlp(layers=2, width=256, seed=4):
    rng = np.random.default_rng(seed)
    spec = MLPSpec(
        weights=[rng.normal(0, 0.4, (width, width)).astype(np.float32) for _ in range(layers)],
        biases=[rng.normal(0, 0.2, (width,)).astype(np.float32) for _ in range(layers)],
        activations=["Relu"] * (layers - 1) + [None],
    )
    calib = rng.normal(0, 1.0, (64, width)).astype(np.float32)
    return quantize_mlp(spec, calib, name="autotune_test")


def _paper_mlp():
    """The §4/§6 MLP (Tanh fp16 flow, Sigmoid, plain FC) built by ``repro``'s
    toolchain: on ``cuda`` both tables fold into the matmul epilogues."""
    rng = np.random.default_rng(23)
    widths = (256, 256, 256, 64)
    spec = JMLPSpec(
        weights=[rng.normal(size=(a, b)).astype(np.float32) / np.sqrt(a)
                 for a, b in zip(widths, widths[1:])],
        biases=[rng.normal(size=(b,)).astype(np.float32) * 0.1 for b in widths[1:]],
        activations=["Tanh", "Sigmoid", None],
    )
    model = jquantize_mlp(spec, rng.normal(size=(64, 256)).astype(np.float32),
                          tanh_mode="fp16", per_channel=True, name="tuned_paper_mlp")
    return model, rng


def _port(model) -> Model:
    return Model.from_json(model.to_json())


def _cost_measure(step, shape, backend):
    """Deterministic timing oracle: the analytic cost model of a qmatmul;
    an attention launch's operations spread over its B·S·C blocks."""
    if "cluster" in shape:
        ops = 4.0 * shape["b"] * shape["s"] * shape["t"] * shape["dh"]
        return cost.wave_cost(ops, 0.0, shape["b"] * shape["s"] * shape["cluster"])
    return cost.qmatmul_tile_cost(shape["m"], shape["k"], shape["n"], shape["kp"], shape["np"],
                                  shape["bm"], shape["splits"],
                                  weight_bits=shape.get("bits", 8))


def _bound(m, kp, np_, bits=8):
    """A bound qmatmul record at (m, kp, np) as the binder plans it."""
    rec = {"k": kp, "n": np_, "kp": kp, "np": np_, "bk": qmm.BK, "bn": qmm.BN,
           "layout": "nk", "lead": (m,)}
    if bits != 8:
        rec["bits"] = bits
    return kops.bind_qmatmul_axes(rec, None)


def _sources(plan):
    ev = plan.provenance.specializations[-1]
    return [rec for _, rec in ev.tiles]


# ---------------------------------------------------------------------------
# search space properties
# ---------------------------------------------------------------------------


class TestSearchSpace:
    @pytest.mark.parametrize("m", [1, 4, 16, 17, 64, 200, 512])
    @pytest.mark.parametrize("kp,np_", [(64, 64), (128, 192), (256, 256), (2048, 6144)])
    def test_candidates_satisfy_all_constraints(self, m, kp, np_):
        bound = _bound(m, kp, np_)
        cands = tile_candidates(m, kp)
        assert cands and len(set(cands)) == len(cands)
        assert (bound["bm"], bound["splits"]) in cands, "the heuristic is a lattice point"
        for bm, splits in cands:
            tiled = kops.with_tiles(bound, bm=bm, splits=splits)  # the kernel's own check
            assert (tiled["bm"], tiled["splits"]) == (bm, splits)
            assert bm in qmm.SUPPORTED_BM and 1 <= splits <= kp // qmm.BK
            assert bm == 16 or m > 16, "a 64-row block over <= 16 rows only adds padding"
            for bits in (4, 8):
                assert cost.qmatmul_smem_bytes(bm, weight_bits=bits) <= cost.H100_SXM.smem_per_block
            # each split holds whole stages and the splits tile [0, kp)
            ranges = qmm.split_ranges(kp, splits)
            assert ranges[0][0] == 0 and ranges[-1][1] == kp
            assert all(a1 == b0 for (_, a1), (b0, _) in zip(ranges, ranges[1:]))

    @pytest.mark.parametrize("t,dh", [(1, 64), (3, 64), (128, 128), (512, 128), (60000, 128)])
    def test_attention_lattice_is_check_cluster(self, t, dh):
        cands = attention_candidates(t, dh)
        assert cands
        for c in qatt.CLUSTER_SIZES:
            if c in cands:
                assert qatt.check_cluster(t, dh, c) == c
                shape = {"b": 4, "s": 1, "t": t, "dh": dh, "cluster": 1}
                assert kops.with_cluster(shape, c)["cluster"] == c
            else:
                with pytest.raises(ValueError):
                    qatt.check_cluster(t, dh, c)

    def test_seeding_puts_heuristic_first_and_respects_budget(self):
        bound = _bound(64, 256, 256)
        heuristic = (bound["bm"], bound["splits"])
        for budget in (1, 2, 3, 100):
            cands = seed_candidates(bound, budget=budget)
            assert cands[0] == heuristic
            assert len(cands) <= max(budget, 1)
            assert len(set(cands)) == len(cands)
        full = seed_candidates(bound, budget=100)
        assert set(full) == set(tile_candidates(64, bound["kp"]))
        # the non-heuristic tail is ranked by the analytic cost model
        costs = [cost.qmatmul_tile_cost(64, 256, 256, 256, 256, *c) for c in full[1:]]
        assert costs == sorted(costs)

    def test_attention_seeding_puts_heuristic_first_and_respects_budget(self):
        shape = kops.bind_qattention_axes({"b": ("N",), "s": "S", "t": "S", "dh": 64},
                                          {"N": 4, "S": 128})
        for budget in (1, 2, 100):
            cands = seed_attention_candidates(shape, budget=budget)
            assert cands[0] == shape["cluster"] and len(cands) <= budget
            assert len(set(cands)) == len(cands)
        full = seed_attention_candidates(shape, budget=100)
        assert set(full) == set(attention_candidates(128, 64))
        # every legal size is measured: the tail is the rest in ascending order
        assert full[1:] == sorted(full[1:])

    def test_cost_model_sees_waves_splits_and_int4(self):
        # decode M = 4 at K = N = 2048: one block per tile leaves most SMs
        # idle, a split per stage pays its workspace — the optimum is between
        c = {s: cost.qmatmul_tile_cost(4, 2048, 2048, 2048, 2048, 16, s) for s in (1, 4, 32)}
        assert c[4] < c[1] and c[4] < c[32]
        assert cost.qmatmul_tile_cost(4, 2048, 2048, 2048, 2048, 16, 1, weight_bits=4) < c[1]

    def test_h100_spec_holds_no_tpu_figure(self):
        assert cost.H100_SXM.hbm_bw == 3.35e12 and cost.H100_SXM.peak_int8_ops == 1979e12
        assert cost.H100_SXM.sms == 132 == qmm.NUM_SMS == qatt.NUM_SMS
        assert qatt.SMEM_BYTES < cost.H100_SXM.smem_per_block
        assert not any(n.startswith("TPU") for n in dir(cost))


# ---------------------------------------------------------------------------
# stable timing helpers
# ---------------------------------------------------------------------------


class TestMeasureMedian:
    def test_call_count_and_median(self, monkeypatch):
        from repro_torch.backend import autotune as at

        # fake clock: (t0, t1) pairs for 3 samples of 10 / 20 / 1 ms
        ticks = iter([0.0, 0.010, 0.010, 0.030, 0.030, 0.031])
        monkeypatch.setattr(at.time, "perf_counter", lambda: next(ticks))
        calls = []
        got = measure_median(lambda: calls.append(1), repeat=3, warmup=2)
        assert len(calls) == 5  # warmup runs happen before the clock is read
        assert got == pytest.approx(0.010)  # median, not mean (noise-robust)

    def test_even_repeat_averages_middle_pair(self, monkeypatch):
        from repro_torch.backend import autotune as at

        ticks = iter([0.0, 0.004, 0.004, 0.012, 0.012, 0.013, 0.013, 0.033])
        monkeypatch.setattr(at.time, "perf_counter", lambda: next(ticks))
        got = measure_median(lambda: None, repeat=4, warmup=0)
        assert got == pytest.approx(0.5 * (0.004 + 0.008))

    def test_repeat_must_be_positive(self):
        with pytest.raises(ValueError, match="repeat"):
            measure_median(lambda: None, repeat=0)
        with pytest.raises(ValueError, match="repeat"):
            measure_device_median(lambda: None, torch.empty(1), repeat=0)


# ---------------------------------------------------------------------------
# the tuner: sessions, provenance tags, persistence
# ---------------------------------------------------------------------------


class TestAutotunerSessions:
    def test_measured_search_tags_provenance_and_memoizes(self):
        tuner = Autotuner(budget=4, measure_fn=_cost_measure)
        cm = compile_model(_mlp(), backend="cuda", device="cpu", batch="dynamic", autotune=tuner)
        plan, _ = cm.specialized(64)
        recs = _sources(plan)
        assert recs and all(rec.endswith(" [tuned]") for rec in recs)
        assert tuner.measurements == 8  # 2 fused steps x budget 4
        # session memoization: re-specializing the same cell measures nothing
        specialize_plan(cm.plan, 64, tuner=tuner)
        assert tuner.measurements == 8
        # a different cell is a different search
        specialize_plan(cm.plan, 8, tuner=tuner)
        assert tuner.measurements > 8

    def test_tuned_tiles_reach_the_plan(self):
        tuner = Autotuner(budget=100, measure_fn=_cost_measure)
        cm = compile_model(_mlp(), backend="cuda", device="cpu", batch="dynamic", autotune=tuner)
        plan, _ = cm.specialized(4)
        for step in plan.steps:
            shape = step.params.get("shape")
            if isinstance(shape, dict) and "bm" in shape:
                costs = {c: cost.qmatmul_tile_cost(4, shape["k"], shape["n"], shape["kp"],
                                                   shape["np"], *c)
                         for c in tile_candidates(4, shape["kp"])}
                best = min(costs.values())
                assert costs[(shape["bm"], shape["splits"])] == best
                assert f"splits={shape['splits']} [tuned]" in dict(
                    plan.provenance.specializations[-1].tiles)[step.name]

    def test_attention_cells_are_tuned(self):
        tuner = Autotuner(budget=8, measure_fn=_cost_measure)
        tp = CompiledTokenPath(TokenPathConfig(), backend="cuda", device="cpu", s_granularity=8,
                               autotune=tuner)
        plan, _ = tp.decode_cm.specialized({"N": 4, "S": 64})
        att = [s for s in plan.steps if s.kernel == "qattention"]
        assert len(att) == 2 * 2  # 2 layers x 2 heads
        tiles = dict(plan.provenance.specializations[-1].tiles)
        for s in att:
            assert tiles[s.name].endswith(" [tuned]")
            assert f"cluster={s.params['shape']['cluster']}" in tiles[s.name]
            assert s.params["shape"]["cluster"] in attention_candidates(64, 32)

    def test_collapsed_lattice_stays_heuristic(self):
        # width 64: kp = 64 admits one split; N=8 admits one row tile
        tuner = Autotuner(budget=8, measure_fn=_cost_measure)
        cm = compile_model(_mlp(width=64), backend="cuda", device="cpu", batch="dynamic",
                           autotune=tuner)
        plan, _ = cm.specialized(8)
        assert all("[" not in rec for rec in _sources(plan))  # untagged = heuristic
        assert tuner.measurements == 0

    def test_budget_one_never_measures(self):
        tuner = Autotuner(budget=1, measure_fn=_cost_measure)
        cm = compile_model(_mlp(), backend="cuda", device="cpu", batch="dynamic", autotune=tuner)
        plan, _ = cm.specialized(64)
        assert tuner.measurements == 0
        assert all("[" not in rec for rec in _sources(plan))

    def test_ref_backend_is_not_tunable(self):
        tuner = Autotuner(budget=8, measure_fn=_cost_measure)
        cm = compile_model(_mlp(), backend="ref", device="cpu", batch="dynamic", autotune=tuner)
        cm.specialized(64)
        tp = CompiledTokenPath(TokenPathConfig(), backend="ref", device="cpu", autotune=tuner)
        tp.decode_cm.specialized({"N": 2, "S": 32})
        assert tuner.measurements == 0

    def test_invalid_budget_rejected(self):
        with pytest.raises(ValueError, match="budget"):
            Autotuner(budget=0)

    def test_real_measurement_of_a_cpu_plan_raises(self):
        cm = compile_model(_mlp(), backend="cuda", device="cpu", batch="dynamic",
                           autotune=Autotuner(budget=4))
        with pytest.raises(ValueError, match="no kernel runs to be timed"):
            cm.specialized(64)

    def test_tuned_plan_is_bitexact_vs_untuned(self):
        model = _mlp()
        tuner = Autotuner(budget=4, measure_fn=_cost_measure)
        cm_t = compile_model(model, backend="cuda", device="cpu", batch="dynamic", autotune=tuner)
        cm_h = compile_model(model, backend="cuda", device="cpu", batch="dynamic")
        rng = np.random.default_rng(0)
        feeds = {"input_q": rng.integers(-128, 128, (64, 256)).astype(np.int8)}
        got, want = cm_t.run(feeds), cm_h.run(feeds)
        for k in want:
            assert torch.equal(got[k], want[k])


class TestPersistence:
    def test_disk_cache_warm_start_measures_nothing(self, tmp_path):
        path = str(tmp_path / "tiles.json")
        model = _mlp()
        t1 = Autotuner(budget=4, measure_fn=_cost_measure, cache=path)
        cm1 = compile_model(model, backend="cuda", device="cpu", batch="dynamic", autotune=t1)
        cm1.specialized(64)
        assert t1.measurements == 8
        assert len(t1.cache) == 2  # one entry per fused step

        t2 = Autotuner(budget=4, measure_fn=_cost_measure, cache=path)
        cm2 = compile_model(model, backend="cuda", device="cpu", batch="dynamic", autotune=t2)
        plan, _ = cm2.specialized(64)
        assert t2.measurements == 0
        recs = _sources(plan)
        assert recs and all(rec.endswith(" [cache]") for rec in recs)
        # warm-start winners are the measured winners
        e1 = {k: (v["bm"], v["splits"]) for k, v in t1.cache.store.entries.items()}
        e2 = {k: (v["bm"], v["splits"]) for k, v in t2.cache.store.entries.items()}
        assert e1 == e2

    def test_cache_entry_carries_measurement_evidence(self, tmp_path):
        path = str(tmp_path / "tiles.json")
        tuner = Autotuner(budget=4, measure_fn=_cost_measure, cache=path)
        cm = compile_model(_mlp(layers=1), backend="cuda", device="cpu", batch="dynamic",
                           autotune=tuner)
        cm.specialized(64)
        (key, entry), = tuner.cache.store.entries.items()
        step, backend, cell, shp = key.split("|")
        assert backend == "cuda" and cell == "N=64"
        assert shp == "m=64,k=256,n=256,kp=256,np=256"
        assert entry["measured"] == 4 == len(entry["candidates_us"])
        assert entry["best_us"] <= entry["heuristic_us"]
        assert entry["best_us"] == min(entry["candidates_us"].values())
        assert f"{entry['bm']},{entry['splits']}" in entry["candidates_us"]
        assert entry["device"] == "measure_fn"  # who measured: an injected oracle here
        assert json.load(open(path))["schema"] == CACHE_SCHEMA == "repro_torch-autotune-v1"

    def test_attention_entries_carry_the_cluster(self, tmp_path):
        path = str(tmp_path / "tiles.json")
        tuner = Autotuner(budget=8, measure_fn=_cost_measure, cache=path)
        tp = CompiledTokenPath(TokenPathConfig(), backend="cuda", device="cpu", autotune=path)
        assert tp.autotuner is tp.prefill_cm.autotuner is tp.decode_cm.autotuner
        tp = CompiledTokenPath(TokenPathConfig(), backend="cuda", device="cpu", autotune=tuner)
        tp.decode_cm.specialized({"N": 4, "S": 64})
        att = {k: v for k, v in tuner.cache.store.entries.items() if ",dh=" in k}
        assert len(att) == 4
        for key, entry in att.items():
            assert key.split("|")[3] == "b=4,s=1,t=64,dh=32"
            assert entry["cluster"] in attention_candidates(64, 32)
            assert str(entry["cluster"]) in entry["candidates_us"]

    def test_compile_model_autotune_path_sugar(self, tmp_path):
        path = str(tmp_path / "tiles.json")
        cm = compile_model(_mlp(), backend="cuda", device="cpu", batch="dynamic", autotune=path)
        assert isinstance(cm.autotuner, Autotuner)
        assert cm.autotuner.cache is not None and cm.autotuner.cache.path == path

    def test_compile_model_autotune_true_sugar(self):
        cm = compile_model(_mlp(), backend="cuda", device="cpu", batch="dynamic", autotune=True)
        assert isinstance(cm.autotuner, Autotuner)
        assert cm.autotuner.cache is None

    def test_compile_model_autotune_duck_typed_instance(self):
        class FakeTuner:
            def tune_step(self, step, shape, *, backend, bindings):
                return shape, "heuristic"

        fake = FakeTuner()
        cm = compile_model(_mlp(), backend="cuda", device="cpu", batch="dynamic", autotune=fake)
        assert cm.autotuner is fake


class TestPersistentJsonStore:
    def test_roundtrip_and_reload(self, tmp_path):
        path = str(tmp_path / "store.json")
        s = PersistentJsonStore(path, schema="test-v1")
        assert len(s) == 0
        s.put("a", {"x": 1})
        assert "a" in s and s.get("a") == {"x": 1}
        assert json.loads(open(path).read())["schema"] == "test-v1"
        assert PersistentJsonStore(path, schema="test-v1").get("a") == {"x": 1}

    def test_schema_mismatch_raises(self, tmp_path):
        path = str(tmp_path / "store.json")
        PersistentJsonStore(path, schema="repro-autotune-v1").put("a", 1)  # repro's tile cache
        with pytest.raises(ValueError, match="schema"):
            AutotuneCache(path)  # the port's tile cache has its own tag
        with pytest.raises(ValueError, match="schema"):
            PersistentJsonStore(path, schema="test-v2")

    def test_save_leaves_no_temp_files(self, tmp_path):
        path = str(tmp_path / "store.json")
        s = PersistentJsonStore(path, schema=CACHE_SCHEMA)
        for i in range(3):
            s.put(f"k{i}", i)
        assert sorted(p.name for p in tmp_path.iterdir()) == ["store.json"]
        assert not os.path.exists(str(tmp_path / "never.json"))


# ---------------------------------------------------------------------------
# background search: TuneJob and the server
# ---------------------------------------------------------------------------


class TestTuneJob:
    def test_advance_increments(self):
        tuner = Autotuner(budget=4, measure_fn=_cost_measure)
        cm = compile_model(_mlp(), backend="cuda", device="cpu", batch="dynamic")
        job = TuneJob(tuner, cm.plan, {"N": 64})
        assert not job.done and job.remaining == 8  # 2 steps x budget 4
        for want in (5, 2, 0):
            job.advance(3)
            assert job.remaining == want and tuner.measurements == 8 - want
        assert job.done and job.advance(3)
        # the cell now resolves from the session: specializing measures nothing
        plan = specialize_plan(cm.plan, {"N": 64}, tuner=tuner)
        assert tuner.measurements == 8
        assert all(rec.endswith(" [tuned]") for rec in _sources(plan))
        # a job for a resolved cell has no work
        assert TuneJob(tuner, cm.plan, {"N": 64}).done

    def test_server_swaps_the_tuned_plan(self):
        model, rng = _paper_mlp()
        cm = compile_model(_port(model), backend="cuda", device="cpu", batch="dynamic")
        tuner = Autotuner(budget=3, measure_fn=_cost_measure)
        srv = CompiledModelServer(cm, CompiledServerConfig(max_batch=8), autotuner=tuner)
        jsrv = JServer(jcompile(model, backend="ref", batch="dynamic"), JConfig(max_batch=8))
        xs = [rng.integers(-128, 128, (256,)).astype(np.int8) for _ in range(16)]
        got = [srv.submit(x) for x in xs[:8]]
        srv.step()
        assert srv.tuning_pending == 3 * 3 - 2  # 3 steps x budget 3, 2 measured
        while srv.tuning_pending:
            assert srv.step() == []  # idle cycles spend the budget
        assert srv.metrics["tuned_swaps"] == 1 and srv.tuning_pending == 0
        assert srv.registry.counter("autotune.swaps").value == 1
        plan, _ = cm.plan_cache.peek(cm.cache_key({"N": 8}))
        assert all(rec.endswith(" [tuned]") for rec in _sources(plan))
        got += [srv.submit(x) for x in xs[8:]]  # served on the swapped plan
        srv.run_until_drained()
        want = [jsrv.submit(x) for x in xs]
        jsrv.run_until_drained()
        out = cm.output_names[0]
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.outputs[out], np.asarray(w.outputs[out]))

    def test_config_and_autotuner_validated(self):
        with pytest.raises(ValueError, match="tune_candidates_per_step"):
            CompiledServerConfig(tune_candidates_per_step=0)
        cm = compile_model(_mlp(), backend="cuda", device="cpu", batch="dynamic",
                           autotune=Autotuner(measure_fn=_cost_measure))
        srv = CompiledModelServer(cm)
        assert srv.autotuner is not None and cm.autotuner is None  # detached from the model


# ---------------------------------------------------------------------------
# differential: tuned port plans against repro
# ---------------------------------------------------------------------------


def test_tuned_port_plan_matches_repro_over_the_batch_grid():
    model, rng = _paper_mlp()
    jcm = jcompile(model, backend="ref", batch="dynamic")
    tuner = Autotuner(budget=6, measure_fn=_cost_measure)
    cm = compile_model(_port(model), backend="cuda", device="cpu", batch="dynamic",
                       autotune=tuner)
    inp = cm.input_names[0]
    for n in (1, 2, 3, 5, 8, 13, 17, 33, 64):
        x = rng.integers(-128, 128, (n, 256)).astype(np.int8)
        got, want = cm.run({inp: x}), jcm.run({inp: x})
        assert set(got) == set(want)
        for k in want:
            np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))
    assert tuner.measurements > 0
    assert cm.stats["lut_epilogues"] == 2  # the tuned steps carry their tables


def test_token_path_autotune_matches_repro():
    jcfg = JTokenConfig()
    jparams = make_token_params(jcfg, seed=3)
    jtp = JTokenPath(jcfg, jparams, backend="ref", s_granularity=8)
    tuner = Autotuner(budget=4, measure_fn=_cost_measure)
    tp = CompiledTokenPath(TokenPathConfig(), params_from_numpy(flatten_params(jparams)),
                           backend="cuda", device="cpu", s_granularity=8, autotune=tuner)
    rng = np.random.default_rng(7)
    n, plen, s = 2, 8, 16
    toks = rng.integers(1, jcfg.vocab, (n, plen)).astype(np.int32)
    mask = np.broadcast_to(np.tril(np.ones((plen, plen), np.float32)), (n, plen, plen)).copy()
    logits, cache = tp.prefill(toks, mask)
    jlogits, jcache = jtp.prefill(toks, mask)
    np.testing.assert_array_equal(logits.numpy(), np.asarray(jlogits))
    full = tp.init_cache(n, s)
    jfull = {}
    for name in cache:
        full[name][:, :plen] = cache[name]
        jfull[name] = full[name].numpy().copy()
    step_toks = rng.integers(1, jcfg.vocab, (n, 1)).astype(np.int32)
    onehot = np.zeros((n, s, 1), np.int8)
    onehot[:, plen] = 1
    dmask = np.zeros((n, 1, s), np.float32)
    dmask[:, :, : plen + 1] = 1
    dl, dcache = tp.decode(step_toks, onehot, dmask, full)
    jl, jnext = jtp.decode(step_toks, onehot, dmask, jfull)
    np.testing.assert_array_equal(dl.numpy(), np.asarray(jl))
    for name in jnext:
        np.testing.assert_array_equal(dcache[name].numpy(), np.asarray(jnext[name]))
    # both cells went through the tuner: a fused step is tagged exactly
    # where its lattice has more than the heuristic point (d_model 64 leaves
    # the K = 64 projections one split and, at M <= 16, one row tile)
    for cm, cell in ((tp.prefill_cm, {"N": 2, "S": 8}), (tp.decode_cm, {"N": 2, "S": 16})):
        plan, _ = cm.specialized(cell)
        tiles = dict(plan.provenance.specializations[-1].tiles)
        tagged = 0
        for step in plan.steps:
            shape = step.params.get("shape")
            if step.name not in tiles:
                continue
            lattice = (attention_candidates(shape["t"], shape["dh"]) if "cluster" in shape
                       else tile_candidates(shape["m"], shape["kp"]))
            assert tiles[step.name].endswith(" [tuned]") == (len(lattice) > 1), tiles[step.name]
            tagged += len(lattice) > 1
        assert tagged >= 4 + 2  # every head's attention, the K = 128 down projections
    assert tuner.measurements > 0
