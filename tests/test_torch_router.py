"""The port's sharded replica router against the JAX package's, on the CPU.

* a port counterpart of each test of ``tests/test_router.py``: cell
  affinity (distinct sequence-bucket cells on distinct replicas, sticky
  across waves, results bit-exact per request, batch-only traffic on one
  cell, fleet-unique uids), failover (a failed replica's queue migrates in
  order, a transient failure retries in place, new submissions avoid the
  dead replica, the last replica failing raises), observability (one shared
  registry, ``replica=`` on every step span, straggler state in
  ``health()``) and construction;
* a differential test: the same seeded requests, with one replica failing
  mid-way, go through ``repro``'s ``ShardedRouter`` over a ``repro``
  artifact and through the port's over a port artifact of the same model;
  outputs, uids, the cell owners and the request accounting must be equal.

The replicas run the port's ``cuda`` backend (on the CPU each kernel wrapper
runs its plain version) unless a test says otherwise; ``device="cpu"`` is
passed to every entry point.  Tolerance: 0 — integer outputs.
"""
import numpy as np
import pytest

from repro.backend.artifact import save_artifact as jsave_artifact
from repro.core import patterns, pqir, quant
from repro.core.compile import compile_model as jcompile
from repro.core.runtime import ReferenceRuntime
from repro.core.toolchain import MLPSpec, quantize_mlp
from repro.serving import CompiledModelServer as JServer
from repro.serving import CompiledServerConfig as JServerConfig
from repro.serving import RouterConfig as JRouterConfig
from repro.serving import ShardedRouter as JRouter
from repro_torch.backend.artifact import load_artifact, save_artifact
from repro_torch.core.compile import compile_model
from repro_torch.core.pqir import Model
from repro_torch.obs import trace as _trace
from repro_torch.obs.metrics import MetricsRegistry
from repro_torch.serving import (
    CompiledModelServer,
    CompiledServerConfig,
    RouterConfig,
    ShardedRouter,
)

BACKEND = "cuda"


def _port(model) -> Model:
    return Model.from_json(model.to_json())


def _batch_model(name="fleet_mlp"):
    rng = np.random.default_rng(21)
    spec = MLPSpec(
        weights=[
            rng.normal(size=(16, 32)).astype(np.float32) * 0.2,
            rng.normal(size=(32, 8)).astype(np.float32) * 0.2,
        ],
        biases=[
            rng.normal(size=(32,)).astype(np.float32) * 0.1,
            rng.normal(size=(8,)).astype(np.float32) * 0.1,
        ],
        activations=["Relu", None],
    )
    calib = rng.normal(size=(64, 16)).astype(np.float32)
    return quantize_mlp(spec, calib, name=name), rng


def _seq_model():
    rng = np.random.default_rng(31)
    p = quant.quantize_linear_layer(
        rng.normal(size=(16, 8)).astype(np.float32) * 0.2,
        rng.normal(size=(8,)).astype(np.float32) * 0.1, 0.05, 0.1,
    )
    gb = pqir.GraphBuilder("fleet_seq")
    x = gb.add_input("x", "int8", ("N", "S", 16))
    y = patterns.fc_layer(gb, x, p, "fc0", two_mul=True, activation="Relu")
    gb.add_output(y, "int8", ("N", "S", 8))
    return gb.build(), rng


def _record_seq(srv, rng, warm_lens):
    for s in warm_lens:
        for _ in range(4):
            srv.submit(rng.integers(-128, 128, (s, 16)).astype(np.int8))
        srv.step()


def _seq_artifact(tmp_path, warm_lens=(4, 12, 20), backend=BACKEND):
    """Save a two-axis port artifact whose hot cells cover the seq buckets
    the tests route on (batch bucket 4 x seq buckets 8/16/24)."""
    model, rng = _seq_model()
    cm = compile_model(_port(model), backend=backend, device="cpu",
                       dynamic_axes={"N": None, "S": 8})
    _record_seq(CompiledModelServer(cm, CompiledServerConfig(max_batch=4)), rng, warm_lens)
    path = str(tmp_path / "fleet_seq.json")
    save_artifact(cm, path)
    return model, path, rng


def _batch_artifact(tmp_path):
    model, rng = _batch_model()
    cm = compile_model(_port(model), backend=BACKEND, device="cpu", batch="dynamic")
    inp = cm.input_names[0]
    for n in (4, 8):
        cm.run({inp: rng.integers(-128, 128, (n, 16)).astype(np.int8)})
    path = str(tmp_path / "fleet_mlp.json")
    save_artifact(cm, path)
    return model, path, rng


def _router(path, replicas, max_batch=4, **kw):
    kw.setdefault("warm", False)
    return ShardedRouter.from_artifact(
        path, replicas=replicas, server_cfg=CompiledServerConfig(max_batch=max_batch),
        device="cpu", **kw,
    )


def _raiser(msg):
    def run(feeds):
        raise RuntimeError(msg)

    return run


class TestCellAffinity:
    def test_distinct_seq_cells_land_on_distinct_replicas(self, tmp_path):
        model, path, rng = _seq_artifact(tmp_path)
        router = _router(path, 3)
        reqs = []
        for s in (8, 12, 20):  # buckets 8, 16, 24
            for _ in range(4):
                reqs.append(router.submit(rng.integers(-128, 128, (s, 16)).astype(np.int8)))
        done = router.run_until_drained()
        assert len(done) == 12 and all(r.done for r in reqs)
        s = router.summary()
        assert sorted(s["cell_owners"]) == ["S=16", "S=24", "S=8"]
        assert len(set(s["cell_owners"].values())) == 3
        for name, rep_summary in s["replicas"].items():
            assert rep_summary["plan_cache"]["misses"] == 0, name
        assert all(rate == 1.0 for rate in s["plan_cache_hit_rates"].values())
        assert s["lost"] == 0 and s["duplicates"] == 0

    def test_cells_are_sticky_across_waves(self, tmp_path):
        model, path, rng = _seq_artifact(tmp_path)
        router = _router(path, 2)
        for _ in range(3):
            for s in (4, 12):
                for _ in range(4):
                    router.submit(rng.integers(-128, 128, (s, 16)).astype(np.int8))
            router.run_until_drained()
        owners = router.summary()["cell_owners"]
        assert set(owners) == {"S=8", "S=16"}
        assert len(set(owners.values())) == 2
        for rep in router.replicas:
            assert rep.server.metrics["batches"] == 3

    def test_results_bit_exact_per_request(self, tmp_path):
        model, path, rng = _seq_artifact(tmp_path)
        rt = ReferenceRuntime(model)
        router = _router(path, 3)
        lens = [3, 12, 20, 7, 18, 4, 23, 9]
        reqs = [router.submit(rng.integers(-128, 128, (s, 16)).astype(np.int8)) for s in lens]
        router.run_until_drained()
        out_name = next(iter(reqs[0].outputs))
        for r, s in zip(reqs, lens):
            assert r.done and r.outputs[out_name].shape == (s, 8)
            solo = rt.run({"x": r.inner.x[None, :, :]})[out_name][0]
            np.testing.assert_array_equal(r.outputs[out_name], solo, err_msg=f"uid {r.uid}")

    def test_batch_only_traffic_is_single_cell(self, tmp_path):
        model, path, rng = _batch_artifact(tmp_path)
        router = _router(path, 2, max_batch=8)
        for _ in range(8):
            router.submit(rng.integers(-128, 128, (16,)).astype(np.int8))
        router.run_until_drained()
        s = router.summary()
        assert s["cell_owners"] == {"*": "r0"}
        assert s["completed"] == 8 and s["lost"] == 0

    def test_fleet_unique_uids(self, tmp_path):
        model, path, rng = _seq_artifact(tmp_path)
        router = _router(path, 3)
        reqs = [router.submit(rng.integers(-128, 128, (s, 16)).astype(np.int8))
                for s in (4, 12, 20) * 3]
        assert len({r.uid for r in reqs}) == len(reqs)
        assert len({r.replica for r in reqs}) == 3


class TestFailover:
    def test_failed_replica_queue_migrates_in_order(self, tmp_path):
        model, path, rng = _seq_artifact(tmp_path)
        router = _router(path, 2, cfg=RouterConfig(failure_threshold=1))
        a = [router.submit(rng.integers(-128, 128, (4, 16)).astype(np.int8)) for _ in range(4)]
        b = [router.submit(rng.integers(-128, 128, (12, 16)).astype(np.int8)) for _ in range(4)]
        victim = router.replicas[router._cell_owner[a[0].cell]]
        survivor = next(r for r in router.replicas if r is not victim)
        victim.server.cm.run = _raiser("replica down")

        expect_order = [r.uid for r in victim.server.queue]
        done = router.run_until_drained()
        s = router.summary()
        assert len(done) == 8 and all(r.done for r in a + b)
        assert s["lost"] == 0 and s["duplicates"] == 0
        assert s["failovers"] == 1 and s["rerouted"] == 4
        assert not victim.healthy and survivor.healthy
        migrated = [r for r in a if r.rerouted]
        assert [r.uid for r in migrated] == expect_order
        assert all(r.replica == survivor.name for r in migrated)
        assert set(s["cell_owners"].values()) == {survivor.name}
        assert s["health"][victim.name]["healthy"] is False
        assert s["registry"][f"fleet.failures.{victim.name}"] == 1

    def test_below_threshold_failure_retries_in_place(self, tmp_path):
        model, path, rng = _batch_artifact(tmp_path)
        router = _router(path, 1, max_batch=8, cfg=RouterConfig(failure_threshold=3))
        reqs = [router.submit(rng.integers(-128, 128, (16,)).astype(np.int8)) for _ in range(4)]
        rep = router.replicas[0]
        real_run = rep.server.cm.run
        rep.server.cm.run = _raiser("transient")
        assert router.step() == []
        assert rep.healthy and rep.failures == 1
        assert [r.uid for r in rep.server.queue] == [r.uid for r in reqs]
        rep.server.cm.run = real_run
        done = router.run_until_drained()
        assert len(done) == 4 and rep.failures == 0
        assert router.summary()["lost"] == 0

    def test_new_submissions_avoid_the_dead_replica(self, tmp_path):
        model, path, rng = _seq_artifact(tmp_path)
        router = _router(path, 2, cfg=RouterConfig(failure_threshold=1))
        r1 = router.submit(rng.integers(-128, 128, (4, 16)).astype(np.int8))
        victim = router.replicas[router._cell_owner[r1.cell]]
        victim.server.cm.run = _raiser("down")
        done = router.step()
        r2 = router.submit(rng.integers(-128, 128, (4, 16)).astype(np.int8))
        assert r2.replica != victim.name
        done += router.run_until_drained()
        assert len(done) == 2 and r1.done and r2.done

    def test_last_replica_failing_raises(self, tmp_path):
        model, path, rng = _batch_artifact(tmp_path)
        router = ShardedRouter.from_artifact(path, replicas=1, device="cpu",
                                             cfg=RouterConfig(failure_threshold=1), warm=False)
        router.submit(rng.integers(-128, 128, (16,)).astype(np.int8))
        router.replicas[0].server.cm.run = _raiser("down")
        with pytest.raises(RuntimeError, match="no healthy replica"):
            router.step()
        with pytest.raises(RuntimeError, match="no healthy replica"):
            router.submit(rng.integers(-128, 128, (16,)).astype(np.int8))


class TestFleetObservability:
    def test_one_registry_aggregates_all_replicas(self, tmp_path):
        model, path, rng = _seq_artifact(tmp_path)
        registry = MetricsRegistry()
        router = _router(path, 3, registry=registry)
        for s in (4, 12, 20):
            for _ in range(4):
                router.submit(rng.integers(-128, 128, (s, 16)).astype(np.int8))
        router.run_until_drained()
        snap = registry.snapshot()
        assert snap["serve.requests"] == 12 and snap["serve.completed"] == 12
        assert snap["fleet.requests"] == 12 and snap["fleet.completed"] == 12
        assert snap["serve.latency_ms"]["count"] == 12
        total_batches = sum(r.server.metrics["batches"] for r in router.replicas)
        assert snap["serve.batches"] == total_batches == 3

    def test_replica_spans_carry_the_replica_attribute(self, tmp_path):
        model, path, rng = _seq_artifact(tmp_path)
        router = _router(path, 2)
        tracer = _trace.install()
        try:
            for s in (4, 12):
                for _ in range(4):
                    router.submit(rng.integers(-128, 128, (s, 16)).astype(np.int8))
            router.run_until_drained()
        finally:
            _trace.uninstall()
        steps = tracer.spans("serve.step")
        assert steps and all("replica" in sp.attrs for sp in steps)
        assert {sp.attrs["replica"] for sp in steps} == {"r0", "r1"}

    def test_health_surfaces_straggler_state(self, tmp_path):
        model, path, rng = _batch_artifact(tmp_path)
        router = _router(path, 1, max_batch=8)
        for _ in range(8):
            router.submit(rng.integers(-128, 128, (16,)).astype(np.int8))
        router.run_until_drained()
        h = router.health()["r0"]
        assert h["healthy"] and h["steps"] >= 1 and h["queue"] == 0
        assert h["step_time_ewma_s"] is None or h["step_time_ewma_s"] >= 0.0
        assert isinstance(h["straggler_steps"], list)


class TestConstruction:
    def test_rejects_empty_fleet_and_bad_config(self, tmp_path):
        with pytest.raises(ValueError, match="at least one replica"):
            ShardedRouter([])
        model, path, rng = _batch_artifact(tmp_path)
        with pytest.raises(ValueError, match="replicas"):
            ShardedRouter.from_artifact(path, replicas=0, device="cpu")
        with pytest.raises(ValueError, match="failure_threshold"):
            RouterConfig(failure_threshold=0)

    def test_rejects_duplicate_replica_names(self, tmp_path):
        model, path, rng = _batch_artifact(tmp_path)
        servers = [CompiledModelServer(load_artifact(path, device="cpu"), name="same")
                   for _ in range(2)]
        with pytest.raises(ValueError, match="unique"):
            ShardedRouter(servers)

    def test_rejects_mixed_artifact_shapes(self, tmp_path):
        _, bpath, _ = _batch_artifact(tmp_path)
        _, spath, _ = _seq_artifact(tmp_path)
        servers = [
            CompiledModelServer(load_artifact(bpath, device="cpu"), name="a"),
            CompiledModelServer(load_artifact(spath, device="cpu"), name="b"),
        ]
        with pytest.raises(ValueError, match="same artifact shape"):
            ShardedRouter(servers)

    def test_warm_start_replicas_preseed_every_cache(self, tmp_path):
        model, path, rng = _seq_artifact(tmp_path)
        router = _router(path, 2, warm=True)
        for rep in router.replicas:
            stats = rep.server.cm.cache_stats
            assert stats["size"] == 3
            assert stats["hits"] == 0 and stats["misses"] == 0


COUNTS = ("requests", "completed", "rerouted", "failovers", "lost", "duplicates")


def _drive_fleet(router, waves, fail_after):
    """Submit each wave and drain it; before wave ``fail_after`` the replica
    owning the S=8 cell starts raising.  Returns the routed requests."""
    reqs = []
    for i, wave in enumerate(waves):
        if i == fail_after:
            victim = router.replicas[router._cell_owner[("S", 8)]]
            victim.server.cm.run = _raiser("replica down")
        reqs += [router.submit(x) for x in wave]
        router.run_until_drained()
    return reqs


@pytest.mark.parametrize("backend", ["ref", "cuda"])
def test_fleet_matches_repro_with_a_failover(tmp_path, backend):
    """One seeded model, recorded on the same traffic; ``repro``'s router
    over its artifact and the port's over its own serve the same waves (3
    replicas, threshold 1, the S=8 cell's replica failing before the third
    wave): equal outputs, uids, cell owners and counts."""
    model, _ = _seq_model()
    jcm = jcompile(model, backend="ref", dynamic_axes={"N": None, "S": 8})
    _record_seq(JServer(jcm, JServerConfig(max_batch=4)), np.random.default_rng(5), (4, 12, 20))
    jpath = str(tmp_path / "repro.json")
    jsave_artifact(jcm, jpath)
    _, tpath, _ = _seq_artifact(tmp_path, backend=backend)

    rng = np.random.default_rng(8)
    waves = [[rng.integers(-128, 128, (int(s), 16)).astype(np.int8)
              for s in rng.integers(1, 25, 10)] for _ in range(4)]
    jrouter = JRouter.from_artifact(jpath, replicas=3, server_cfg=JServerConfig(max_batch=4),
                                    cfg=JRouterConfig(failure_threshold=1), warm=False)
    trouter = ShardedRouter.from_artifact(tpath, replicas=3, server_cfg=CompiledServerConfig(max_batch=4),
                                          cfg=RouterConfig(failure_threshold=1), warm=False,
                                          device="cpu")
    jreqs = _drive_fleet(jrouter, waves, fail_after=2)
    treqs = _drive_fleet(trouter, waves, fail_after=2)

    js, ts = jrouter.summary(), trouter.summary()
    assert {k: ts[k] for k in COUNTS} == {k: js[k] for k in COUNTS}
    assert ts["failovers"] == 1 and ts["rerouted"] > 0 and ts["lost"] == 0
    assert ts["cell_owners"] == js["cell_owners"]
    assert [r.uid for r in treqs] == [r.uid for r in jreqs]
    assert [(r.replica, r.rerouted, r.cell) for r in treqs] == [(r.replica, r.rerouted, r.cell) for r in jreqs]
    for t, j in zip(treqs, jreqs):
        assert t.done and j.done
        assert sorted(t.outputs) == sorted(j.outputs)
        for name, w in j.outputs.items():
            w = np.asarray(w)
            assert t.outputs[name].dtype == w.dtype
            np.testing.assert_array_equal(t.outputs[name], w, err_msg=f"uid {t.uid}")
