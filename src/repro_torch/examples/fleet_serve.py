"""Fleet serving on the port: one AOT plan artifact, N warm-started replicas,
one router (``examples/fleet_serve.py`` on the H100).

1. Compile a two-axis ``("N", "S", …)`` artifact on the ``cuda`` backend,
   serve a recording run so the PlanCache visits the hot scenario cells,
   and ``save_artifact`` — one JSON (structure, hot cells with their tiles
   incl. the qmatmul K ``splits``, provenance) plus an npz sidecar (baked
   constants, sha256-pinned in the JSON).
2. ``ShardedRouter.from_artifact(replicas=3)``: every replica warm-starts
   from disk — no passes, no fusion, no lowering, plan cache pre-seeded —
   and traffic shards by sequence-bucket cell affinity.
3. Throw mixed-length traffic at the front door and check every response
   bit-exact vs a solo reference-runtime run.
4. Kill a replica mid-traffic: its queue migrates in order to a healthy
   replica, its cells re-point, and the uid accounting proves nothing was
   lost and nothing served twice.

Run:  PYTHONPATH=src python -m repro_torch.examples.fleet_serve [--device cpu]
"""
import argparse
import os
import tempfile

import numpy as np

from repro_torch.backend.artifact import load_artifact, save_artifact, sidecar_path
from repro_torch.core import patterns, pqir, quant
from repro_torch.core.compile import compile_model, resolve_device
from repro_torch.core.runtime import ReferenceRuntime
from repro_torch.examples import add_device_arg, finish
from repro_torch.kernels import launch_counts, reset_launch_counts
from repro_torch.serving import CompiledModelServer, CompiledServerConfig, RouterConfig, ShardedRouter

#: The traffic mix: three sequence-bucket cells (buckets of 8), 4 requests each.
SEQ_LENS = (4, 12, 20)
PER_CELL = 4


def make_model(rng):
    """The per-token FC over ``("N", "S", 32)``; returns it and its output."""
    p = quant.quantize_linear_layer(
        rng.normal(size=(32, 16)).astype(np.float32) * 0.2,
        rng.normal(size=(16,)).astype(np.float32) * 0.1, 0.05, 0.1,
    )
    gb = pqir.GraphBuilder("fleet_mlp")
    x = gb.add_input("x", "int8", ("N", "S", 32))
    y = patterns.fc_layer(gb, x, p, "fc0", two_mul=True, activation="Relu")
    gb.add_output(y, "int8", ("N", "S", 16))
    return gb.build(), y


def _draw(rng, s):
    return rng.integers(-128, 128, (s, 32)).astype(np.int8)


def record_cells(recorder, rng):
    """The recording run: each cell of the mix once, drained per cell."""
    for s in SEQ_LENS:
        for _ in range(PER_CELL):
            recorder.submit(_draw(rng, s))
        recorder.run_until_drained()


def serve_rounds(router, rng, rounds=3):
    """``rounds`` rounds of the mix through the front door; returns the
    routed requests in submission order."""
    reqs = []
    for _ in range(rounds):
        for s in SEQ_LENS:
            for _ in range(PER_CELL):
                reqs.append(router.submit(_draw(rng, s)))
        router.run_until_drained()
    return reqs


def failover_wave(router, rng):
    """One wave of the mix with replica 0 raising on every batch; returns
    the wave's requests and what the drain completed."""
    victim = router.replicas[0]
    print(f"\ninjecting a failure into {victim.name} …")
    original_run = victim.server.cm.run

    def down(feeds):
        raise RuntimeError("down")

    victim.server.cm.run = down
    try:
        wave = []
        for s in SEQ_LENS:
            for _ in range(PER_CELL):
                wave.append(router.submit(_draw(rng, s)))
        done = router.run_until_drained()
    finally:
        victim.server.cm.run = original_run
    return wave, done


def all_equal_solo(reqs, model, y) -> bool:
    """Every routed response equals its request run alone through the numpy
    ``ReferenceRuntime``, bit for bit."""
    rt = ReferenceRuntime(model)
    for req in reqs:
        solo = rt.run({"x": req.inner.x[None, :, :]})[y][0]
        got = req.outputs[y]
        if got.dtype != solo.dtype or not np.array_equal(got, solo):
            print(f"request {req.uid} diverged")
            return False
    return True


def main(argv=None):
    ap = argparse.ArgumentParser()
    add_device_arg(ap)
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    reset_launch_counts()
    rng = np.random.default_rng(7)

    with tempfile.TemporaryDirectory(prefix="repro-torch-fleet-") as d:
        # -- 1. compile, record the hot cells, save the artifact --------------
        model, y = make_model(rng)
        cm = compile_model(model, backend="cuda", device=device,
                           dynamic_axes={"N": None, "S": 8})
        cfg = CompiledServerConfig(max_batch=4)
        recorder = CompiledModelServer(cm, cfg)
        record_cells(recorder, rng)
        path = os.path.join(d, "plan.json")
        save_artifact(cm, path)
        hot_cells = recorder.summary()["plan_cache"]["size"]
        print(f"saved {path} (+ {os.path.basename(sidecar_path(path))}): "
              f"{len(cm.plan.steps)} steps, {hot_cells} hot cells recorded")

        # -- 2. the fleet: 3 replicas warm-started from the one file ----------
        router = ShardedRouter.from_artifact(
            path, replicas=3, server_cfg=cfg, cfg=RouterConfig(failure_threshold=1),
            device=device,
        )
        print("3 replicas up — zero re-lowering, plan caches pre-seeded\n")

        # -- 3. mixed traffic through the front door --------------------------
        reqs = serve_rounds(router, rng)
        fleet_equal = all_equal_solo(reqs, model, y)
        assert fleet_equal, "a request diverged from its solo reference run"
        print(f"{len(reqs)} requests served bit-exactly across the fleet ✓")

        s = router.summary()
        print(f"cell → replica affinity: {s['cell_owners']}")
        rates = {k: round(v, 2) for k, v in s["plan_cache_hit_rates"].items()}
        print(f"per-replica plan-cache hit rates: {rates} "
              "(pre-seeded caches: no replica ever missed)")
        misses = sum(rep["plan_cache"]["misses"] for rep in s["replicas"].values())

        # -- 4. failover: kill a replica mid-traffic --------------------------
        wave, done = failover_wave(router, rng)
        failover_equal = all_equal_solo(wave, model, y)
        assert failover_equal, "a request of the failover wave diverged"
        s = router.summary()
        assert len(done) == len(wave) and s["lost"] == 0 and s["duplicates"] == 0
        print(f"wave of {len(wave)} served anyway: {s['rerouted']} requests migrated "
              f"in order, {s['failovers']} failover handled, lost={s['lost']}, "
              f"duplicates={s['duplicates']}")
        print(f"affinity after failover: {s['cell_owners']}")
        health = {k: ("up" if v["healthy"] else "DOWN") for k, v in s["health"].items()}
        print(f"health: {health}")

        # the artifact loads anywhere — a fourth replica, a diff tool, a designer
        cm_again = load_artifact(path, warm=True, device=device)
        print(f"\nre-loaded the artifact once more: {len(cm_again.plan.steps)} steps, "
              "ready to serve — `python -m repro_torch.scripts.plan_diff old.json "
              "new.json` diffs two of these structurally, K splits and cluster "
              "sizes included")

    return finish({
        "example": "fleet_serve", "device": str(device), "hot_cells": hot_cells,
        "requests": len(reqs), "fleet_equal": fleet_equal, "plan_cache_misses": misses,
        "wave": len(wave), "completed": len(done), "failover_equal": failover_equal,
        "failovers": s["failovers"], "rerouted": s["rerouted"], "lost": s["lost"],
        "duplicates": s["duplicates"], "launches": launch_counts(),
    })


if __name__ == "__main__":
    main()
