"""One run of one cell: set-up, the measured window, the comparison.

The cell, its configuration, traffic mix and metrics are found by the names
``BENCHMARK.json`` gives them:

* ``configs/<config>.json`` (the sizes as run) and ``configs/<config>.py``
  (how the pre-quantized inputs are drawn from the seed, and the program
  under test built from them);
* ``traffic/<traffic>.json``, read by :mod:`harness.traffic`;
* ``work/<config>.py`` (operations and bytes), ``reference/<config>.py``
  (the plain reference and the comparison);
* ``metrics/<metric>.py`` for each per-layer metric.

Order of a run: inputs and program (set-up), warm-up of every shape the
mix uses, priming of the closed loop, then the window; with ``trace`` the
window (at most the mix's ``trace_seconds``) runs under ``torch.profiler``
with the program's tracer installed. After it: the memory peak, the sample
of what was served, the program freed, then the reference.
"""
from __future__ import annotations

import contextlib
import gc
import importlib.util
import json
import os
import sys
import time
import types
from typing import Dict, List, Optional

from . import traffic as _traffic
from .engine import EngineLoop
from .server import ServerLoop
from .timeline import WINDOW_MARK, Timeline

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(HERE)
#: Host marks the closed loops put around calls into the program.
MARKS = ("engine.step", "engine.prefill", "engine.decode", "serve.step", "CompiledModel.run",
         "clients.send")


def load_module(path: str):
    name = "portbench_" + os.path.relpath(path, HERE).replace("/", "_").replace("-", "_").replace(".", "_")
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or not os.path.exists(path):
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return mod


def load_benchmark(root: str = ROOT) -> Dict:
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        return json.load(f)


def find(entries: List[Dict], name: str, what: str) -> Dict:
    for e in entries:
        if e["name"] == name:
            return e
    raise KeyError(f"no {what} named {name!r} in BENCHMARK.json")


def metrics_of(bench: Dict, workload: str):
    """The cell's end-to-end metrics and its per-layer metrics."""
    e2e = [m for m in bench["end_to_end"] if workload in m.get("workloads", [workload])]
    names = {m["name"] for m in e2e}
    layer = [m for m in bench["per_layer"]
             if (workload in m["workloads"] if "workloads" in m else m["moves"] in names)]
    return e2e, layer


def process_age_s() -> float:
    """Seconds since this process started (Linux: from /proc)."""
    with open("/proc/self/stat") as f:
        start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
    with open("/proc/uptime") as f:
        uptime = float(f.read().split()[0])
    return uptime - start_ticks / os.sysconf("SC_CLK_TCK")


def load_cell(bench: Dict, workload: str, config: Optional[Dict] = None,
              mix: Optional[Dict] = None) -> types.SimpleNamespace:
    """The cell's configuration and mix (``config`` / ``mix`` replace the
    files' contents: the tests pass small sizes) and its modules."""
    cell = find(bench["workloads"], workload, "workload")
    entry = find(bench["configs"], cell["config"], "config")
    cfg_path = os.path.join(ROOT, entry["file"])
    if config is None:
        with open(cfg_path) as f:
            config = json.load(f)
    if mix is None:
        mix = _traffic.load(os.path.join(HERE, "traffic", f"{cell['traffic']}.json"))
    stem = os.path.splitext(cfg_path)[0]
    maker = load_module(stem + ".py")
    work = load_module(os.path.join(HERE, "work", f"{cell['config']}.py"))
    reference = load_module(os.path.join(HERE, "reference", f"{cell['config']}.py"))
    e2e, per_layer = metrics_of(bench, workload)
    if maker.LOOP != mix["loop"]:
        raise ValueError(f"{cell['config']} is served by the {maker.LOOP} loop, "
                         f"{cell['traffic']} by the {mix['loop']} one")
    return types.SimpleNamespace(cell=cell, config=config, mix=mix, maker=maker, work=work,
                                 reference=reference, e2e=e2e, per_layer=per_layer)


def make_loop(c, system, seed: int, device, sync):
    """A closed loop over ``system`` with the seed's traffic."""
    if c.mix["loop"] == "engine":
        gen = _traffic.EngineTraffic(c.mix, c.config["vocab_size"], seed)
        return EngineLoop(system, c.mix, gen, sync)
    pool = c.maker.make_examples(c.config, int(c.mix["pool"]), seed, device)
    return ServerLoop(system, c.mix, _traffic.ServerTraffic(c.mix, seed), pool, sync)


def run(bench: Dict, workload: str, seed: int, seconds: float, trace: bool, *,
        device: str = "cuda", config: Optional[Dict] = None, mix: Optional[Dict] = None) -> Dict:
    """One run: ``{"result": the last line's object, "details": the record}``."""
    import torch

    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.obs import trace as program_trace

    c = load_cell(bench, workload, config, mix)
    config, mix, work, reference = c.config, c.mix, c.work, c.reference
    on_card = torch.device(device).type == "cuda"
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    phases = {}
    t = time.perf_counter()
    inputs = c.maker.make_inputs(config, seed, device)
    sync()
    phases["inputs_s"] = time.perf_counter() - t
    t = time.perf_counter()
    system = c.maker.build(config, inputs, device)
    phases["compile_s"] = time.perf_counter() - t
    t = time.perf_counter()
    loop = make_loop(c, system, seed, device, sync)
    loop.warm()
    phases["warm_s"] = time.perf_counter() - t
    t = time.perf_counter()
    loop.prime()
    sync()
    phases["prime_s"] = time.perf_counter() - t
    setup_s = process_age_s()

    window = min(float(seconds), float(mix["trace_seconds"])) if trace else float(seconds)
    timeline, spans = None, {}
    if trace:
        from torch.profiler import ProfilerActivity, profile, record_function, schedule

        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if on_card else [])
        tracer = program_trace.install(program_trace.Tracer())
        try:
            with profile(activities=acts, schedule=schedule(wait=0, warmup=1, active=1)) as prof:
                loop.cycle()  # the profiler's warm-up step, discarded
                sync()
                prof.step()
                loop.annotate = record_function
                reset_launch_counts()
                t_traced = time.perf_counter()
                with record_function(WINDOW_MARK):
                    loop.run(window)
                    sync()
            loop.annotate = lambda name: contextlib.nullcontext()
        finally:
            program_trace.uninstall()
        lo = t_traced - tracer.epoch
        for rec in tracer.spans():
            if rec.ts >= lo:
                spans.setdefault(rec.name, []).append(rec.dur)
        timeline = Timeline(prof, MARKS)
    else:
        reset_launch_counts()
        loop.run(window)
        sync()
    launches = dict(launch_counts())
    if isinstance(loop, ServerLoop):
        loop.drain()
    peak = torch.cuda.max_memory_allocated(device) if on_card else 0
    e2e_values = loop.metrics()
    counts = loop.counts
    attempted = loop.attempted()
    served = loop.served(seed)
    calls = list(loop.calls)
    kind = torch.cuda.get_device_name(device) if on_card else "cpu"
    del loop, system
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()

    t = time.perf_counter()
    checks = reference.compare(config, inputs, served)
    reference_s = time.perf_counter() - t
    correct = all(v <= lim for _, v, lim in checks)

    result = {"correct": correct, "attempted": attempted, "failed": 0}
    metrics = {}
    details = {"phases": phases, "setup_s": setup_s, "window_s": window, "counts": counts,
               "e2e": e2e_values, "launches": launches, "reference_s": reference_s}
    if trace:
        ctx = types.SimpleNamespace(spans=spans, timeline=timeline, launches=launches,
                                    work=work.account(config, calls), notes=[])
        for m in c.per_layer:
            reader = load_module(os.path.join(HERE, "metrics", f"{m['name']}.py"))
            value = reader.read(ctx)
            if value is not None:
                metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
        extra = {"busy_s": timeline.busy_s(), "window_s": timeline.window_s}
        details["notes"] = ctx.notes
        details["work"] = ctx.work
    else:
        for m in c.e2e:
            if m["name"] == "setup_s":
                metrics["setup_s"] = {"value": setup_s, "unit": m["unit"]}
            elif m["name"] in e2e_values:
                metrics[m["name"]] = {"value": float(e2e_values[m["name"]]), "unit": m["unit"]}
        extra = {}
    result["metrics"] = metrics
    result["device"] = {"platform": "gpu" if on_card else "cpu", "kind": kind, "count": 1,
                        "memory_peak_bytes": int(peak), **extra}
    if trace:
        result["breakdown"] = timeline.breakdown()
    result["checks"] = {n: {"value": v, "limit": lim} for n, v, lim in checks}
    return {"result": result, "details": details}


def calibrate(bench: Dict, workload: str, seeds, seconds: float, *, device: str = "cuda",
              config: Optional[Dict] = None, mix: Optional[Dict] = None, log=print) -> List[Dict]:
    """The readings that set the limits, in one process: the program is
    built once from the first seed's inputs; for each seed a fresh closed
    loop with that seed's traffic runs a window of ``seconds``, and both the
    program and the reference's control are judged on what it served."""
    import torch

    c = load_cell(bench, workload, config, mix)
    on_card = torch.device(device).type == "cuda"
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    inputs = c.maker.make_inputs(c.config, seeds[0], device)
    system = c.maker.build(c.config, inputs, device)
    out = []
    for i, seed in enumerate(seeds):
        loop = make_loop(c, system, seed, device, sync)
        if i == 0:
            loop.warm()
        loop.prime()
        loop.run(seconds)
        sync()
        if isinstance(loop, ServerLoop):
            loop.drain()
        served = loop.served(seed)
        del loop
        gc.collect()
        row = {"seed": seed}
        for name, ctl in (("program", False), ("control", True)):
            row[name] = {n: v for n, v, _ in c.reference.compare(c.config, inputs, served, control=ctl)}
        log(json.dumps(row))
        out.append(row)
    return out
