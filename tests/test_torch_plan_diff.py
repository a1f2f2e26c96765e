"""The port's plan diff (``python -m repro_torch.scripts.plan_diff``) beside
``scripts/plan_diff.py``.

* Port artifacts that differ only in a qmatmul's K ``splits`` or only in a
  qattention ``cluster`` size diff as different (exit 1, the step named),
  where ``scripts/plan_diff.py`` — whose tile keys have neither — says
  "structurally identical" (exit 0); a tuned decode plan against its
  heuristic twin names exactly the steps whose tiles the tuner moved.
* A hot cell's tile source, a package change and bad input behave as the
  CLI documents (1, 1, 2).
* On pairs of ``repro``'s own artifacts both scripts give the same exit code
  and the same lines.

Both scripts run as child processes, as a user runs them.  No numerics, so
no tolerance.
"""
import json
import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from repro.backend.artifact import save_artifact as jsave_artifact
from repro.core import patterns as jpatterns
from repro.core import pqir as jpqir
from repro.core import quant as jquant
from repro.core.compile import compile_model as jcompile
from repro.core.toolchain import MLPSpec, quantize_mlp
from repro_torch.backend import cost
from repro_torch.backend.artifact import save_artifact
from repro_torch.backend.autotune import Autotuner
from repro_torch.core.compile import compile_model
from repro_torch.core.pqir import Model
from repro_torch.serving.token_path import CompiledTokenPath, TokenPathConfig

ROOT = Path(__file__).resolve().parents[1]
DECODE_CELL = {"N": 4, "S": 32}


def _run(args):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    return subprocess.run([sys.executable] + args, capture_output=True, text=True,
                          cwd=str(ROOT), env=env, timeout=120)


def port_diff(a, b):
    return _run(["-m", "repro_torch.scripts.plan_diff", str(a), str(b)])


def repro_diff(a, b):
    return _run([str(ROOT / "scripts" / "plan_diff.py"), str(a), str(b)])


def _changed(stdout):
    return [ln.strip() for ln in stdout.splitlines() if ln.endswith("[changed]")]


def _mlp(seed=21, widths=(256, 256, 64)):
    rng = np.random.default_rng(seed)
    spec = MLPSpec(
        weights=[rng.normal(size=(a, b)).astype(np.float32) * 0.2
                 for a, b in zip(widths, widths[1:])],
        biases=[rng.normal(size=(b,)).astype(np.float32) * 0.1 for b in widths[1:]],
        activations=["Relu", None],
    )
    return quantize_mlp(spec, rng.normal(size=(64, widths[0])).astype(np.float32), name="diff_mlp")


def _seq_model():
    rng = np.random.default_rng(31)
    p = jquant.quantize_linear_layer(
        rng.normal(size=(16, 8)).astype(np.float32) * 0.2,
        rng.normal(size=(8,)).astype(np.float32) * 0.1, 0.05, 0.1,
    )
    gb = jpqir.GraphBuilder("diff_seq")
    x = gb.add_input("x", "int8", ("N", "S", 16))
    y = jpatterns.fc_layer(gb, x, p, "fc0", two_mul=True, activation="Relu")
    gb.add_output(y, "int8", ("N", "S", 8))
    return gb.build()


def _port_mlp_artifact(path, batches=(2, 32)):
    """The MLP on the port's cuda backend: a template with hot cells at
    ``batches``, or a static plan (its steps bound: ``splits`` in each)
    when ``batches`` is empty."""
    cm = compile_model(Model.from_json(_mlp().to_json()), backend="cuda", device="cpu",
                       batch="dynamic" if batches else "static")
    for n in batches:
        cm.specialized(n)
    save_artifact(cm, str(path))
    return json.loads(Path(path).read_text())


def _cost_measure(step, shape, backend):
    """Deterministic timing oracle (``tests/test_torch_plan_artifact.py``'s)."""
    if "cluster" in shape:
        ops = 4.0 * shape["b"] * shape["s"] * shape["t"] * shape["dh"]
        return cost.wave_cost(ops, 0.0, shape["b"] * shape["s"] * shape["cluster"])
    return cost.qmatmul_tile_cost(shape["m"], shape["k"], shape["n"], shape["kp"], shape["np"],
                                  shape["bm"], shape["splits"], weight_bits=shape.get("bits", 8))


def _decode_artifact(path, tuned):
    tp = CompiledTokenPath(TokenPathConfig(d_model=128, d_ff=256), backend="cuda", device="cpu",
                           s_granularity=8,
                           autotune=Autotuner(measure_fn=_cost_measure) if tuned else None)
    plan, _ = tp.decode_cm.specialized(DECODE_CELL)
    save_artifact(tp.decode_cm, str(path))
    return {s.name: (s.params["shape"].get("bm"), s.params["shape"].get("splits"),
                     s.params["shape"].get("cluster"))
            for s in plan.steps
            if isinstance(s.params.get("shape"), dict)
            and ("bm" in s.params["shape"] or "cluster" in s.params["shape"])}


def _write(path, doc):
    Path(path).write_text(json.dumps(doc, indent=1, sort_keys=True))
    return path


@pytest.fixture(scope="module")
def decode_pair(tmp_path_factory):
    d = tmp_path_factory.mktemp("decode")
    heuristic = _decode_artifact(d / "heuristic.json", tuned=False)
    tuned = _decode_artifact(d / "tuned.json", tuned=True)
    return d / "heuristic.json", d / "tuned.json", heuristic, tuned


def test_identical_port_artifacts_diff_clean(tmp_path):
    _port_mlp_artifact(tmp_path / "a.json")
    r = port_diff(tmp_path / "a.json", tmp_path / "a.json")
    assert r.returncode == 0, r.stdout + r.stderr
    assert r.stdout.splitlines()[-1] == "result: structurally identical"
    assert "splits=" in r.stdout  # the port's tiles are shown, not only compared


@pytest.mark.parametrize("where", ["plan step", "hot cell"])
def test_splits_only_change_is_named(tmp_path, where):
    doc = _port_mlp_artifact(tmp_path / "a.json", () if where == "plan step" else (2, 32))
    if where == "plan step":
        step = next(s for s in doc["plan"]["steps"] if "splits" in s["params"].get("shape", {}))
        step["params"]["shape"]["splits"] += 1
        name = step["name"]
    else:
        cell = next(c for c in doc["cells"] if c["bindings"] == {"N": 32})
        name = sorted(cell["tiles"])[0]
        cell["tiles"][name]["splits"] += 1
    b = _write(tmp_path / "b.json", doc)
    r = port_diff(tmp_path / "a.json", b)
    assert r.returncode == 1, r.stdout + r.stderr
    (line,) = _changed(r.stdout)
    assert name in line and "splits=" in line
    old = repro_diff(tmp_path / "a.json", b)
    assert old.returncode == 0 and "structurally identical" in old.stdout


def test_cluster_only_change_is_named(decode_pair, tmp_path):
    heuristic_path, _, heuristic, _ = decode_pair
    doc = json.loads(Path(heuristic_path).read_text())
    (cell,) = doc["cells"]
    name = next(n for n, rec in sorted(cell["tiles"].items()) if "cluster" in rec)
    cell["tiles"][name]["cluster"] = 1 if cell["tiles"][name]["cluster"] != 1 else 2
    b = _write(tmp_path / "b.json", doc)
    r = port_diff(heuristic_path, b)
    assert r.returncode == 1, r.stdout + r.stderr
    (line,) = _changed(r.stdout)
    assert line.startswith(f"(N=4,S=32) {name}: ") and "cluster=" in line
    old = repro_diff(heuristic_path, b)
    assert old.returncode == 0 and "structurally identical" in old.stdout


def test_tuned_against_heuristic_names_exactly_the_moved_steps(decode_pair):
    """The phase-7 check on a small token path: every hot-cell step changes
    its source tag, and the tiles themselves change on exactly the steps
    the search moved."""
    heuristic_path, tuned_path, heuristic, tuned = decode_pair
    moved = sorted(n for n in tuned if tuned[n] != heuristic[n])
    assert moved  # the search moved some tiles
    r = port_diff(heuristic_path, tuned_path)
    assert r.returncode == 1, r.stdout + r.stderr
    lines = [ln for ln in _changed(r.stdout) if ln.startswith("(N=4,S=32) ")]
    assert len(lines) == len(tuned)
    pat = re.compile(r"\(N=4,S=32\) (\S+): (.*) \[heuristic\] -> (.*) \[tuned\]  \[changed\]")
    got = sorted(m.group(1) for m in map(pat.fullmatch, lines) if m.group(2) != m.group(3))
    assert got == moved


def test_source_only_change_differs_in_both(tmp_path):
    doc = _port_mlp_artifact(tmp_path / "a.json")
    rec = doc["cells"][0]["tiles"][sorted(doc["cells"][0]["tiles"])[0]]
    rec["source"] = "tuned"
    b = _write(tmp_path / "b.json", doc)
    for r in (port_diff(tmp_path / "a.json", b), repro_diff(tmp_path / "a.json", b)):
        assert r.returncode == 1, r.stdout + r.stderr
        (line,) = _changed(r.stdout)
        before, after = line[:-len("  [changed]")].split(" -> ")
        assert before.endswith(" [heuristic]") and after.endswith(" [tuned]")
        assert before.split(": ", 1)[1][:-len(" [heuristic]")] == after[:-len(" [tuned]")]


def test_package_field_is_shown_when_it_differs(tmp_path):
    model = _mlp()
    jcm = jcompile(model, backend="ref", batch="dynamic")
    cm = compile_model(Model.from_json(model.to_json()), backend="ref", device="cpu",
                       batch="dynamic")
    a, b = str(tmp_path / "repro.json"), str(tmp_path / "port.json")
    jsave_artifact(jcm, a)
    save_artifact(cm, b)
    r = port_diff(a, b)
    assert r.returncode == 1, r.stdout + r.stderr
    assert _changed(r.stdout) == ["package: - -> repro_torch  [changed]"]
    assert "package:" not in port_diff(b, b).stdout


@pytest.mark.parametrize("text", ["{not json", '{"schema": "other"}', "[1, 2]"],
                         ids=["bad-json", "wrong-schema", "not-an-object"])
def test_bad_input_exits_2(tmp_path, text):
    _port_mlp_artifact(tmp_path / "a.json")
    bad = tmp_path / "bad.json"
    bad.write_text(text)
    for a, b in ((bad, tmp_path / "a.json"), (tmp_path / "a.json", bad)):
        r = port_diff(a, b)
        assert r.returncode == 2 and r.stdout == "" and str(bad) in r.stderr


def _repro_artifact(path, model, backend, batches):
    cm = jcompile(model, backend=backend, batch="dynamic") if batches else jcompile(
        model, backend=backend, dynamic_axes={"N": None, "S": 8})
    for n in batches or ({"N": 2, "S": 8}, {"N": 4, "S": 24}):
        cm.specialized(n)
    jsave_artifact(cm, str(path))
    return str(path)


PAIRS = {
    "self": (("mlp", "interpret", (2, 8)), ("mlp", "interpret", (2, 8))),
    "cells": (("mlp", "interpret", (2, 8)), ("mlp", "interpret", (2, 16))),
    "backends": (("mlp", "ref", (2,)), ("mlp", "interpret", (2,))),
    "models": (("mlp", "interpret", (2,)), ("seq", "interpret", None)),
}


@pytest.mark.parametrize("pair", list(PAIRS))
def test_repro_artifacts_diff_as_scripts_plan_diff(tmp_path, pair):
    models = {"mlp": _mlp(), "seq": _seq_model()}
    (ma, ba, ca), (mb, bb, cb) = PAIRS[pair]
    a = _repro_artifact(tmp_path / "a.json", models[ma], ba, ca)
    b = _repro_artifact(tmp_path / "b.json", models[mb], bb, cb)
    for x, y in ((a, b), (b, a)):
        want, got = repro_diff(x, y), port_diff(x, y)
        assert got.returncode == want.returncode == (0 if pair == "self" else 1)
        assert got.stdout == want.stdout
        assert got.stderr == want.stderr == ""


def test_the_diff_loads_no_torch():
    code = ("import sys, runpy\n"
            "sys.argv = ['plan_diff', 'missing.json', 'missing.json']\n"
            "try:\n"
            "    runpy.run_module('repro_torch.scripts.plan_diff', run_name='__main__')\n"
            "except SystemExit as e:\n"
            "    rc = e.code\n"
            "print(rc, sorted(m for m in sys.modules if m.split('.')[0] in ('torch', 'numpy')))\n")
    r = _run(["-c", code])
    assert r.stdout.split("\n")[0] == "2 []", r.stdout + r.stderr
