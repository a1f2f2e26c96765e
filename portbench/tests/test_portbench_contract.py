"""What the benchmark may import and what ``BENCHMARK.json`` must hold.

No module under ``portbench/`` imports JAX or the JAX package (top-level
names compared whole: the port's ``repro_torch`` begins with ``repro``);
nothing reads the JAX package's ``benchmarks/``; the references import
nothing of the program. Every name ``BENCHMARK.json`` gives has its file,
and every metric its cells."""
import ast
import glob
import json
import os
import re

import pytest

PORTBENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(PORTBENCH)
SOURCES = sorted(glob.glob(os.path.join(PORTBENCH, "**", "*.py"), recursive=True))
FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")

with open(os.path.join(ROOT, "BENCHMARK.json")) as _f:
    BENCH = json.load(_f)


def imported(path):
    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: os.path.relpath(p, PORTBENCH))
def test_no_jax_and_no_jax_package(path):
    tops = {m.split(".", 1)[0] for m in imported(path)}
    assert not tops & FORBIDDEN
    if os.path.samefile(path, __file__):  # the check names the folder it looks for
        return
    consts = [n.value for n in ast.walk(ast.parse(open(path).read())) if isinstance(n, ast.Constant)]
    assert not [c for c in consts if isinstance(c, str) and c.strip("/").split("/")[0] == "benchmarks"]


@pytest.mark.parametrize("path", sorted(glob.glob(os.path.join(PORTBENCH, "reference", "*.py"))),
                         ids=os.path.basename)
def test_references_import_nothing_of_the_program(path):
    tops = {m.split(".", 1)[0] for m in imported(path)}
    assert tops <= {"__future__", "math", "typing", "numpy", "torch"}


def test_top_level_keys_and_command():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    assert BENCH["command"] == ["python3", "portbench/run.py"] and BENCH["paths"] == ["portbench"]
    assert 1 <= BENCH["run_seconds"] <= 51 and isinstance(BENCH["run_seconds"], int)


@pytest.mark.parametrize("entry", BENCH["configs"], ids=lambda e: e["name"])
def test_config_files(entry):
    assert set(entry) == {"name", "source", "file", "reduced", "why"} and NAME.match(entry["name"])
    with open(os.path.join(ROOT, entry["file"])) as f:
        cfg = json.load(f)
    assert cfg["name"] == entry["name"] and cfg["reduced"] == entry["reduced"]
    assert all(k in cfg and k in cfg["published"] for k in entry["reduced"])
    stem = os.path.join(PORTBENCH, "{}", entry["name"] + ".py")
    for kind in ("configs", "work", "reference"):
        assert os.path.exists(stem.format(kind)), kind


@pytest.mark.parametrize("cell", BENCH["workloads"], ids=lambda e: e["name"])
def test_cells(cell):
    assert set(cell) == {"name", "config", "traffic", "chips", "why"} and cell["chips"] == 1
    assert NAME.match(cell["name"]) and len(cell["why"]) <= 200
    assert cell["config"] in {c["name"] for c in BENCH["configs"]}
    assert os.path.exists(os.path.join(PORTBENCH, "traffic", cell["traffic"] + ".json"))
    e2e = [m["name"] for m in BENCH["end_to_end"] if cell["name"] in m.get("workloads", [cell["name"]])]
    layer = [m for m in BENCH["per_layer"] if cell["name"] in m["workloads"]]
    assert "setup_s" in e2e and len(e2e) >= 2 and layer
    assert all(m["moves"] in e2e for m in layer)


@pytest.mark.parametrize("metric", BENCH["end_to_end"] + BENCH["per_layer"], ids=lambda m: m["name"])
def test_metrics(metric):
    assert NAME.match(metric["name"]) and UNIT.match(metric["unit"])
    assert metric["better"] in ("lower", "higher")
    if "bound" in metric:
        assert metric["source"] in ("host_clock", "device_trace") and 0.01 <= metric["bound"] <= 0.25
    else:
        assert os.path.exists(os.path.join(PORTBENCH, "metrics", metric["name"] + ".py"))
        assert metric["moves"] in {m["name"] for m in BENCH["end_to_end"]}
