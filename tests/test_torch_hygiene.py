"""Import hygiene and device discipline of the PyTorch port.

* ``repro_torch`` imports ``torch`` and numpy and nothing of JAX or of the JAX
  package ``repro`` — checked in a fresh interpreter that imports every
  module of the port, and by an AST scan of every port source and of
  ``chip_smoke.py``;
* the entry points run on the CUDA card unless the caller asks for the CPU,
  and raise — never fall back — when no card is present.

No numerics here, so no tolerance.
"""
import ast
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.core.compile import compile_model
from repro_torch.core.pqir import GraphBuilder
from repro_torch.serving.engine import EngineConfig, ServeEngine
from repro_torch.serving.token_path import CompiledTokenPath, TokenPathConfig

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
SOURCES = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]


def _forbidden(module: str) -> bool:
    top = module.split(".")[0]
    return top in ("jax", "jaxlib", "repro")


def test_importing_every_module_loads_no_jax_or_repro():
    code = (
        "import importlib, pkgutil, sys\n"
        "import repro_torch\n"
        "names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__, 'repro_torch.')]\n"
        "for n in names: importlib.import_module(n)\n"
        "bad = sorted(k for k in sys.modules if k.split('.')[0] in ('jax', 'jaxlib', 'repro'))\n"
        "print(len(names), bad)\n"
        "sys.exit(1 if bad or len(names) < 20 else 0)\n"
    )
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    r = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, env=env,
                       cwd=str(ROOT), timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(ROOT)))
def test_source_imports_nothing_of_jax_or_repro(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    bad = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            bad += [a.name for a in node.names if _forbidden(a.name)]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            if _forbidden(node.module):
                bad.append(node.module)
    assert not bad, f"{path} imports {bad}"


def _tiny_model():
    gb = GraphBuilder("relu")
    gb.add_input("x", "int8", (None, 4))
    y = gb.op("Relu", ["x"], out_hint="y")
    gb.add_output(y, "int8", (None, 4))
    return gb.build(opset=17)


def test_entry_points_raise_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        compile_model(_tiny_model())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        compile_model(_tiny_model(), device="cuda")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        CompiledTokenPath(TokenPathConfig(n_layers=1))


def test_cpu_on_request_and_results_stay_on_the_device():
    cm = compile_model(_tiny_model(), device="cpu")
    out = cm.run({"x": np.array([[-3, 0, 2, 127]], np.int8)})
    (y,) = out.values()
    assert isinstance(y, torch.Tensor) and y.device.type == "cpu"
    np.testing.assert_array_equal(y.numpy(), [[0, 0, 2, 127]])


def test_unported_options_raise():
    with pytest.raises(NotImplementedError, match="autotune"):
        compile_model(_tiny_model(), device="cpu", autotune=True)
    with pytest.raises(ValueError, match="backend"):
        compile_model(_tiny_model(), device="cpu", backend="pallas")
    with pytest.raises(ValueError, match="adapter"):
        ServeEngine(EngineConfig())
