"""Import hygiene and device discipline of the PyTorch port.

* ``repro_torch`` imports ``torch`` and numpy and nothing of JAX or of the JAX
  package ``repro`` — checked in a fresh interpreter that imports every
  module of the port, and by an AST scan of every port source, of
  ``chip_smoke.py``, of the A/B timing scripts and of the tile sweep;
* the entry points run on the CUDA card unless the caller asks for the CPU,
  and raise — never fall back — when no card is present;
* the numpy-only modules the port copies from ``repro`` stay byte-for-byte
  copies, so a port-side edit to one fails here.

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
from repro_torch.backend.artifact import save_artifact
from repro_torch.configs import get_config
from repro_torch.kernels.ops import quantized_matmul
from repro_torch.launch.serve import serve_demo
from repro_torch.launch.train import train
from repro_torch.models.model import init_params, tree_map
from repro_torch.serving.engine import EngineConfig, ServeEngine
from repro_torch.serving.router import ShardedRouter
from repro_torch.serving.token_path import CompiledTokenPath, TokenPathConfig

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
SOURCES = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py", ROOT / "scripts" / "qmatmul_ab.py",
                                        ROOT / "scripts" / "qattention_ab.py",
                                        ROOT / "scripts" / "qact_lut_ab.py",
                                        ROOT / "scripts" / "autotune_sweep.py"]


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


#: The plain references a compiled model is held to: plain torch and numpy.
REFERENCES = [ROOT / "portbench" / "reference" / "tokpath-mellum2.py"]


@pytest.mark.parametrize("path", REFERENCES, ids=lambda p: str(p.relative_to(ROOT)))
def test_the_plain_references_import_no_jax_no_repro_and_no_port_kernel(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    tops = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            tops.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom):
            assert node.level == 0, f"{path} imports relatively"
            tops.add(node.module.split(".")[0])
    assert tops <= {"__future__", "math", "typing", "numpy", "torch"}, tops


SLICE_MODULES = ["core/calibrate.py", "core/toolchain.py", "core/export.py",
                 "kernels/qact_lut.py", "kernels/ops.py", "serving/compiled.py",
                 "backend/cost.py", "backend/autotune.py", "backend/artifact.py",
                 "checkpoint/ckpt.py", "serving/router.py",
                 "distributed/sharding.py", "models/__init__.py", "models/layers.py",
                 "models/attention.py", "models/moe.py", "models/transformer.py",
                 "models/rwkv6.py", "models/mamba2.py", "models/model.py",
                 "core/convert.py", "core/qlayers.py", "serving/engine.py",
                 "launch/__init__.py", "launch/serve.py", "core/qat.py", "optim/__init__.py",
                 "optim/schedule.py", "optim/adamw.py", "optim/grad_compress.py", "data/__init__.py",
                 "data/pipeline.py", "launch/steps.py", "launch/train.py", "launch/mesh.py",
                 "launch/specs.py", "launch/dryrun.py"]


@pytest.mark.parametrize("rel", SLICE_MODULES)
def test_compiled_model_slice_modules_are_scanned(rel):
    """The MLP/CNN serving slice's modules are among the scanned sources,
    and none of them names jax or repro in an import."""
    path = PORT / rel
    assert path in SOURCES
    test_source_imports_nothing_of_jax_or_repro(path)


#: The port's own tracer: ``repro``'s, extended (profiler ranges, bulk step
#: records), so no longer a copy; ``test_the_port_tracer_keeps_the_api_of_repro``.
OWN_TRACER = "obs/trace.py"

#: The port's byte-for-byte copies of ``repro``'s numpy-only modules.
COPIES = sorted(
    [str(p.relative_to(PORT)) for d in ("obs", "passes") for p in (PORT / d).glob("*.py")
     if str(p.relative_to(PORT)) != OWN_TRACER]
    + [f"core/{m}.py" for m in ("pqir", "quant", "patterns", "runtime", "cache", "calibrate",
                                "toolchain", "export")]
    + ["kernels/pack.py", "distributed/fault_tolerance.py", "data/__init__.py", "data/pipeline.py",
       "optim/__init__.py"]
    + [str(p.relative_to(PORT)) for p in (PORT / "configs").glob("*.py")]
)


def test_every_repro_module_has_a_port_counterpart():
    """The module port is complete: each ``.py`` of ``src/repro`` has a file
    at the same path in ``src/repro_torch``."""
    theirs = {str(p.relative_to(ROOT / "src" / "repro")) for p in (ROOT / "src" / "repro").rglob("*.py")}
    ours = {str(p.relative_to(PORT)) for p in PORT.rglob("*.py")}
    assert sorted(theirs - ours) == []


def test_the_copies_are_all_listed():
    assert len(COPIES) == 34


def _public_api(path: Path) -> dict:
    """Top-level public names of a module, and the public methods of each
    of its classes."""
    api = {}
    for node in ast.parse(path.read_text()).body:
        if isinstance(node, (ast.FunctionDef, ast.ClassDef)) and not node.name.startswith("_"):
            api[node.name] = sorted(
                n.name for n in getattr(node, "body", [])
                if isinstance(n, ast.FunctionDef) and not n.name.startswith("_")
            ) if isinstance(node, ast.ClassDef) else []
        elif isinstance(node, (ast.Assign, ast.AnnAssign)):
            targets = node.targets if isinstance(node, ast.Assign) else [node.target]
            api.update({t.id: [] for t in targets if isinstance(t, ast.Name) and not t.id.startswith("_")})
    return api


def test_the_port_tracer_keeps_the_api_of_repro():
    """The port's tracer has every public name, class and method of
    ``repro``'s, which it extends."""
    theirs = _public_api(ROOT / "src" / "repro" / OWN_TRACER)
    ours = _public_api(PORT / OWN_TRACER)
    assert theirs and all(name in ours and set(meths) <= set(ours[name]) for name, meths in theirs.items())


@pytest.mark.parametrize("rel", COPIES)
def test_copied_module_is_identical_to_its_repro_original(rel):
    original = ROOT / "src" / "repro" / rel
    assert (PORT / rel).read_bytes() == original.read_bytes(), (
        f"src/repro_torch/{rel} is no longer a byte-for-byte copy of src/repro/{rel}"
    )


def _tiny_model():
    gb = GraphBuilder("relu")
    gb.add_input("x", "int8", (None, 4))
    y = gb.op("Relu", ["x"], out_hint="y")
    gb.add_output(y, "int8", (None, 4))
    return gb.build(opset=17)


class _CardTensor(torch.Tensor):
    """A CPU tensor that reports the card as its device: parameters that an
    entry point would have to run on the card."""

    @property
    def device(self):
        return torch.device("cuda", 0)


def test_entry_points_raise_without_a_card(monkeypatch, tmp_path):
    path = str(tmp_path / "relu.json")
    save_artifact(compile_model(_tiny_model(), device="cpu", batch="dynamic"), path)
    cfg = get_config("qwen3_1_7b", reduced=True)
    card_params = tree_map(lambda _, a: a.as_subclass(_CardTensor),
                           init_params(torch.Generator().manual_seed(0), cfg, device="cpu"))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        init_params(torch.Generator().manual_seed(0), cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve_demo("qwen3_1_7b", requests=1)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train("qwen3_1_7b", steps=1)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ServeEngine(card_params, cfg, EngineConfig())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        compile_model(_tiny_model())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        compile_model(_tiny_model(), device="cuda")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        CompiledTokenPath(TokenPathConfig(n_layers=1))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ShardedRouter.from_artifact(path, replicas=1)


def test_cpu_on_request_and_results_stay_on_the_device():
    cm = compile_model(_tiny_model(), device="cpu")
    out = cm.run({"x": np.array([[-3, 0, 2, 127]], np.int8)})
    (y,) = out.values()
    assert isinstance(y, torch.Tensor) and y.device.type == "cpu"
    np.testing.assert_array_equal(y.numpy(), [[0, 0, 2, 127]])


def test_unported_options_raise():
    with pytest.raises(ValueError, match="backend"):
        compile_model(_tiny_model(), device="cpu", backend="pallas")
    with pytest.raises(ValueError, match="adapter"):
        ServeEngine(ecfg=EngineConfig())
    x, w = torch.zeros((2, 4), dtype=torch.int8), torch.zeros((4, 3), dtype=torch.int8)
    with pytest.raises(ValueError, match="backend"):
        quantized_matmul(x, w, None, 1.0, 1.0, backend="pallas")
    with pytest.raises(TypeError, match="DeviceMesh"):
        train("qwen3_1_7b", steps=1, device="cpu", mesh=object())
