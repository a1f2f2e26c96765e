"""The port's examples (``src/repro_torch/examples/``) against ``repro`` and
its own examples, on the CPU.

Each port example runs with ``--device cpu`` (its kernel wrappers then run
their plain versions) and its checks must all hold; then what it computes
is held against ``repro`` on the same numpy seeds:

* ``quickstart``: the saved ``.pqir.json`` is byte for byte the one
  ``repro``'s toolchain writes for the same spec, and the int8 codes equal
  ``repro``'s ``ReferenceRuntime`` and its ``interpret`` backend.
* ``cnn_prequant``: the per-tensor and per-channel outputs equal ``repro``'s
  ``ref`` backend (what its example compiles), its ``interpret`` backend and
  ``ReferenceRuntime``, with the same fusion stats.
* ``serve_compiled`` and ``fleet_serve``: every response equals the one
  ``repro``'s server and router give on the same requests, the failover
  wave included; the trace holds the spans ``repro``'s example's trace holds.
* ``serve_quantized``: ``run_engine`` fed ``repro``'s ``M.init_params(
  PRNGKey(0), reduced minicpm_2b)`` weights (``params_from_numpy``) against
  ``repro``'s example's ``run_engine`` in each posture.  Tolerance, as
  ``tests/test_torch_zoo_serving.py`` states it: the generated tokens and
  the engine metrics are equal, after each logits row ``repro``'s engine
  picks a greedy token from is asserted a top-2 margin above
  1e-4 · max(1, max |row|) (the model tests' float32 logits bound).

The compiled paths are integer paths: equal means bit for bit.
"""
import copy
import dataclasses
import importlib.util
import json
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from repro.backend.artifact import save_artifact as jsave_artifact
from repro.configs import get_config
from repro.core import pqir as jpqir
from repro.core import quant as jquant
from repro.core.compile import compile_model as jcompile
from repro.core.convert import convert_params_w8a8 as jconvert
from repro.core.runtime import ReferenceRuntime as JRuntime
from repro.core.toolchain import quantize_cnn as jquantize_cnn
from repro.core.toolchain import quantize_mlp as jquantize_mlp
from repro.obs import trace as jtrace
from repro.serving import CompiledModelServer as JServer
from repro.serving import CompiledServerConfig as JServerConfig
from repro.serving import RouterConfig as JRouterConfig
from repro.serving import ShardedRouter as JRouter
from repro_torch.backend.artifact import save_artifact
from repro_torch.core.compile import compile_model
from repro_torch.examples import cnn_prequant, fleet_serve, quickstart, serve_compiled
from repro_torch.examples import serve_quantized, train_qat
from repro_torch.models import model as TM
from repro_torch.serving import CompiledModelServer, CompiledServerConfig, RouterConfig, ShardedRouter
from test_torch_models import np_tree, repro_params
from test_torch_zoo_serving import _record

ROOT = Path(__file__).resolve().parents[1]
EXAMPLES = {"quickstart": quickstart, "cnn_prequant": cnn_prequant,
            "serve_compiled": serve_compiled, "fleet_serve": fleet_serve,
            "serve_quantized": serve_quantized, "train_qat": train_qat}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Run this module's eager steps on one intra-op thread: the suite runs
    in parallel workers, and the port's small steps on PyTorch's full thread
    pool crawl when the workers oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def repro_example(name):
    """``examples/<name>.py``, imported by path (its ``main`` is not run)."""
    spec = importlib.util.spec_from_file_location(f"repro_example_{name}",
                                                  ROOT / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def to_repro(model):
    return jpqir.Model.from_json(model.to_json())


@pytest.mark.parametrize("name", list(EXAMPLES))
def test_example_raises_without_a_card_or_a_device(name):
    with pytest.raises(RuntimeError, match="no CUDA device"):
        EXAMPLES[name].main([])


# -- quickstart ------------------------------------------------------------


def test_quickstart_runs_on_the_cpu():
    r = quickstart.main(["--device", "cpu"])
    assert r["codes_equal"] and r["round_trip_equal"] and r["eliminated"] >= 1
    assert r["stats"]["fused_qlinear"] == 3


def test_quickstart_artifact_and_codes_match_repro(tmp_path):
    rng = np.random.default_rng(0)
    spec, calib = quickstart.make_spec(rng)
    model = quickstart.quantize(spec, calib)
    jmodel = jquantize_mlp(spec, calib, observer="percentile", name="quickstart_mlp")
    model.save(str(tmp_path / "port.pqir.json"))
    jmodel.save(str(tmp_path / "repro.pqir.json"))
    assert (tmp_path / "port.pqir.json").read_bytes() == (tmp_path / "repro.pqir.json").read_bytes()

    x = rng.normal(size=(16, 64)).astype(np.float32)
    xq = jquant.quantize(x, float(jmodel.metadata["input_scale"]), "int8")
    _, codes = quickstart.run_compiled(model, xq, "cpu")
    (want,) = JRuntime(jmodel).run({"input_q": xq}).values()
    (interp,) = jcompile(jmodel, backend="interpret", verify_passes=True).run(
        {"input_q": xq}).values()
    assert codes.dtype == want.dtype == np.int8
    np.testing.assert_array_equal(codes, want)
    np.testing.assert_array_equal(codes, np.asarray(interp))


# -- cnn_prequant ----------------------------------------------------------


def test_cnn_prequant_runs_on_the_cpu():
    r = cnn_prequant.main(["--device", "cpu"])
    assert r["per_tensor_equal"] and r["per_channel_equal"]
    assert r["stats_per_channel"]["fused_qconv"] == 1
    assert r["stats_per_channel"]["fused_qlinear"] == 1


@pytest.mark.parametrize("per_channel", [False, True], ids=["per-tensor", "per-channel"])
def test_cnn_prequant_matches_repro(per_channel):
    rng = np.random.default_rng(0)
    xtr, ytr = cnn_prequant.make_data(rng, 2048)
    xte, _ = cnn_prequant.make_data(rng, 512)
    spec = cnn_prequant.train_spec(rng, xtr, ytr)
    name = "cnn_prequant_pc" if per_channel else "cnn_prequant"
    jmodel = jquantize_cnn(spec, xtr[:256], observer="percentile", per_channel=per_channel,
                           name=name)
    model = cnn_prequant.quantize_cnn(spec, xtr[:256], observer="percentile",
                                      per_channel=per_channel, name=name)
    assert model.to_json() == jmodel.to_json()
    cm, ref_out, got = cnn_prequant.run_variant(model, xte, "cpu")
    xq = jquant.quantize(xte, float(jmodel.metadata["input_scale"]), "int8")
    assert xq.dtype == np.int8  # the padded conv takes int8 codes: pads are 0 everywhere
    (want,) = JRuntime(jmodel).run({"input_q": xq}).values()
    for backend in ("ref", "interpret"):
        jcm = jcompile(jmodel, backend=backend)
        (jout,) = jcm.run({"input_q": xq}).values()
        np.testing.assert_array_equal(got, np.asarray(jout))
        for key in ("fused_qconv", "fused_qlinear", "generic"):
            assert cm.stats[key] == jcm.stats[key], (backend, key)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(ref_out, want)
    assert got.dtype == want.dtype


# -- serve_compiled --------------------------------------------------------


def _outputs(reqs, name):
    return [r.outputs[name] for r in reqs]


def _same_responses(got, want):
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        assert g.dtype == np.asarray(w).dtype, i
        np.testing.assert_array_equal(g, np.asarray(w), err_msg=f"request {i}")


def test_serve_compiled_runs_and_traces_on_the_cpu(tmp_path):
    path = str(tmp_path / "trace.json")
    r = serve_compiled.main(["--device", "cpu", "--trace", path])
    assert r["mlp_equal"] and r["seq_equal"] and r["trace_complete"]
    assert (r["mlp_requests"], r["seq_requests"]) == (64, 27)
    assert r["trace_spans"]["serve.request"] == 64 + 27
    with open(path) as f:
        events = json.load(f)["traceEvents"]  # the file loads as Chrome-trace JSON
    assert {ev["name"] for ev in events} >= set(serve_compiled.TRACE_SPANS)


def test_serve_compiled_trace_holds_repro_s_spans(tmp_path):
    """``repro``'s example under ``--trace`` and the port's: every span
    ``repro``'s trace holds among the compile, specialization, step and
    request spans, the port's holds as often."""
    want, got = str(tmp_path / "repro.json"), str(tmp_path / "port.json")
    try:
        repro_example("serve_compiled").main(["--trace", want])
    finally:
        jtrace.uninstall()
    serve_compiled.main(["--device", "cpu", "--trace", got])
    theirs, ours = serve_compiled.trace_counts(want), serve_compiled.trace_counts(got)
    for name in serve_compiled.TRACE_SPANS:
        assert theirs.get(name, 0) > 0
        assert ours.get(name, 0) == theirs[name], name


def test_serve_compiled_responses_match_repro_servers():
    rng = np.random.default_rng(0)
    model, s_in = serve_compiled.make_mlp(rng)
    cm = compile_model(model, backend="cuda", device="cpu", batch="dynamic")
    jcm = jcompile(to_repro(model), backend="interpret", batch="dynamic")
    srv = CompiledModelServer(cm, CompiledServerConfig(max_batch=32))
    jsrv = JServer(jcm, JServerConfig(max_batch=32))
    rng_j = copy.deepcopy(rng)
    got = serve_compiled.serve_mlp_waves(srv, rng, s_in)
    want = serve_compiled.serve_mlp_waves(jsrv, rng_j, s_in)
    out = cm.output_names[0]
    _same_responses(_outputs(got, out), _outputs(want, out))

    rng2 = np.random.default_rng(1)
    seq_model, y = serve_compiled.make_seq_model(rng2)
    cm2 = compile_model(seq_model, backend="cuda", device="cpu", dynamic_axes={"N": None, "S": 16})
    jcm2 = jcompile(to_repro(seq_model), backend="interpret", dynamic_axes={"N": None, "S": 16})
    srv2 = CompiledModelServer(cm2, CompiledServerConfig(max_batch=8, max_wait_ms=5.0))
    jsrv2 = JServer(jcm2, JServerConfig(max_batch=8, max_wait_ms=5.0))
    rng2_j = copy.deepcopy(rng2)
    _same_responses(_outputs(serve_compiled.serve_seq_waves(srv2, rng2), y),
                    _outputs(serve_compiled.serve_seq_waves(jsrv2, rng2_j), y))


# -- fleet_serve -----------------------------------------------------------


def test_fleet_serve_runs_on_the_cpu():
    r = fleet_serve.main(["--device", "cpu"])
    assert r["fleet_equal"] and r["failover_equal"]
    assert (r["lost"], r["duplicates"], r["plan_cache_misses"]) == (0, 0, 0)
    assert (r["failovers"], r["completed"], r["wave"]) == (1, 12, 12)


def test_fleet_serve_responses_match_repro_router(tmp_path):
    rng = np.random.default_rng(7)
    model, y = fleet_serve.make_model(rng)
    cfg, jcfg = CompiledServerConfig(max_batch=4), JServerConfig(max_batch=4)
    cm = compile_model(model, backend="cuda", device="cpu", dynamic_axes={"N": None, "S": 8})
    jcm = jcompile(to_repro(model), backend="interpret", dynamic_axes={"N": None, "S": 8})
    rng_j = copy.deepcopy(rng)
    fleet_serve.record_cells(CompiledModelServer(cm, cfg), rng)
    fleet_serve.record_cells(JServer(jcm, jcfg), rng_j)
    path, jpath = str(tmp_path / "port.json"), str(tmp_path / "repro.json")
    save_artifact(cm, path)
    jsave_artifact(jcm, jpath)
    router = ShardedRouter.from_artifact(path, replicas=3, server_cfg=cfg,
                                         cfg=RouterConfig(failure_threshold=1), device="cpu")
    jrouter = JRouter.from_artifact(jpath, replicas=3, server_cfg=jcfg,
                                    cfg=JRouterConfig(failure_threshold=1))
    _same_responses(_outputs(fleet_serve.serve_rounds(router, rng), y),
                    _outputs(fleet_serve.serve_rounds(jrouter, rng_j), y))
    wave, done = fleet_serve.failover_wave(router, rng)
    jwave, jdone = fleet_serve.failover_wave(jrouter, rng_j)
    _same_responses(_outputs(wave, y), _outputs(jwave, y))
    assert [r.replica for r in wave] == [r.replica for r in jwave]
    s, js = router.summary(), jrouter.summary()
    for key in ("lost", "duplicates", "rerouted", "failovers", "cell_owners"):
        assert s[key] == js[key], key
    assert len(done) == len(jdone) == len(wave)


# -- serve_quantized -------------------------------------------------------


def test_serve_quantized_runs_on_the_cpu():
    r = serve_quantized.main(["--device", "cpu"])
    assert r["all_generated"] and r["arch"] == "minicpm_2b"
    assert set(r["postures"]) == {"bf16/bf16-kv", "bf16/int8-kv", "w8a8/int8-kv"}
    assert r["postures"]["bf16/bf16-kv"]["agreement"] == 1.0


@pytest.fixture(scope="module")
def minicpm():
    cfg = get_config("minicpm_2b", reduced=True)
    jparams = repro_params(jax.random.PRNGKey(0), cfg)
    params = TM.params_from_numpy(np_tree(jparams), device="cpu")
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, (24,)).astype(np.int32) for _ in range(8)]
    return cfg, jparams, params, prompts


@pytest.mark.parametrize("posture", ["bf16/bf16-kv", "bf16/int8-kv", "w8a8/int8-kv"])
def test_serve_quantized_run_engine_matches_repro(minicpm, posture, monkeypatch):
    cfg, jparams, params, prompts = minicpm
    if posture != "bf16/bf16-kv":
        cfg = dataclasses.replace(cfg, kv_cache_dtype="int8")
    if posture == "w8a8/int8-kv":
        jparams, params = jconvert(jparams), serve_quantized.convert_params_w8a8(params)
    theirs = repro_example("serve_quantized")
    log = []

    def recording_engine(*args, **kw):
        eng = theirs_engine(*args, **kw)
        _record(eng, log)
        return eng

    theirs_engine = theirs.ServeEngine
    monkeypatch.setattr(theirs, "ServeEngine", recording_engine)
    want, _, want_metrics = theirs.run_engine(jparams, cfg, prompts, 8, 4)
    for rows in log:
        top2 = np.sort(rows, axis=-1)[:, -2:]
        margin = top2[:, 1] - top2[:, 0]
        tol = 1e-4 * np.maximum(1.0, np.abs(rows).max(axis=-1))
        assert (margin > tol).all(), "a greedy choice too close to call: the tokens cannot be held"
    got, tput, metrics = serve_quantized.run_engine(params, cfg, prompts, 8, 4)
    assert [list(r.generated) for r in got] == [list(r.generated) for r in want]
    assert metrics == want_metrics
    assert tput > 0
