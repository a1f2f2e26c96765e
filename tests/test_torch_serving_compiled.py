"""The port's micro-batching server for compiled artifacts against the JAX
package's, on the CPU.

The same artifact (built by ``repro``'s toolchain, read by the port through
the PQ-IR JSON) is served by ``repro.serving.compiled.CompiledModelServer``
over ``repro``'s compiled ``ref`` backend and by the port's server over both
port backends, fed the same requests in the same waves.  Every request's
outputs must be equal, and so must the coalescing: ``batches``,
``padded_rows``, ``bucket_batches`` and, on the (batch × seq) grid,
``grid_batches`` and ``padded_tokens``.  Also: a failed batch re-queues in
order, and an ``autotuner=`` that is not a tuner raises (the background
search itself is in ``tests/test_torch_autotune.py``).

Tolerance: 0.  Every path is integer arithmetic or an IEEE-exact float32
elementwise step in the codified order, so the results are bit-identical.
"""
import numpy as np
import pytest

from repro.core import patterns as jpatterns
from repro.core import pqir as jpqir
from repro.core import quant as jquant
from repro.core.compile import compile_model as jcompile
from repro.core.runtime import ReferenceRuntime
from repro.core.toolchain import MLPSpec, quantize_mlp
from repro.serving.compiled import CompiledModelServer as JServer
from repro.serving.compiled import CompiledServerConfig as JConfig
from repro_torch.core.compile import compile_model
from repro_torch.core.pqir import Model
from repro_torch.serving import CompiledModelServer, CompiledServerConfig

BACKENDS = ("ref", "cuda")
COUNTS = ("requests", "batches", "completed", "padded_rows", "padded_tokens", "window_hits",
          "tuned_swaps", "bucket_batches", "grid_batches")


def _port(model) -> Model:
    return Model.from_json(model.to_json())


def _paper_mlp():
    """The §4/§6 MLP at small widths: Tanh (fp16 flow), Sigmoid, plain FC."""
    rng = np.random.default_rng(23)
    widths = (16, 32, 32, 8)
    spec = MLPSpec(
        weights=[rng.normal(size=(a, b)).astype(np.float32) / np.sqrt(a) for a, b in zip(widths, widths[1:])],
        biases=[rng.normal(size=(b,)).astype(np.float32) * 0.1 for b in widths[1:]],
        activations=["Tanh", "Sigmoid", None],
    )
    model = quantize_mlp(spec, rng.normal(size=(64, 16)).astype(np.float32),
                         tanh_mode="fp16", per_channel=True, name="served_paper_mlp")
    return model, rng


def _seq_model():
    """The named two-axis ('N', 'S', 32) artifact of examples/serve_compiled.py."""
    rng = np.random.default_rng(1)
    p = jquant.quantize_linear_layer(
        rng.normal(size=(32, 16)).astype(np.float32) * 0.2,
        rng.normal(size=(16,)).astype(np.float32) * 0.1, 0.05, 0.1,
    )
    gb = jpqir.GraphBuilder("served_seq_mlp")
    x = gb.add_input("x", "int8", ("N", "S", 32))
    y = jpatterns.fc_layer(gb, x, p, "fc0", two_mul=True, activation="Relu")
    gb.add_output(y, "int8", ("N", "S", 16))
    return gb.build(), rng


def _serve_waves(srv, waves):
    reqs = []
    for wave in waves:
        reqs += [srv.submit(x) for x in wave]
        srv.run_until_drained()
    return reqs


def _counts(srv):
    s = srv.summary()
    return {k: s[k] for k in COUNTS}


@pytest.mark.parametrize("backend", BACKENDS)
def test_paper_mlp_served_like_repro(backend):
    model, rng = _paper_mlp()
    waves = [[rng.integers(-128, 128, (16,)).astype(np.int8) for _ in range(n)]
             for n in (3, 1, 17, 9, 32, 2)]
    jsrv = JServer(jcompile(model, backend="ref", batch="dynamic"), JConfig(max_batch=16))
    srv = CompiledModelServer(compile_model(_port(model), backend=backend, device="cpu",
                                            batch="dynamic"), CompiledServerConfig(max_batch=16))
    jreqs, reqs = _serve_waves(jsrv, waves), _serve_waves(srv, waves)
    out = srv.cm.output_names[0]
    rt = ReferenceRuntime(model)
    for i, (a, b) in enumerate(zip(reqs, jreqs)):
        assert a.done and isinstance(a.outputs[out], np.ndarray)
        np.testing.assert_array_equal(a.outputs[out], np.asarray(b.outputs[out]), err_msg=f"req {i}")
        if i < 8:
            np.testing.assert_array_equal(a.outputs[out], rt.run({"input_q": a.x[None]})[out][0])
    assert _counts(srv) == _counts(jsrv)
    assert srv.summary()["plan_cache"]["misses"] == jsrv.summary()["plan_cache"]["misses"]
    # on cuda both tables ride in the matmul epilogues; ref keeps repro's steps
    assert srv.cm.stats["lut_epilogues"] == (2 if backend == "cuda" else 0)


@pytest.mark.parametrize("backend", BACKENDS)
def test_sequence_grid_served_like_repro(backend):
    """The named-axis 2-D grid of examples/serve_compiled.py: ragged
    sequences coalesce onto (batch-bucket × seq-bucket) cells."""
    model, rng = _seq_model()
    waves = [[rng.integers(-128, 128, (int(rng.integers(1, 40)), 32)).astype(np.int8)
              for _ in range(n)] for n in (5, 8, 3, 11)]
    kw = dict(dynamic_axes={"N": None, "S": 16})
    jsrv = JServer(jcompile(model, backend="ref", **kw), JConfig(max_batch=8))
    srv = CompiledModelServer(compile_model(_port(model), backend=backend, device="cpu", **kw),
                              CompiledServerConfig(max_batch=8))
    assert srv.seq_axis == jsrv.seq_axis == "S"
    jreqs, reqs = _serve_waves(jsrv, waves), _serve_waves(srv, waves)
    out = srv.cm.output_names[0]
    for a, b in zip(reqs, jreqs):
        assert a.outputs[out].shape == (a.x.shape[0], 16)
        np.testing.assert_array_equal(a.outputs[out], np.asarray(b.outputs[out]))
    counts = _counts(srv)
    assert counts == _counts(jsrv) and counts["grid_batches"] and counts["padded_tokens"] > 0


def test_failed_batch_requeues_in_order():
    model, rng = _paper_mlp()
    cm = compile_model(_port(model), backend="cuda", device="cpu", batch="dynamic")
    srv = CompiledModelServer(cm, CompiledServerConfig(max_batch=4))
    reqs = [srv.submit(rng.integers(-128, 128, (16,)).astype(np.int8)) for _ in range(3)]
    real_run = cm.run
    cm.run = lambda feeds: (_ for _ in ()).throw(RuntimeError("launch failed"))
    with pytest.raises(RuntimeError, match="launch failed"):
        srv.step()
    assert [r.uid for r in srv.queue] == [r.uid for r in reqs] and not any(r.done for r in reqs)
    assert srv.metrics["batches"] == 0
    cm.run = real_run
    assert srv.run_until_drained() == reqs
    assert srv.metrics["completed"] == srv.metrics["requests"] == 3


def test_submit_validation_and_admission_window():
    model, rng = _paper_mlp()
    cm = compile_model(_port(model), backend="ref", device="cpu", batch="dynamic")
    srv = CompiledModelServer(cm, CompiledServerConfig(max_batch=4, max_wait_ms=1e6))
    with pytest.raises(ValueError, match="shape"):
        srv.submit(np.zeros((15,), np.int8))
    with pytest.raises(ValueError, match="dtype"):
        srv.submit(np.zeros((16,), np.int16))
    srv.submit(rng.integers(-128, 128, (16,)).astype(np.int8))
    assert srv.step() == [] and len(srv.queue) == 1  # held open by the window
    for _ in range(3):
        srv.submit(rng.integers(-128, 128, (16,)).astype(np.int8))
    assert len(srv.step()) == 4 and srv.metrics["window_hits"] == 0  # a full batch launches


def test_autotuner_raises():
    model, _ = _paper_mlp()
    cm = compile_model(_port(model), backend="ref", device="cpu", batch="dynamic")
    with pytest.raises(TypeError, match="tune_step"):
        CompiledModelServer(cm, autotuner=object())
    cm.autotuner = object()
    with pytest.raises(TypeError, match="tune_step"):
        CompiledModelServer(cm)


def test_rejects_static_artifacts():
    model, _ = _paper_mlp()
    with pytest.raises(ValueError, match="scenario-polymorphic"):
        CompiledModelServer(compile_model(_port(model), backend="ref", device="cpu"))
