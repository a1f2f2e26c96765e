"""The port's compiler against the JAX package's, on the CPU.

* every generic op of the port's torch table against
  ``repro.core.runtime.ReferenceRuntime`` (the cases of
  ``tests/test_conformance_sweep.py``, built by ``repro`` and read by the
  port through the shared PQ-IR JSON);
* the quickstart MLP and both token-path graphs: the same step kernel ids in
  the same order as ``repro``'s plan, and equal outputs on the port's ``ref``
  and ``cuda`` backends (on the CPU the ``cuda`` wrappers run their plain
  versions), static and over dynamic batch buckets;
* specializations share the template's const tensors.

Tolerance: 0 on every integer path and every IEEE-exact float32 step.  The
only float tolerance is on the generic ops whose float result depends on
the library's transcendental or summation order (Tanh, Sigmoid, Erf, Sqrt,
Pow, Softmax, float MatMul/means) — ops no fused path uses.
"""
import numpy as np
import pytest
import torch

from repro.core import quant
from repro.core.compile import compile_model as jcompile
from repro.core.patterns import conv_layer, fc_int8_tanh, fc_layer
from repro.core.pqir import GraphBuilder
from repro.core.runtime import ReferenceRuntime
from repro.core.toolchain import MLPSpec, quantize_mlp
from repro.serving.token_path import TokenPathConfig as JConfig
from repro.serving.token_path import build_decode_model as jbuild_decode
from repro.serving.token_path import build_prefill_model as jbuild_prefill
from repro.serving.token_path import make_token_params as jmake_params
from repro_torch.backend.generic import _TOPS
from repro_torch.backend.registry import UnknownKernelError
from repro_torch.core.compile import compile_model
from repro_torch.core.pqir import Model
from test_conformance_sweep import CASES

#: Generic ops with a float result whose last bits depend on the library.
FLOAT_TOLERANT = {"Tanh", "Sigmoid", "Erf", "Sqrt", "Pow", "Softmax", "MatMul",
                  "GlobalAveragePool", "ReduceMean"}


def _port(model) -> Model:
    """A ``repro`` artifact read by the port through the PQ-IR JSON."""
    return Model.from_json(model.to_json())


@pytest.mark.parametrize("op", sorted(_TOPS))
def test_generic_op_matches_reference_runtime(op):
    model, feeds = CASES[op](np.random.default_rng(sorted(_TOPS).index(op)))
    want = ReferenceRuntime(model).run(feeds)
    cm = compile_model(_port(model), backend="ref", device="cpu", fuse=False, optimize=False)
    assert all(s.kernel == f"op.{op}" for s in cm.plan.steps)
    got = cm.run(feeds)
    for name, w in want.items():
        g = got[name].numpy()
        assert g.dtype == w.dtype and g.shape == w.shape, (op, g.dtype, g.shape)
        if op in FLOAT_TOLERANT and np.issubdtype(w.dtype, np.floating):
            np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-6, err_msg=op)
        else:
            np.testing.assert_array_equal(g, w, err_msg=op)


def _quickstart_mlp():
    rng = np.random.default_rng(0)
    spec = MLPSpec(
        weights=[
            rng.normal(size=(64, 128)).astype(np.float32) * 0.2,
            rng.normal(size=(128, 128)).astype(np.float32) * 0.15,
            rng.normal(size=(128, 10)).astype(np.float32) * 0.2,
        ],
        biases=[
            rng.normal(size=(128,)).astype(np.float32) * 0.1,
            rng.normal(size=(128,)).astype(np.float32) * 0.1,
            rng.normal(size=(10,)).astype(np.float32) * 0.1,
        ],
        activations=["Relu", "Relu", None],
    )
    model = quantize_mlp(spec, rng.normal(size=(512, 64)).astype(np.float32),
                         observer="percentile", name="quickstart_mlp")
    x = rng.normal(size=(17, 64)).astype(np.float32)
    return model, quant.quantize(x, eval(model.metadata["input_scale"]), "int8")


@pytest.mark.parametrize("backend", ["ref", "cuda"])
@pytest.mark.parametrize("batch", ["static", "dynamic"])
def test_quickstart_mlp_matches_repro(backend, batch):
    model, xq = _quickstart_mlp()
    jcm = jcompile(model, backend="ref", batch=batch)
    cm = compile_model(_port(model), backend=backend, device="cpu", batch=batch)
    assert [s.kernel for s in cm.plan.steps] == [s.kernel for s in jcm.plan.steps]
    for n in ((17,) if batch == "static" else (1, 3, 17)):
        want = ReferenceRuntime(model).run({"input_q": xq[:n]})
        got = cm.run({"input_q": xq[:n]})
        jgot = jcm.run({"input_q": xq[:n]})
        for k, w in want.items():
            np.testing.assert_array_equal(got[k].numpy(), w)
            np.testing.assert_array_equal(np.asarray(jgot[k]), w)


def _token_graphs():
    cfg = JConfig()
    params = jmake_params(cfg, seed=3)
    return {"prefill": jbuild_prefill(cfg, params), "decode": jbuild_decode(cfg, params)}


@pytest.mark.parametrize("graph", ["prefill", "decode"])
def test_token_graphs_plan_like_repro(graph):
    model = _token_graphs()[graph]
    kw = dict(batch="dynamic", dynamic_axes={"N": None, "S": 8})
    jcm = jcompile(model, backend="ref", **kw)
    want = [s.kernel for s in jcm.plan.steps]
    for backend in ("ref", "cuda"):
        cm = compile_model(_port(model), backend=backend, device="cpu", **kw)
        assert [s.kernel for s in cm.plan.steps] == want
        assert cm.stats["fused_qattention"] == jcm.stats["fused_qattention"] > 0
        assert cm.stats["fused_qlinear"] == jcm.stats["fused_qlinear"] > 0


def test_specializations_share_template_tensors():
    model = _token_graphs()["decode"]
    cm = compile_model(_port(model), backend="cuda", device="cpu", batch="dynamic",
                       dynamic_axes={"N": None, "S": 8})
    tensors = 0
    for bindings in ({"N": 2, "S": 16}, {"N": 4, "S": 8}):
        spec, _ = cm.specialized(bindings)
        for st, ts in zip(spec.steps, cm.plan.steps):
            assert len(st.consts) == len(ts.consts)
            for a, b in zip(st.consts, ts.consts):
                assert a is b
                tensors += isinstance(a, torch.Tensor)
    assert tensors > 0
    # weights are device tensors, K-contiguous and int4-packed on the planned path
    qsteps = [s for s in cm.plan.steps if s.kernel == "qlinear_matmul"]
    packed = [s for s in qsteps if s.params["shape"].get("bits") == 4]
    assert packed and all(s.consts[0].dtype == torch.uint8 for s in packed)
    assert all(s.params["shape"]["layout"] == "nk" for s in qsteps)
    assert "layout=nk" in cm.plan.pretty()
    # shape parameters stay host integers
    slices = [s for s in cm.plan.steps if s.kernel == "op.Slice"]
    assert slices and all(isinstance(c, np.ndarray) for s in slices for c in s.consts)


def test_uint8_activation_folds_on_the_planned_path():
    rng = np.random.default_rng(4)
    w = rng.normal(size=(48, 20)).astype(np.float32) * 0.2
    b = rng.normal(size=(20,)).astype(np.float32) * 0.1
    p = quant.quantize_linear_layer(w, b, 0.02, 0.05, in_dtype="uint8")
    gb = GraphBuilder("fc_u8")
    gb.add_input("x", "uint8", (None, 48))
    y = fc_layer(gb, "x", p, "fc")
    gb.add_output(y, "int8", (None, 20))
    model = gb.build(opset=17)
    x = rng.integers(0, 256, (6, 48)).astype(np.uint8)
    want = ReferenceRuntime(model).run({"x": x})
    for backend in ("ref", "cuda"):
        cm = compile_model(_port(model), backend=backend, device="cpu")
        assert cm.stats["fused_qlinear"] == 1
        if backend == "cuda":
            assert cm.plan.steps[0].params.get("x_uint8")
        for k, v in want.items():
            np.testing.assert_array_equal(cm.run({"x": x})[k].numpy(), v)


def _lut_graph(rng):
    w = rng.normal(size=(16, 8)).astype(np.float32) * 0.3
    p = quant.quantize_linear_layer(w, None, 0.05, 0.05)
    gb = GraphBuilder("fc_tanh")
    gb.add_input("x", "int8", (None, 16))
    y = fc_int8_tanh(gb, "x", p, "l0")
    gb.add_output(y, "int8", (None, 8))
    return gb.build(opset=17), {"x": rng.integers(-128, 128, (5, 16)).astype(np.int8)}


def _conv_graph(rng):
    w = rng.integers(-128, 128, (4, 3, 3, 3)).astype(np.int8)
    b = rng.integers(-3000, 3000, (4,)).astype(np.int32)
    rescale = quant.decompose_multipliers(rng.uniform(1e-4, 1e-3, (4,)))
    gb = GraphBuilder("conv")
    gb.add_input("x", "uint8", (None, 3, 6, 6))
    y = conv_layer(gb, "x", w, b, rescale, "c0", pads=(1, 1, 1, 1), two_mul=True, activation="Relu")
    gb.add_output(y, "int8", (None, 4, 6, 6))
    return gb.build(opset=17), {"x": rng.integers(0, 256, (2, 3, 6, 6)).astype(np.uint8)}


@pytest.mark.parametrize("graph,kernel,stat", [
    (_lut_graph, "qact_lut", "fused_lut"),
    (_conv_graph, "qlinear_conv2d", "fused_qconv"),
])
def test_unported_kernel_raises_on_cuda_and_runs_on_ref(graph, kernel, stat):
    model, feeds = graph(np.random.default_rng(5))
    with pytest.raises(UnknownKernelError, match=kernel):
        compile_model(_port(model), backend="cuda", device="cpu")
    cm = compile_model(_port(model), backend="ref", device="cpu")
    assert cm.stats[stat] == 1
    for k, v in ReferenceRuntime(model).run(feeds).items():
        np.testing.assert_array_equal(cm.run(feeds)[k].numpy(), v)
