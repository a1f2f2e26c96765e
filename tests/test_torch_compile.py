"""The port's compiler against the JAX package's, on the CPU.

* every generic op of the port's torch table against
  ``repro.core.runtime.ReferenceRuntime`` (the cases of
  ``tests/test_conformance_sweep.py``, built by ``repro`` and read by the
  port through the shared PQ-IR JSON; each case's seed pinned in
  ``SEED_ORDER``), and int8 MaxPool / AveragePool with strides and pads
  against ``repro``'s compiled generic ops;
* the quickstart MLP and both token-path graphs: the same step kernel ids in
  the same order as ``repro``'s plan, and equal outputs on the port's ``ref``
  and ``cuda`` backends (on the CPU the ``cuda`` wrappers run their plain
  versions), static and over dynamic batch buckets;
* specializations share the template's const tensors;
* on ``cuda`` a LUT step folds into the epilogue of the matmul that alone
  feeds it (and a uint8 table read only by ``x_uint8`` matmuls is stored
  shifted): the fold's rules case by case, its plan record, and outputs
  equal to ``repro``'s ``interpret`` backend and ``ReferenceRuntime``;
* the paper's Tanh/Sigmoid MLP (both tanh modes) and a per-channel CNN,
  static and over dynamic batch buckets, on both port backends: the fused
  stats and step kernel ids of ``repro``'s plan (on ``cuda`` less the
  folded LUT steps), and outputs equal to
  ``repro``'s ``interpret`` backend (its Pallas kernels in interpret mode)
  and ``ReferenceRuntime``.

Tolerance: 0 on every integer path and every IEEE-exact float32 step.  The
only float tolerance is on the generic ops whose float result depends on
the library's transcendental or summation order (Tanh, Sigmoid, Erf, Sqrt,
Pow, Softmax, float MatMul/means) — ops no fused path uses.
"""
from collections import Counter

import numpy as np
import pytest
import torch

from repro.core import quant
from repro.core.compile import compile_model as jcompile
from repro.core.patterns import conv_layer, fc_int8_tanh, fc_layer
from repro.core.pqir import GraphBuilder
from repro.core.runtime import ReferenceRuntime
from repro.core.toolchain import CNNSpec, ConvLayerSpec, MLPSpec, quantize_cnn, quantize_mlp
from repro.serving.token_path import TokenPathConfig as JConfig
from repro.serving.token_path import build_decode_model as jbuild_decode
from repro.serving.token_path import build_prefill_model as jbuild_prefill
from repro.serving.token_path import make_token_params as jmake_params
from repro_torch.backend.generic import _TOPS
from repro_torch.backend.registry import UnknownKernelError, lookup
from repro_torch.core.compile import compile_model
from repro_torch.core.pqir import Model
from test_conformance_sweep import CASES

#: Generic ops with a float result whose last bits depend on the library.
FLOAT_TOLERANT = {"Tanh", "Sigmoid", "Erf", "Sqrt", "Pow", "Softmax", "MatMul",
                  "GlobalAveragePool", "ReduceMean"}


def _port(model) -> Model:
    """A ``repro`` artifact read by the port through the PQ-IR JSON."""
    return Model.from_json(model.to_json())


#: Each op's case seed: its index here.  The first 31 are the table's ops in
#: sorted order before the pooling ops joined it; new ops are appended, so
#: no existing case's seed moves.
SEED_ORDER = [
    "Add", "Cast", "Clip", "Concat", "ConvInteger", "DequantizeLinear", "Div", "Erf", "Flatten",
    "Gather", "Gemm", "GlobalAveragePool", "MatMul", "MatMulInteger", "Mul", "Pow",
    "QuantizeLinear", "ReduceMax", "ReduceMean", "ReduceSum", "Relu", "Reshape", "Sigmoid",
    "Slice", "Softmax", "Sqrt", "Squeeze", "Sub", "Tanh", "Transpose", "Unsqueeze",
    "AveragePool", "MaxPool",
]


def test_every_op_has_a_pinned_seed():
    assert sorted(SEED_ORDER) == sorted(_TOPS) and len(set(SEED_ORDER)) == len(SEED_ORDER)


@pytest.mark.parametrize("op", sorted(_TOPS))
def test_generic_op_matches_reference_runtime(op):
    model, feeds = CASES[op](np.random.default_rng(SEED_ORDER.index(op)))
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


@pytest.mark.parametrize("backend", ["ref", "cuda"])
def test_slice_with_a_negative_step_matches_repro(backend):
    """ONNX's clamping for a negative step: x = arange(40) as (4, 10),
    starts [8], ends [0], axes [1], steps [-2] gives rows [8, 6, 4, 2] (+10
    a row), equal to ``repro``'s compiled generic op and ReferenceRuntime."""
    gb = GraphBuilder("slice_back")
    x = gb.add_input("x", "int32", (4, 10))
    args = [gb.add_initializer(n, np.array([v], np.int64))
            for n, v in (("starts", 8), ("ends", 0), ("axes", 1), ("steps", -2))]
    y = gb.op("Slice", [x] + args)
    gb.add_output(y, "int32", (4, 4))
    model = gb.build()
    feeds = {"x": np.arange(40, dtype=np.int32).reshape(4, 10)}
    want = ReferenceRuntime(model).run(feeds)[y]
    np.testing.assert_array_equal(want[0], [8, 6, 4, 2])
    jgot = jcompile(model, backend="ref", fuse=False, optimize=False).run(feeds)[y]
    np.testing.assert_array_equal(np.asarray(jgot), want)
    cm = compile_model(_port(model), backend=backend, device="cpu", fuse=False, optimize=False)
    assert [s.kernel for s in cm.plan.steps] == ["op.Slice"]
    got = cm.run(feeds)[y]
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


def _pool_model(op, kernel, stride, pad, dtype):
    gb = GraphBuilder(f"{op.lower()}_{dtype}")
    x = gb.add_input("x", dtype, (2, 3, 9, 9))
    y = gb.op(op, [x], kernel_shape=(kernel, kernel), strides=(stride, stride), pads=(pad,) * 4)
    out = (9 + 2 * pad - kernel) // stride + 1
    gb.add_output(y, dtype, (2, 3, out, out))
    return gb.build()


@pytest.mark.parametrize("op", ["MaxPool", "AveragePool"])
@pytest.mark.parametrize("kernel,stride,pad", [(2, 2, 0), (3, 2, 1)], ids=["2x2s2", "3x3s2p1"])
@pytest.mark.parametrize("backend", ["ref", "cuda"])
def test_int8_pool_matches_repro_generic_op(op, kernel, stride, pad, backend):
    """int8 pooling with strides and pads: the port's generic op equals
    ``repro``'s compiled generic op and ReferenceRuntime, tolerance 0.

    ``repro``'s generic MaxPool refuses int8 (``reduce_window`` gets an
    int32 init value beside int8 operands; ROADMAP.md §C), so its int8
    answer is its float32 MaxPool of the same codes cast back: exact, since
    every int8 code is a float32 and the max of codes is a code."""
    model = _pool_model(op, kernel, stride, pad, "int8")
    x = np.random.default_rng(kernel).integers(-128, 128, (2, 3, 9, 9)).astype(np.int8)
    if op == "MaxPool":
        jcm = jcompile(_pool_model(op, kernel, stride, pad, "float32"), fuse=False, optimize=False)
        want = {k: np.asarray(v).astype(np.int8) for k, v in jcm.run({"x": x.astype(np.float32)}).items()}
    else:
        want = {k: np.asarray(v) for k, v in jcompile(model, fuse=False, optimize=False).run({"x": x}).items()}
    cm = compile_model(_port(model), backend=backend, device="cpu", fuse=False, optimize=False)
    assert [s.kernel for s in cm.plan.steps] == [f"op.{op}"]
    got = cm.run({"x": x})
    rt = ReferenceRuntime(model).run({"x": x})
    for (name, g), w in zip(got.items(), want.values()):
        assert g.dtype == torch.int8 and g.shape == w.shape
        np.testing.assert_array_equal(g.numpy(), w, err_msg=op)
        np.testing.assert_array_equal(rt[name], w, err_msg=op)


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
    """The port plans repro's steps, but for the decode graph's KV updates:
    each codified Sub, Mul, Mul, Add group on a state is one ``kv_write``
    step at the Add (``core/compile.py::_match_kv_write``), two a layer."""
    model = _token_graphs()[graph]
    kw = dict(batch="dynamic", dynamic_axes={"N": None, "S": 8})
    jcm = jcompile(model, backend="ref", **kw)
    for backend in ("ref", "cuda"):
        cm = compile_model(_port(model), backend=backend, device="cpu", **kw)
        groups = [f.nodes for f in cm.plan.provenance.fusions if f.pattern == "kv_write"]
        kinds = {s.name: s.kernel for s in jcm.plan.steps}
        assert all([kinds[n] for n in g] == ["op.Sub", "op.Mul", "op.Mul", "op.Add"] for g in groups)
        sinks = {g[-1] for g in groups}
        folded = {n for g in groups for n in g[:-1]}
        want = ["kv_write" if s.name in sinks else s.kernel
                for s in jcm.plan.steps if s.name not in folded]
        assert [s.kernel for s in cm.plan.steps] == want
        assert cm.stats["fused_kv_write"] == len(groups) == (2 * JConfig().n_layers if graph == "decode" else 0)
        assert cm.stats["fused_qattention"] == jcm.stats["fused_qattention"] > 0
        assert cm.stats["fused_qlinear"] == jcm.stats["fused_qlinear"] > 0


#: A Mellum2-shaped token path at a small size: GQA, window layers with
#: ring caches, routed experts.
MELLUM2_SHAPED = dict(vocab=97, d_model=64, n_heads=4, n_layers=4, n_kv_heads=2, head_dim=16,
                      layer_kinds=("window", "window", "window", "full"), window=8,
                      n_experts=8, top_k=2, d_expert=32)


@pytest.mark.parametrize("case", ["mha", "mellum2"])
def test_each_region_is_matched_once(case, monkeypatch):
    """A dynamic compile tries each region matcher at most once on a node,
    the fusion and the padding proof sharing its captures, and records
    every qattention fusion, then every qmoe, then every kv_write, before
    any chain fusion."""
    from repro_torch.core import compile as port_compile
    from repro_torch.core import moe
    from repro_torch.serving import token_path as port_tp

    tried = Counter()
    for module, name in ((port_compile, "_match_qattention"), (moe, "match_qmoe"),
                         (port_compile, "_match_kv_write")):
        def spy(ga, node, *rest, _real=getattr(module, name), _name=name):
            tried[_name, node.name] += 1
            return _real(ga, node, *rest)
        monkeypatch.setattr(module, name, spy)
    cfg = port_tp.TokenPathConfig(**(MELLUM2_SHAPED if case == "mellum2" else {}))
    params = port_tp.make_token_params(cfg, seed=3)
    regions = ["qattention", "qmoe", "kv_write"]
    for graph, build in (("prefill", port_tp.build_prefill_model), ("decode", port_tp.build_decode_model)):
        tried.clear()
        cm = compile_model(build(cfg, params), backend="cuda", device="cpu", batch="dynamic",
                           dynamic_axes={"N": None, "S": 8})
        assert {name for name, _ in tried} == {"_match_qattention", "_match_kv_write"} | (
            {"match_qmoe"} if case == "mellum2" else set())
        assert max(tried.values()) == 1, [k for k, v in tried.items() if v > 1]
        kinds = [f.pattern for f in cm.plan.provenance.fusions]
        head = kinds[:sum(k in regions for k in kinds)]
        assert head == sorted(head, key=regions.index) and set(head) <= set(regions)
        for kind in regions:
            assert kinds.count(kind) == cm.stats[f"fused_{kind}"]
        assert cm.stats["fused_qattention"] > 0
        assert cm.stats["fused_qmoe"] == (cfg.n_layers if case == "mellum2" else 0)
        assert cm.stats["fused_kv_write"] == (2 * cfg.n_layers if graph == "decode" else 0)


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
    """Checks that the LUT and conv kernels fuse and run on both backends.

    The name records when both kernels were ``ref``-only and raised
    ``UnknownKernelError`` on ``cuda``; it is kept so the test's history
    stays traceable.  Both are ported now: each backend compiles the fused
    step and matches ``ReferenceRuntime``, and only a kernel id registered
    on no backend still raises."""
    model, feeds = graph(np.random.default_rng(5))
    for backend in ("ref", "cuda"):
        cm = compile_model(_port(model), backend=backend, device="cpu")
        kernels = [s.kernel for s in cm.plan.steps]
        assert cm.stats[stat] == 1
        if backend == "cuda" and kernel == "qact_lut":
            # the table rides in the epilogue of the matmul that feeds it
            (step,) = cm.plan.steps
            assert kernels == ["qlinear_matmul"] and step.params["lut"] == "Tanh"
            assert step.consts[4].dtype == torch.int8 and step.consts[4].shape == (256,)
            assert cm.stats["lut_epilogues"] == 1
        else:
            assert kernel in kernels
        for k, v in ReferenceRuntime(model).run(feeds).items():
            np.testing.assert_array_equal(cm.run(feeds)[k].numpy(), v)
    with pytest.raises(UnknownKernelError, match="no_such_kernel"):
        lookup("cuda", "no_such_kernel")


def _paper_mlp(tanh_mode):
    """The §4/§6 MLP: FC→Tanh, FC→Sigmoid (uint8 out, read by the last FC's
    x_uint8 fold), FC with no activation; per-channel weights."""
    rng = np.random.default_rng(17)
    widths = (24, 40, 40, 12)
    spec = MLPSpec(
        weights=[rng.normal(size=(a, b)).astype(np.float32) / np.sqrt(a) for a, b in zip(widths, widths[1:])],
        biases=[rng.normal(size=(b,)).astype(np.float32) * 0.1 for b in widths[1:]],
        activations=["Tanh", "Sigmoid", None],
    )
    model = quantize_mlp(spec, rng.normal(size=(128, 24)).astype(np.float32),
                         tanh_mode=tanh_mode, per_channel=True, name=f"paper_mlp_{tanh_mode}")
    return model, rng.integers(-128, 128, (9, 24)).astype(np.int8)


def _paper_cnn():
    """The §5 CNN as quantize_cnn emits it: stride-2 convs with ReLU (a 7×7
    stem and a 3×3 conv, C·kH·kW = 147 and 72) and an FC head; per-channel."""
    rng = np.random.default_rng(19)
    convs = [
        ConvLayerSpec(rng.normal(size=(8, 3, 7, 7)).astype(np.float32) / np.sqrt(147),
                      rng.normal(size=(8,)).astype(np.float32) * 0.1,
                      strides=(2, 2), pads=(3, 3, 3, 3), activation="Relu"),
        ConvLayerSpec(rng.normal(size=(16, 8, 3, 3)).astype(np.float32) / np.sqrt(72), None,
                      strides=(2, 2), pads=(1, 1, 1, 1), activation="Relu"),
    ]
    head = MLPSpec([rng.normal(size=(16 * 4 * 4, 10)).astype(np.float32) / 16.0],
                   [rng.normal(size=(10,)).astype(np.float32) * 0.1], [None])
    model = quantize_cnn(CNNSpec(convs, head), rng.normal(size=(4, 3, 16, 16)).astype(np.float32),
                         per_channel=True, name="paper_cnn")
    return model, rng.integers(-128, 128, (5, 3, 16, 16)).astype(np.int8)


PAPER_GRAPHS = {
    "mlp_tanh_int8": lambda: _paper_mlp("int8"),
    "mlp_tanh_fp16": lambda: _paper_mlp("fp16"),
    "cnn": _paper_cnn,
}


@pytest.mark.parametrize("backend", ["ref", "cuda"])
@pytest.mark.parametrize("batch", ["static", "dynamic"])
@pytest.mark.parametrize("graph", sorted(PAPER_GRAPHS))
def test_paper_models_match_repro(graph, batch, backend):
    model, x = PAPER_GRAPHS[graph]()
    jcm = jcompile(model, backend="interpret", batch=batch)
    cm = compile_model(_port(model), backend=backend, device="cpu", batch=batch)
    jkernels = [s.kernel for s in jcm.plan.steps]
    # ref keeps repro's plan step for step; cuda folds every LUT of these
    # graphs into the matmul that feeds it
    want = jkernels if backend == "ref" else [k for k in jkernels if k != "qact_lut"]
    assert [s.kernel for s in cm.plan.steps] == want
    for stat in ("fused_qlinear", "fused_qconv", "fused_lut", "generic"):
        assert cm.stats[stat] == jcm.stats[stat], stat
    assert cm.stats["fused_lut"] == (2 if graph.startswith("mlp") else 0)
    assert cm.stats["lut_epilogues"] == (cm.stats["fused_lut"] if backend == "cuda" else 0)
    assert cm.stats["fused_qconv"] == (2 if graph == "cnn" else 0)
    rt = ReferenceRuntime(model)
    for n in ((len(x),) if batch == "static" else (1, 3, len(x))):
        want = rt.run({"input_q": x[:n]})
        got = cm.run({"input_q": x[:n]})
        jgot = jcm.run({"input_q": x[:n]})
        for k, w in want.items():
            np.testing.assert_array_equal(got[k].numpy(), w)
            np.testing.assert_array_equal(np.asarray(jgot[k]), w)


def _assert_like_repro(model, feeds_list, cm, batch):
    """Outputs of ``cm`` equal ``repro``'s interpret backend and
    ``ReferenceRuntime`` on every feed dict."""
    jcm = jcompile(model, backend="interpret", batch=batch)
    rt = ReferenceRuntime(model)
    for feeds in feeds_list:
        got, jgot = cm.run(feeds), jcm.run(feeds)
        for k, w in rt.run(feeds).items():
            assert got[k].numpy().dtype == w.dtype
            np.testing.assert_array_equal(got[k].numpy(), w, err_msg=k)
            np.testing.assert_array_equal(np.asarray(jgot[k]), w, err_msg=k)


@pytest.mark.parametrize("batch", ["static", "dynamic"])
@pytest.mark.parametrize("tanh_mode", ["int8", "fp16"])
def test_lut_folds_into_the_matmul_epilogue(tanh_mode, batch):
    """The paper MLP on cuda: three matmul steps, the Tanh table (int8) in
    the first's epilogue, the Sigmoid table stored shifted (u − 128 as int8)
    in the second's, and the last FC reads int8 with no shift launch."""
    model, x = _paper_mlp(tanh_mode)
    cm = compile_model(_port(model), backend="cuda", device="cpu", batch=batch)
    ref = compile_model(_port(model), backend="ref", device="cpu", batch=batch)
    steps = cm.plan.steps
    assert [s.kernel for s in steps] == ["qlinear_matmul"] * 3
    assert [s.params.get("lut") for s in steps] == ["Tanh", "Sigmoid,u8-128", None]
    assert cm.stats["lut_epilogues"] == cm.stats["fused_lut"] == 2
    assert not steps[2].params.get("x_uint8") and steps[1].out_info[0].dtype == "int8"
    tables = [s.consts[0] for s in ref.plan.steps if s.kernel == "qact_lut"]
    assert torch.equal(steps[0].consts[4], tables[0]) and tables[1].dtype == torch.uint8
    assert torch.equal(steps[1].consts[4], (tables[1] ^ 128).view(torch.int8))
    lines = [f for f in cm.plan.provenance.fusions if f.pattern == "lut_epilogue"]
    assert [f.anchor for f in lines] == [steps[0].name, steps[1].name]
    ns = (len(x),) if batch == "static" else (1, 3, len(x))
    _assert_like_repro(model, [{"input_q": x[:n]} for n in ns], cm, batch)


def _lut(gb, q, prefix, act, out_dtype):
    """DQL → act → QL on the int8 tensor ``q`` (the paper's Fig 4/6 chain);
    returns the activation's tensor name."""
    s = gb.add_initializer(f"{prefix}_dq_scale", np.float32(4.0 / 127.0))
    zp = gb.add_initializer(f"{prefix}_dq_zp", np.zeros((), np.int8))
    deq = gb.op("DequantizeLinear", [q, s, zp], out_hint=f"{prefix}_deq")
    a = gb.op(act, [deq], out_hint=f"{prefix}_act")
    qs = gb.add_initializer(f"{prefix}_q_scale", np.float32(1 / 127 if act == "Tanh" else 1 / 255))
    qz = gb.add_initializer(f"{prefix}_q_zp", np.zeros((), out_dtype))
    return gb.op("QuantizeLinear", [a, qs, qz], out_hint=f"{prefix}_req")


def _fc_lut(gb, x, p, prefix, act, out_dtype):
    """An FC whose int8 output goes through the LUT chain; returns
    (pre-activation, activation) tensor names."""
    q = fc_layer(gb, x, p, prefix, two_mul=act == "Tanh")
    return q, _lut(gb, q, prefix, act, out_dtype)


def _fc_params(rng, k, n, in_dtype="int8"):
    w = rng.normal(size=(k, n)).astype(np.float32) * 0.3
    b = rng.normal(size=(n,)).astype(np.float32) * 0.1
    return quant.quantize_linear_layer(w, b, 0.05, 0.05, in_dtype=in_dtype)


def _refused_fold_graph(case, rng):
    """An FC → Tanh that must not fold, a LUT on a graph input, and an FC →
    Tanh (int8) → Tanh chain whose second LUT must not fold."""
    gb = GraphBuilder(f"nofold_{case}")
    gb.add_input("x", "int8", (None, 16))
    if case == "graph_input":
        gb.add_output(_lut(gb, "x", "l0", "Tanh", "int8"), "int8", (None, 16))
        return gb.build(opset=17)
    q, y = _fc_lut(gb, "x", _fc_params(rng, 16, 8), "l0", "Tanh", "int8")
    if case == "lut_chain":  # the int8 Tanh output is int8-symmetric: a LUT matches on it
        gb.add_output(_lut(gb, y, "l1", "Tanh", "int8"), "int8", (None, 8))
        return gb.build(opset=17)
    gb.add_output(y, "int8", (None, 8))
    if case == "preact_is_output":
        gb.add_output(q, "int8", (None, 8))
    else:  # second_reader: another FC reads the pre-activation too
        gb.add_output(fc_layer(gb, q, _fc_params(rng, 8, 6), "l1"), "int8", (None, 6))
    return gb.build(opset=17)


@pytest.mark.parametrize("case", ["preact_is_output", "second_reader", "graph_input", "lut_chain"])
def test_lut_stays_standalone_where_the_fold_rules_refuse(case):
    """A LUT whose input is also a graph output, has a second reader, or is
    a graph input keeps its own qact_lut step on cuda; of a LUT → LUT chain
    the first folds and the second stays, since a matmul takes one table."""
    rng = np.random.default_rng(23)
    model = _refused_fold_graph(case, rng)
    cm = compile_model(_port(model), backend="cuda", device="cpu")
    folds = 1 if case == "lut_chain" else 0
    assert cm.stats["fused_lut"] == 1 + folds and cm.stats["lut_epilogues"] == folds
    assert [s.kernel for s in cm.plan.steps].count("qact_lut") == 1
    assert [s.params.get("lut") for s in cm.plan.steps if "lut" in s.params] == ["Tanh"] * folds
    assert all(len(s.consts) <= 5 for s in cm.plan.steps if s.kernel == "qlinear_matmul")
    _assert_like_repro(model, [{"x": rng.integers(-128, 128, (5, 16)).astype(np.int8)}], cm,
                       "static")


def _sigmoid_readers_graph(case, rng):
    """FC → Sigmoid (uint8) read by two FCs, or by an FC and a graph output,
    or by an FC and a generic Cast."""
    gb = GraphBuilder(f"sigmoid_{case}")
    gb.add_input("x", "int8", (None, 16))
    _, u = _fc_lut(gb, "x", _fc_params(rng, 16, 24), "l0", "Sigmoid", "uint8")
    y1 = fc_layer(gb, u, _fc_params(rng, 24, 8, "uint8"), "l1")
    gb.add_output(y1, "int8", (None, 8))
    if case == "two_fcs":
        gb.add_output(fc_layer(gb, u, _fc_params(rng, 24, 6, "uint8"), "l2"), "int8", (None, 6))
    elif case == "fc_and_output":
        gb.add_output(u, "uint8", (None, 24))
    else:  # fc_and_generic
        gb.add_output(gb.op("Cast", [u], out_hint="wide", to="int32"), "int32", (None, 24))
    return gb.build(opset=17)


@pytest.mark.parametrize("case", ["two_fcs", "fc_and_output", "fc_and_generic"])
def test_shift_fold_needs_every_reader_an_x_uint8_matmul(case):
    """A folded Sigmoid table is stored shifted only where every reader of
    its output is an x_uint8 matmul; otherwise it stays uint8 and the
    readers keep their shift."""
    rng = np.random.default_rng(29)
    model = _sigmoid_readers_graph(case, rng)
    cm = compile_model(_port(model), backend="cuda", device="cpu")
    steps = cm.plan.steps
    assert cm.stats["lut_epilogues"] == 1 and "qact_lut" not in [s.kernel for s in steps]
    head = steps[0]
    readers = [s for s in steps[1:] if s.kernel == "qlinear_matmul"]
    if case == "two_fcs":
        assert head.params["lut"] == "Sigmoid,u8-128" and head.consts[4].dtype == torch.int8
        assert len(readers) == 2 and not any(r.params.get("x_uint8") for r in readers)
        assert head.out_info[0].dtype == "int8"
    else:
        assert head.params["lut"] == "Sigmoid,u8" and head.consts[4].dtype == torch.uint8
        assert len(readers) == 1 and readers[0].params["x_uint8"]
        assert head.out_info[0].dtype == "uint8"
    _assert_like_repro(model, [{"x": rng.integers(-128, 128, (7, 16)).astype(np.int8)}], cm,
                       "static")


def test_plan_printout_shows_the_lut_epilogue():
    """print(plan) shows the table on the matmul step's record; every
    specialization keeps the record and shares the template's table."""
    model, _ = _paper_mlp("fp16")
    cm = compile_model(_port(model), backend="cuda", device="cpu", batch="dynamic")
    text = str(cm.plan)
    assert "lut=Tanh," in text and "lut=Sigmoid,u8-128," in text and "qact_lut" not in text
    assert "lut_epilogue @" in cm.plan.pretty(verbose=True)
    tables = [s.consts[4] for s in cm.plan.steps if "lut" in s.params]
    for bucket in (1, 4):
        spec, _ = cm.specialized(bucket)
        assert [s.params.get("lut") for s in spec.steps] == ["Tanh", "Sigmoid,u8-128", None]
        assert all(s.consts[4] is t for s, t in zip(spec.steps, tables))
        assert "lut=Sigmoid,u8-128" in str(spec)


def test_conv_template_records_and_shared_tensors():
    """The cuda conv step's record shows the im2col GEMM layout; each batch
    bucket binds M = N_bucket·OH·OW and shares the template's tensors."""
    model, _ = _paper_cnn()
    cm = compile_model(_port(model), backend="cuda", device="cpu", batch="dynamic")
    convs = [s for s in cm.plan.steps if s.kernel == "qlinear_conv2d"]
    rec = convs[0].params["shape"]
    assert (rec["k"], rec["kp"], rec["np"], rec["kh"], rec["kw"]) == (147, 192, 64, 7, 7)
    assert rec["strides"] == (2, 2) and rec["pads"] == (3, 3, 3, 3) and not rec["x_uint8"]
    assert rec["lead"][1:] == (8, 8) and convs[0].consts[0].shape == (64, 192)
    assert "kh=7" in cm.plan.pretty()
    for bucket in (1, 4):
        spec, _ = cm.specialized(bucket)
        bound = [s for s in spec.steps if s.kernel == "qlinear_conv2d"]
        assert [s.params["shape"]["m"] for s in bound] == [bucket * 64, bucket * 16]
        for st, ts in zip(bound, convs):
            assert all(a is b for a, b in zip(st.consts, ts.consts))


def test_axis_position_maps_match_repro():
    model, _ = _quickstart_mlp()
    seq = _token_graphs()["prefill"]
    for m, kw in ((model, dict(batch="dynamic")), (model, {}),
                  (seq, dict(batch="dynamic", dynamic_axes={"N": None, "S": 8}))):
        jcm = jcompile(m, backend="ref", **kw)
        cm = compile_model(_port(m), backend="ref", device="cpu", **kw)
        assert cm.axis_input_pos == jcm.axis_input_pos
        assert cm.output_axis_pos == jcm.output_axis_pos


def _tiny_token_path():
    from repro_torch.serving.token_path import CompiledTokenPath, TokenPathConfig, make_token_params

    cfg = TokenPathConfig()
    return cfg, CompiledTokenPath(cfg, make_token_params(cfg, seed=3), backend="cuda", device="cpu")


def test_token_path_head_views_reach_qattention_uncopied(monkeypatch):
    """The decode step hands qattention the per-head Slice views of the qkv
    projection and of the updated KV cache as they are — strided, never
    copied — with the record's cluster size; the plain version gives the
    same codes on those views as on contiguous copies."""
    from repro_torch.kernels import qattention as qatt

    cfg, tp = _tiny_token_path()
    seen = []
    real = qatt.qattention

    def spy(q, k, v, mask, lut, **kw):
        seen.append(((q, k, v, mask, lut), kw))
        return real(q, k, v, mask, lut, **kw)

    monkeypatch.setattr(qatt, "qattention", spy)
    n, s = 2, 16
    rng = np.random.default_rng(0)
    tp.decode_step(rng.integers(1, cfg.vocab, (n, 1)).astype(np.int32), np.array([3, 9]),
                   tp.init_cache(n, s))
    assert len(seen) == cfg.n_heads * cfg.n_layers
    for (q, k, v, mask, lut), kw in seen:
        for x in (q, k, v):
            assert x._base is not None and not x.is_contiguous() and qatt.accepts_view(x)
        assert k.stride(1) == cfg.d_model and q.stride(0) == 3 * cfg.d_model
        rows, t = q.shape[0] * q.shape[1], k.shape[1]
        assert q.shape[1] == 1 and t >= s and kw["cluster"] == qatt.choose_cluster(rows, t, cfg.d_head)
        plain_kw = {key: val for key, val in kw.items() if key != "cluster"}
        np.testing.assert_array_equal(
            qatt.qattention_plain(q, k, v, mask, lut, **plain_kw).numpy(),
            qatt.qattention_plain(*(x.contiguous() for x in (q, k, v, mask)), lut,
                                  **plain_kw).numpy(),
        )


@pytest.mark.parametrize("graph,bindings,cluster", [
    ("decode", {"N": 4, "S": 512}, 16),
    ("prefill", {"N": 4, "S": 128}, 1),
])
def test_plan_printout_shows_attention_cluster(graph, bindings, cluster):
    """A specialized attention step carries its planned cluster size in its
    record: print(plan) and the provenance's tile record show it."""
    from repro_torch.kernels import qattention as qatt

    cfg, tp = _tiny_token_path()
    cm = tp.decode_cm if graph == "decode" else tp.prefill_cm
    plan, _ = cm.specialized(bindings)
    steps = [st for st in plan.steps if st.kernel == "qattention"]
    assert len(steps) == cfg.n_heads * cfg.n_layers
    s = 1 if graph == "decode" else bindings["S"]
    want = qatt.choose_cluster(bindings["N"] * s, bindings["S"], cfg.d_head)
    assert want == cluster
    assert all(st.params["shape"]["cluster"] == cluster for st in steps)
    assert f"cluster={cluster}" in str(plan)
    rec = f"b={bindings['N']},s={s},t={bindings['S']},dh={cfg.d_head},cluster={cluster}"
    assert rec in plan.pretty(verbose=True)
