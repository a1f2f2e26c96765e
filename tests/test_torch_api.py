"""Public names of ``repro`` that the port adds last, each against ``repro``
on the CPU:

* ``ExecutionPlan.execute_dict_env`` — the name-keyed interpreter of a plan
  equals the slot-pool ``execute`` bit for bit, on the quickstart-style MLP
  (``tests/test_backend_plan.py::_mlp``, and equal to ``repro``'s
  ``execute_dict_env``) and on the token path's prefill specialized at
  (N, S) = (2, 8), on both port backends;
* ``CompiledModel.batch_input_names`` / ``batch_output_names`` — equal to
  ``repro``'s on the graphs of ``tests/test_batch_polymorphic.py``'s
  mis-declared-output and batch-independent-output cases and on the MLP;
* ``backend/cost.py`` — ``roofline_terms`` with its collective term and
  ``peak=``, and ``roofline_fraction``, equal to ``repro``'s for the same
  hardware numbers (a port ``HardwareSpec`` carrying TPU v5e's); the
  H100's data-sheet figures; today's two-argument calls unchanged;
* ``kernels/ops.py::quantized_conv2d`` — equal to ``repro``'s for int8 and
  unpadded uint8 inputs; a padded uint8 input equal to
  ``ReferenceRuntime`` (``repro``'s fused conv pads the shifted input
  otherwise: ROADMAP §C, reference side).

Tolerance 0 everywhere: integer paths, and float divisions of the same
operands in the cost model.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp
from repro.backend import cost as jcost
from repro.core import quant as jquant
from repro.core.compile import compile_model as jcompile
from repro.core.patterns import conv_layer, fc_layer
from repro.core.pqir import GraphBuilder
from repro.core.runtime import ReferenceRuntime
from repro.kernels import ops as jops
from repro.serving.token_path import TokenPathConfig as JConfig
from repro.serving.token_path import build_prefill_model as jbuild_prefill
from repro.serving.token_path import make_token_params as jmake_params
from repro_torch.backend import cost
from repro_torch.core.compile import compile_model
from repro_torch.core.pqir import Model
from repro_torch.kernels import launch_counts, ops

from test_backend_plan import _mlp
from test_torch_kernels import CONV_CASES, _conv_operands


def _port(model) -> Model:
    return Model.from_json(model.to_json())


def _same(a: dict, b: dict):
    assert set(a) == set(b)
    for k in a:
        assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, k
        assert torch.equal(a[k], b[k]), k


# ---------------------------------------------------------------------------
# ExecutionPlan.execute_dict_env
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("backend", ["ref", "cuda"])
def test_dict_env_equals_execute_on_the_mlp(backend):
    model, xq = _mlp(np.random.default_rng(4))
    cm = compile_model(_port(model), backend=backend, device="cpu")
    feeds = {"input_q": torch.from_numpy(xq)}
    got = cm.plan.execute_dict_env(feeds)
    _same(got, cm.plan.execute(feeds))
    want = jcompile(model, backend="ref").plan.execute_dict_env({"input_q": jnp.asarray(xq)})
    for k, v in want.items():
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(v))


@pytest.mark.parametrize("backend", ["ref", "cuda"])
def test_dict_env_equals_execute_on_the_token_prefill(backend):
    cfg = JConfig()
    model = jbuild_prefill(cfg, jmake_params(cfg, seed=3))
    cm = compile_model(_port(model), backend=backend, device="cpu", batch="dynamic",
                       dynamic_axes={"N": None, "S": 8})
    plan, _ = cm.specialized({"N": 2, "S": 8})
    rng = np.random.default_rng(5)
    feeds = {"tokens": torch.from_numpy(rng.integers(0, cfg.vocab, (2, 8)).astype(np.int32)),
             "mask": torch.tril(torch.ones((8, 8))).expand(2, 8, 8).contiguous()}
    got = plan.execute_dict_env(feeds)
    assert len(got) == len(model.graph.outputs)
    _same(got, plan.execute(feeds))


# ---------------------------------------------------------------------------
# CompiledModel.batch_input_names / batch_output_names
# ---------------------------------------------------------------------------

def _misdeclared():
    rng = np.random.default_rng(14)
    p = jquant.quantize_linear_layer(rng.normal(size=(16, 8)).astype(np.float32) * 0.2,
                                     rng.normal(size=(8,)).astype(np.float32) * 0.1, 0.05, 0.1)
    gb = GraphBuilder("misdeclared")
    x = gb.add_input("x", "int8", (None, 16))
    y = fc_layer(gb, x, p, "fc0", two_mul=True)
    gb.add_output(y, "int8", (4, 8))  # wrong: the leading dim is dynamic
    return gb.build(), {}


def _batch_independent():
    gb = GraphBuilder("aux")
    x = gb.add_input("x", "float32", (None, 4))
    c1 = gb.add_initializer("c1", np.arange(5, dtype=np.float32))
    c2 = gb.add_initializer("c2", np.ones(5, np.float32))
    y = gb.op("Relu", [x])
    z = gb.op("Add", [c1, c2])
    gb.add_output(y, "float32", (None, 4))
    gb.add_output(z, "float32", (5,))
    return gb.build(), dict(optimize=False, fuse=False)


@pytest.mark.parametrize("case", ["misdeclared", "batch_independent", "mlp", "mlp_static"])
def test_batch_names_equal_repro(case):
    if case.startswith("mlp"):
        model, kw = _mlp(np.random.default_rng(4))[0], {}
    else:
        model, kw = {"misdeclared": _misdeclared, "batch_independent": _batch_independent}[case]()
    batch = "static" if case == "mlp_static" else "dynamic"
    jcm = jcompile(model, backend="ref", batch=batch, **kw)
    cm = compile_model(_port(model), backend="ref", device="cpu", batch=batch, **kw)
    assert cm.batch_input_names == jcm.batch_input_names
    assert cm.batch_output_names == jcm.batch_output_names
    assert bool(cm.batch_output_names) == (batch == "dynamic")


# ---------------------------------------------------------------------------
# backend/cost.py: the roofline half
# ---------------------------------------------------------------------------

#: TPU v5e's figures in a port HardwareSpec (its SM and shared-memory
#: fields are the H100's: the roofline terms do not read them).
_V5E = cost.HardwareSpec(
    name="tpu_v5e", peak_int8_ops=jcost.TPU_V5E.peak_int8_flops, hbm_bw=jcost.TPU_V5E.hbm_bw,
    sms=cost.H100_SXM.sms, smem_per_block=cost.H100_SXM.smem_per_block,
    peak_bf16_flops=jcost.TPU_V5E.peak_bf16_flops, link_bw=jcost.TPU_V5E.ici_bw, chips=jcost.TPU_V5E.chips)


@pytest.mark.parametrize("flops,hbm,coll", [(3.7e15, 2.1e11, 6.4e9), (1e9, 5e6, 0.0), (0.0, 0.0, 1.0)])
@pytest.mark.parametrize("peak", ["bf16", "int8"])
def test_roofline_terms_equal_repro(flops, hbm, coll, peak):
    want = jcost.roofline_terms(flops, hbm, coll, peak=getattr(jcost.TPU_V5E, f"peak_{peak}_flops"))
    p = _V5E.peak_bf16_flops if peak == "bf16" else _V5E.peak_int8_ops
    got = cost.roofline_terms(flops, hbm, coll, hw=_V5E, peak=p)
    assert got == {"t_ops_s": want["t_comp_s"], "t_mem_s": want["t_mem_s"], "t_coll_s": want["t_coll_s"]}


@pytest.mark.parametrize("model_flops,step_s", [(1.698e16, 2.5), (6.0e14, 0.0), (1.0, 1e-3)])
def test_roofline_fraction_equals_repro(model_flops, step_s):
    assert cost.roofline_fraction(model_flops, step_s, hw=_V5E) == jcost.roofline_fraction(model_flops, step_s)
    want = model_flops / step_s / (256 * 989e12) if step_s else 0.0
    assert cost.roofline_fraction(model_flops, step_s) == want


def test_h100_figures_and_two_argument_calls():
    h = cost.H100_SXM
    assert (h.peak_bf16_flops, h.link_bw, h.chips) == (989e12, 450e9, 256)
    ops_, nbytes = 2 * 512 * 2048 * 6144, 2048 * 6144 + 512 * 2048 + 512 * 6144
    t = cost.roofline_terms(ops_, nbytes)
    assert t == {"t_ops_s": ops_ / 1979e12, "t_mem_s": nbytes / 3.35e12, "t_coll_s": 0.0}
    assert cost.roofline_terms(ops_, nbytes, 9e9)["t_coll_s"] == 9e9 / 450e9


# ---------------------------------------------------------------------------
# kernels/ops.py::quantized_conv2d, the unplanned conv entry
# ---------------------------------------------------------------------------

def _repro_conv(x, w, b, qs, qsh, stride, pads, out, relu, two_mul):
    return np.asarray(jops.quantized_conv2d(
        jnp.asarray(x), jnp.asarray(w), jnp.asarray(b), jnp.asarray(qs), jnp.asarray(qsh),
        strides=(stride, stride), pads=pads, out_dtype=getattr(jnp, out), relu=relu, two_mul=two_mul))


def _port_conv(x, w, b, qs, qsh, stride, pads, out, relu, two_mul):
    before = launch_counts()
    got = ops.quantized_conv2d(torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(b), qs, qsh,
                               strides=(stride, stride), pads=pads, out_dtype=getattr(torch, out),
                               relu=relu, two_mul=two_mul)
    assert launch_counts() == before  # CPU tensors: the kernel's plain version
    return got.numpy()


@pytest.mark.parametrize("k,stride,pads,c,m,per_channel,relu,two_mul,out", CONV_CASES)
def test_quantized_conv2d_matches_repro_int8(k, stride, pads, c, m, per_channel, relu, two_mul, out):
    rng = np.random.default_rng(k * 100 + c * 10 + m + 1)
    x = rng.integers(-128, 128, (2, c, 11, 9)).astype(np.int8)
    w, b, qs, qsh = _conv_operands(rng, m, c, k, per_channel)
    args = (x, w, b, qs, qsh, stride, pads, out, relu, two_mul)
    np.testing.assert_array_equal(_port_conv(*args), _repro_conv(*args))


@pytest.mark.parametrize("k,stride,per_channel", [(1, 1, False), (3, 1, True), (3, 2, True), (5, 2, False)])
def test_quantized_conv2d_matches_repro_unpadded_uint8(k, stride, per_channel):
    rng = np.random.default_rng(7 * k + stride)
    x = rng.integers(0, 256, (2, 3, 10, 9)).astype(np.uint8)
    w, b, qs, qsh = _conv_operands(rng, 6, 3, k, per_channel)
    args = (x, w, b, qs, qsh, stride, (0, 0, 0, 0), "int8", True, True)
    np.testing.assert_array_equal(_port_conv(*args), _repro_conv(*args))


@pytest.mark.parametrize("pads", [(1, 1, 1, 1), (2, 0, 1, 2)])
def test_quantized_conv2d_padded_uint8_matches_reference_runtime(pads):
    rng = np.random.default_rng(sum(pads) + 40)
    x = rng.integers(0, 256, (2, 3, 6, 5)).astype(np.uint8)
    w, b, _, _ = _conv_operands(rng, 4, 3, 3, per_channel=True)
    rescale = jquant.decompose_multipliers(rng.uniform(1e-5, 1e-4, (4,)))
    qs, qsh = rescale.quant_scale.astype(np.float32), rescale.quant_shift
    gb = GraphBuilder("conv_u8")
    gb.add_input("x", "uint8", (None, 3, 6, 5))
    y = conv_layer(gb, "x", w, b, rescale, "c0", pads=pads, two_mul=True)
    oh, ow = ops.conv_out_hw(6, 5, 3, 3, (1, 1), pads)
    gb.add_output(y, "int8", (None, 4, oh, ow))
    want = next(iter(ReferenceRuntime(gb.build(opset=17)).run({"x": x}).values()))
    np.testing.assert_array_equal(_port_conv(x, w, b, qs, qsh, 1, pads, "int8", False, True), want)
