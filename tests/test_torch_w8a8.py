"""The port's W8A8 layer (``repro_torch.core.convert``, ``core.qlayers`` and
``kernels.ops.quantized_matmul``) against the JAX package's, on the CPU.

* ``convert_params_w8a8`` on ``repro``'s float32 parameters of every arch:
  the same tree, ``q8`` equal bit for bit, ``s`` equal; the manifest equal
  as a dict, entry order included.
* ``layers.linear`` and the MoE expert einsum on W8A8 weights, given equal
  float inputs: tolerance 0 (the same codes, an exact int8 × int8
  contraction, the same float32 rescale).
* The ``w8a8/int8-kv`` posture of every arch at ``reduced()``: prefill and 3
  decode steps, held as ``tests/test_torch_models.py`` holds the others
  (its helpers; scales to rtol 1e-6), but logits and float32 states within
  1e-3 · max(1, max |ref|) and cache entries off by one step in at most
  1 % of entries: an activation that lands within float32 rounding of a
  code boundary takes neighbouring codes in the two packages, and one such
  code moved seamless's prefill logits by 1.7e-4 · max |ref| and 74 of its
  40,960 int8 KV codes by one (every other step of every arch: logits
  ≤ 1e-6 · max |ref|).
* ``QuantizedLinear`` and ``dynamic_quantize``: tolerance 0.  The ``ref``
  backend equals ``repro``'s ``ref`` bit for bit, and the ``cuda`` backend,
  which on CPU tensors runs the qmatmul wrapper's plain version over the
  padded template layout, equals both.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCH_IDS, get_config
from repro.core.convert import convert_params_w8a8 as jconvert
from repro.core.convert import export_arch_quant_manifest as jmanifest
from repro.core.qlayers import dynamic_quantize as jdynamic_quantize
from repro.core.qlayers import prepare_quantized_linear as jprepare
from repro_torch.core.convert import W8A8_NAMES, convert_params_w8a8, export_arch_quant_manifest
from repro_torch.core.qlayers import dynamic_quantize, prepare_quantized_linear
from repro_torch.kernels.ops import quantized_matmul
from repro_torch.models import model as TM
from test_torch_models import (
    Run, assert_caches_close, assert_logits_close, dtype_name, flat, np_tree, posture_cfg,
    repro_params,
)


@pytest.fixture(scope="module")
def converted():
    memo = {}

    def get(arch):
        if arch not in memo:
            cfg = posture_cfg(arch, "int8")
            jp = repro_params(jax.random.PRNGKey(0), cfg)
            memo[arch] = (cfg, jp, jconvert(jp))
        return memo[arch]

    return get


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_conversion_matches_repro(converted, arch):
    _, jp, jq = converted(arch)
    got = convert_params_w8a8(TM.params_from_numpy(np_tree(jp), device="cpu"))
    g, w = dict(flat(got)), dict(flat(np_tree(jq)))
    assert g.keys() == w.keys()
    assert any(path[-1] == "q8" for path in w)
    for path, want in w.items():
        assert dtype_name(g[path]) == want.dtype.name, path
        np.testing.assert_array_equal(g[path].numpy(), want, err_msg=str(path))
    assert export_arch_quant_manifest(got) == jmanifest(jq)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_w8a8_int8_kv_posture(converted, arch):
    cfg, _, jq = converted(arch)
    run = Run(cfg, jq)
    for what, got, want, tcache, jcache in run.steps:
        assert_logits_close(got, want, f"{arch} w8a8 {what}", rel=1e-3)
        assert_caches_close(tcache, jcache, f"{arch} w8a8 {what}", rel=1e-3, flips=1e-2)


def test_w8a8_linear_and_experts_exact_on_equal_inputs(converted):
    """The W8A8 kernels of the zoo, on the same float input in both
    packages: bit for bit."""
    from repro.models.layers import linear as jlinear
    from repro.models.moe import _expert_einsum as jexpert
    from repro_torch.models.layers import linear
    from repro_torch.models.moe import _expert_einsum

    rng = np.random.default_rng(6)
    _, _, jq = converted("qwen3_1_7b")
    w = jax.tree.map(lambda a: a[0], jq["layers"]["mlp"]["w_up"])
    x = rng.normal(size=(2, 5, w["q8"].shape[0])).astype(np.float32)
    got = linear(torch.from_numpy(x), TM.params_from_numpy(np_tree(w), device="cpu"))
    np.testing.assert_array_equal(got.numpy(), np.asarray(jlinear(jnp.asarray(x), w)))
    _, _, jq = converted("mixtral_8x22b")
    we = jax.tree.map(lambda a: a[0], jq["layers"]["moe"]["w_gate"])
    buf = rng.normal(size=(1,) + (we["q8"].shape[0], 8, we["q8"].shape[1])).astype(np.float32)
    got = _expert_einsum(torch.from_numpy(buf), TM.params_from_numpy(np_tree(we), device="cpu"))
    np.testing.assert_array_equal(got.numpy(), np.asarray(jexpert(jnp.asarray(buf), we)))


def test_routers_norms_and_embeddings_stay_float():
    cfg = get_config("qwen2_moe_a2_7b", reduced=True)
    params = convert_params_w8a8(TM.init_params(torch.Generator().manual_seed(0), cfg, device="cpu"))
    for path, leaf in flat(params):
        if "router" in path or "ln1" in path or path[-1] == "table":
            assert leaf.dtype != torch.int8, path
        if path[-1] == "q8":
            assert path[-2] in W8A8_NAMES


def _linear_case(seed, k, n, per_channel):
    rng = np.random.default_rng(seed)
    w = rng.normal(scale=0.05, size=(k, n)).astype(np.float32)
    b = rng.normal(scale=0.1, size=(n,)).astype(np.float32)
    return w, b, dict(scale_x=0.02, scale_y=0.05, per_channel=per_channel)


@pytest.mark.parametrize("x_dtype", ["int8", "uint8"])
@pytest.mark.parametrize("m,k,n,per_channel", [(4, 96, 80, True), (77, 64, 130, True),
                                                (5, 200, 64, False)])
def test_quantized_linear_matches_repro_ref(m, k, n, per_channel, x_dtype):
    w, b, kw = _linear_case(m + k, k, n, per_channel)
    jql = jprepare(w, b, **kw)
    ql = prepare_quantized_linear(w, b, **kw, device="cpu")
    np.testing.assert_array_equal(ql.weight_q.numpy(), np.asarray(jql.weight_q))
    np.testing.assert_array_equal(ql.bias_q.numpy(), np.asarray(jql.bias_q))
    np.testing.assert_array_equal(ql.quant_scale.numpy(), np.asarray(jql.quant_scale))
    np.testing.assert_array_equal(ql.quant_shift.numpy(), np.asarray(jql.quant_shift))
    lo, hi = (-128, 128) if x_dtype == "int8" else (0, 256)
    x = np.random.default_rng(m).integers(lo, hi, (2, m, k)).astype(x_dtype)
    want = np.asarray(jql(jnp.asarray(x), backend="ref"))
    got = ql(torch.from_numpy(x), backend="ref")
    assert got.dtype == torch.int8 and got.shape == (2, m, n)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(ql(torch.from_numpy(x), backend="cuda").numpy(), want)


def test_quantized_matmul_scalar_rescale_and_relu():
    rng = np.random.default_rng(9)
    x = torch.from_numpy(rng.integers(-128, 128, (3, 70)).astype(np.int8))
    w = torch.from_numpy(rng.integers(-128, 128, (70, 33)).astype(np.int8))
    out = {b: quantized_matmul(x, w, None, 3.0, 2.0**-12, relu=True, out_dtype=torch.uint8, backend=b)
           for b in ("ref", "cuda")}
    np.testing.assert_array_equal(out["cuda"].numpy(), out["ref"].numpy())
    acc = x.numpy().astype(np.int64) @ w.numpy().astype(np.int64)
    want = np.clip(np.rint(np.maximum(acc.astype(np.float32) * np.float32(3.0) * np.float32(2.0**-12), 0)),
                   0, 255).astype(np.uint8)
    np.testing.assert_array_equal(out["ref"].numpy(), want)


def test_dynamic_quantize_matches_repro():
    x = np.random.default_rng(4).normal(scale=3.0, size=(5, 33)).astype(np.float32)
    q, s = dynamic_quantize(torch.from_numpy(x))
    jq, js = jdynamic_quantize(jnp.asarray(x))
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    assert float(s) == float(js)


def test_int8_kv_halves_cache_bytes():
    """The paper's scheme on the cache, as the port lays it out: int8 codes
    plus per-(batch, head) scales against bf16 entries."""
    cfg = dataclasses.replace(get_config("qwen3_1_7b", reduced=True), kv_cache_dtype="int8")
    nbytes = lambda c: sum(t.numel() * t.element_size() for _, t in flat(c))  # noqa: E731
    int8 = nbytes(TM.init_cache(cfg, 2, 64, device="cpu"))
    bf16 = nbytes(TM.init_cache(dataclasses.replace(cfg, kv_cache_dtype="bf16"), 2, 64, device="cpu"))
    assert bf16 / int8 > 1.9
