"""The port's token path against the JAX package's, on the CPU.

Both packages build the codified transformer block from the same weights
(``repro``'s ``make_token_params(seed=3)``, carried across as a plain numpy
dict by ``params_from_numpy``) at ``TokenPathConfig()``'s defaults — mixed w4
(qkv, down) / w8 (o, up) projections — with ``s_granularity=8``.  Over the
(batch × prompt-len) grid of ``tests/test_token_path.py`` the port's
prefill must equal ``repro``'s jnp mirror (``prefill_jax``) and ``repro``'s
compiled ``ref`` backend, and ``decode_step`` must equal ``decode``, on both
port backends (on the CPU the ``cuda`` backend runs the planned path through
the kernels' plain versions).  Decode steps and the serving engine are in
``tests/test_torch_serving.py``, which reuses the helpers here.

Tolerance: 0.  Every path is integer arithmetic or an IEEE-exact float32
elementwise step in the codified order, so the results are bit-identical.
"""
import jax
import numpy as np
import pytest
import torch

from repro.serving.token_path import CompiledTokenPath as JTokenPath
from repro.serving.token_path import TokenPathConfig as JConfig
from repro.serving.token_path import build_decode_model as jbuild_decode
from repro.serving.token_path import build_prefill_model as jbuild_prefill
from repro.serving.token_path import make_token_params, prefill_jax
from repro_torch.serving.token_path import (
    CompiledTokenPath,
    TokenPathConfig,
    build_decode_model,
    build_prefill_model,
    params_from_numpy,
)

JCFG = JConfig()
JPARAMS = make_token_params(JCFG, seed=3)
CFG = TokenPathConfig()
BACKENDS = ("ref", "cuda")


def flatten_params(p) -> dict:
    """Token-path parameters (either package's) as a plain dict of numpy
    arrays and scalars — the form ``params_from_numpy`` reads."""

    def linear(q):
        r = q.rescale
        return dict(
            weight_q=q.weight_q, bias_q=q.bias_q, scale_x=q.scale_x, scale_w=q.scale_w,
            scale_y=q.scale_y, quant_scale=r.quant_scale, shift=r.shift,
            multiplier=r.multiplier, bits=q.bits, in_dtype=q.in_dtype, out_dtype=q.out_dtype,
        )

    return dict(
        embedding=p.embedding, lm_head=p.lm_head, lm_scale=p.lm_scale,
        layers=[{name: linear(q) for name, q in layer.items()} for layer in p.layers],
    )


PARAMS = params_from_numpy(flatten_params(JPARAMS))

#: ``repro``'s jnp mirrors, traced once per shape instead of dispatched op by op
prefill_mirror = jax.jit(lambda toks, mask: prefill_jax(JCFG, JPARAMS, toks, mask))


def _causal(n, s):
    return np.broadcast_to(np.tril(np.ones((s, s), np.float32)), (n, s, s)).copy()


def _tokens(rng, n, s):
    return rng.integers(1, CFG.vocab, (n, s)).astype(np.int32)


def _states(tp, cache):
    """[(k, v)] per layer, as numpy (from tensors or arrays)."""
    host = lambda x: x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)  # noqa: E731
    return [
        tuple(host(cache[tp.state_specs[2 * l + i].input]) for i in (0, 1))
        for l in range(CFG.n_layers)
    ]


@pytest.fixture(scope="module")
def tps():
    return {b: CompiledTokenPath(CFG, PARAMS, backend=b, device="cpu", s_granularity=8)
            for b in BACKENDS}


@pytest.fixture(scope="module")
def jtp():
    return JTokenPath(JCFG, JPARAMS, backend="ref", s_granularity=8)


def test_builders_emit_repro_json():
    assert build_prefill_model(CFG, PARAMS).to_json() == jbuild_prefill(JCFG, JPARAMS).to_json()
    assert build_decode_model(CFG, PARAMS).to_json() == jbuild_decode(JCFG, JPARAMS).to_json()


def test_params_from_numpy_round_trips():
    want = flatten_params(JPARAMS)
    got = flatten_params(params_from_numpy(want))
    assert got.keys() == want.keys() and len(got["layers"]) == len(want["layers"])
    for k in ("embedding", "lm_head", "lm_scale"):
        np.testing.assert_array_equal(got[k], want[k])
    for gl, wl in zip(got["layers"], want["layers"]):
        assert gl.keys() == wl.keys()
        for proj in wl:
            for field, v in wl[proj].items():
                g = gl[proj][field]
                assert type(g) is type(v) or isinstance(v, np.ndarray), (proj, field)
                np.testing.assert_array_equal(g, v)


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("n,plen", [(1, 3), (2, 7), (3, 8), (2, 12)])
def test_prefill_grid(tps, jtp, backend, n, plen):
    rng = np.random.default_rng(100 * n + plen)
    toks = _tokens(rng, n, plen)
    mask = _causal(n, plen)
    logits, cache = tps[backend].prefill(toks, mask)
    jl, jcaches = prefill_mirror(toks, mask)
    cl, ccache = jtp.prefill(toks, mask)
    np.testing.assert_array_equal(logits.numpy(), np.asarray(jl))
    np.testing.assert_array_equal(logits.numpy(), cl)
    for (kj, vj), (kc, vc), (kr, vr) in zip(jcaches, _states(tps[backend], cache), _states(jtp, ccache)):
        np.testing.assert_array_equal(kc, np.asarray(kj))
        np.testing.assert_array_equal(vc, np.asarray(vj))
        np.testing.assert_array_equal(kc, kr)
        np.testing.assert_array_equal(vc, vr)


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("n,s", [(2, 16), (3, 12)])  # bucket-aligned, and padded
def test_decode_step_equals_decode(tps, backend, n, s):
    tp = tps[backend]
    rng = np.random.default_rng(n * s)
    cache = {k: torch.from_numpy(rng.integers(-128, 128, (n, s, CFG.d_model)).astype(np.int8))
             for k in tp.init_cache(n, s)}
    pos = rng.integers(0, s, (n,))
    tok = _tokens(rng, n, 1)
    onehot = np.zeros((n, s, 1), np.int8)
    onehot[np.arange(n), pos, 0] = 1
    mask = (np.arange(s)[None, None, :] <= pos[:, None, None]).astype(np.float32)
    want_l, want_c = tp.decode(tok, onehot, mask, dict(cache))
    got_l, got_c = tp.decode_step(tok, pos, dict(cache))
    np.testing.assert_array_equal(got_l.numpy(), want_l[:, 0].numpy())
    for k in want_c:
        np.testing.assert_array_equal(got_c[k].numpy(), want_c[k].numpy())
