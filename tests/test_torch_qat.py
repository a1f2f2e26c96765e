"""The port's QAT fake-quant (``repro_torch.core.qat``) against ``repro.core.qat``
on the CPU.

Forward values of all four functions are compared bit for bit
(``assert_array_equal``) on inputs that hold exact rounding ties (x / s at
k + 0.5) and values on and beyond the clip edges (x / s at -128, 127, ±200),
per tensor, per channel (``axis``) and on stacked (L, K, N) weights.
``qat_matmul``'s forward is bit for bit on dyadic inputs whose scales are
powers of two (every product and partial sum is exact in float32, so the
two matmuls' summation orders agree); on random inputs it is held within
1e-6 · max |out| (float32 sums in other orders).

Gradients (the straight-through estimator) are equal to ``jax.grad``'s bit
for bit for ``fake_quant``, ``fake_quant_weight_per_channel`` and
``fake_quant_activation`` (each is the upstream gradient times an exact 0/1
gate); ``qat_matmul``'s go through a matmul and are held within 1e-6 · max
|grad| (measured: 0 on these inputs).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import qat as JQ
from repro_torch.core import qat as TQ

SCALE = np.float32(0.037)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Run this module's eager steps on one intra-op thread: the suite runs
    in parallel workers, and the port's small steps on PyTorch's full thread
    pool crawl when the workers oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _ties_and_edges(shape, rng, s=SCALE):
    """x / s at exact half-integers (ties), on the clip edges and beyond."""
    k = rng.integers(-130, 130, size=shape).astype(np.float32)
    x = (k + 0.5) * s
    flat = x.reshape(-1)
    edges = np.array([-128, 127, -200, 200, 0, 127.5, -128.5, 126.5], np.float32) * s
    flat[: edges.size] = edges
    return x.astype(np.float32)


def _eq(got, want):
    np.testing.assert_array_equal(got.detach().numpy(), np.asarray(want))


def _grad_pair(jfn, tfn, x, up):
    gj = jax.grad(lambda a: jnp.sum(jfn(a) * up))(jnp.asarray(x))
    xt = torch.from_numpy(x.copy()).requires_grad_()
    (tfn(xt) * torch.from_numpy(up)).sum().backward()
    return xt.grad, gj


@pytest.mark.parametrize("scale", [SCALE, np.float32(1.0), np.float32(3e-3)])
def test_fake_quant_forward_and_grad_bit_exact(scale):
    rng = np.random.default_rng(0)
    x = _ties_and_edges((8, 33), rng, scale)
    _eq(TQ.fake_quant(torch.from_numpy(x), float(scale)), JQ.fake_quant(jnp.asarray(x), float(scale)))
    up = rng.normal(size=x.shape).astype(np.float32)
    got, want = _grad_pair(lambda a: JQ.fake_quant(a, float(scale)),
                           lambda a: TQ.fake_quant(a, float(scale)), x, up)
    _eq(got, want)
    # the gate: zero gradient outside [qmin·s, qmax·s]
    assert float(np.abs(np.asarray(want)).sum()) > 0 and (np.asarray(want) == 0).any()


@pytest.mark.parametrize("qrange", [(-128, 127), (0, 255), (-8, 7)])
def test_fake_quant_per_channel_axis_and_ranges(qrange):
    rng = np.random.default_rng(1)
    s = rng.uniform(0.01, 0.1, size=(6,)).astype(np.float32)
    x = (rng.integers(-300, 300, size=(4, 6, 5)) + 0.5).astype(np.float32) * s[None, :, None]
    qmin, qmax = qrange
    got = TQ.fake_quant(torch.from_numpy(x), torch.from_numpy(s), qmin=qmin, qmax=qmax, axis=1)
    want = JQ.fake_quant(jnp.asarray(x), jnp.asarray(s), qmin=qmin, qmax=qmax, axis=1)
    _eq(got, want)
    up = rng.normal(size=x.shape).astype(np.float32)
    g, gj = _grad_pair(lambda a: JQ.fake_quant(a, jnp.asarray(s), qmin=qmin, qmax=qmax, axis=1),
                       lambda a: TQ.fake_quant(a, torch.from_numpy(s), qmin=qmin, qmax=qmax, axis=1),
                       x, up)
    _eq(g, gj)


@pytest.mark.parametrize("shape", [(64, 48), (3, 32, 24), (2, 2, 16, 8)])
def test_weight_per_channel_forward_and_grad_bit_exact(shape):
    rng = np.random.default_rng(2)
    w = rng.normal(scale=0.05, size=shape).astype(np.float32)
    # an exact tie of each column: absmax / 127 · (k + 0.5) for the channel's scale
    s = np.maximum(np.abs(w).max(axis=tuple(range(w.ndim - 1)), keepdims=True) / np.float32(127),
                   np.float32(1e-12)).astype(np.float32)
    w.reshape(-1, shape[-1])[1] = (np.float32(17.5) * s.reshape(-1)).astype(np.float32)
    _eq(TQ.fake_quant_weight_per_channel(torch.from_numpy(w)),
        JQ.fake_quant_weight_per_channel(jnp.asarray(w)))
    _eq(TQ.fake_quant_weight_per_channel(torch.from_numpy(w), axis=0),
        JQ.fake_quant_weight_per_channel(jnp.asarray(w), axis=0))
    up = rng.normal(size=shape).astype(np.float32)
    got, want = _grad_pair(JQ.fake_quant_weight_per_channel, TQ.fake_quant_weight_per_channel, w, up)
    _eq(got, want)  # STE: the identity
    _eq(got, up)


def test_weight_codes_are_what_fake_quant_dequantizes():
    w = np.random.default_rng(3).normal(size=(3, 16, 8)).astype(np.float32)
    q, s = TQ.weight_codes_per_channel(torch.from_numpy(w))
    assert q.shape == w.shape and s.shape == (1, 1, 8)
    assert float(q.min()) >= -128 and float(q.max()) <= 127 and torch.equal(q, torch.round(q))
    fq = TQ.fake_quant_weight_per_channel(torch.from_numpy(w))
    np.testing.assert_array_equal(fq.numpy(), (torch.from_numpy(w) + (q * s - torch.from_numpy(w))).numpy())


def test_weight_per_channel_bfloat16():
    w = np.random.default_rng(4).normal(size=(32, 16)).astype(np.float32)
    got = TQ.fake_quant_weight_per_channel(torch.from_numpy(w).to(torch.bfloat16))
    want = JQ.fake_quant_weight_per_channel(jnp.asarray(w, jnp.bfloat16))
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.float().numpy(), np.asarray(want.astype(jnp.float32)))


def test_activation_forward_and_grad_bit_exact():
    rng = np.random.default_rng(5)
    x = _ties_and_edges((16, 40), rng)
    x[0, 0] = np.float32(127 * 0.0625)  # absmax: scale 1/16, every other value a tie or a code
    x = np.clip(x, -np.float32(127 * 0.0625), np.float32(127 * 0.0625))
    _eq(TQ.fake_quant_activation(torch.from_numpy(x)), JQ.fake_quant_activation(jnp.asarray(x)))
    y = rng.normal(scale=2.0, size=(7, 9)).astype(np.float32)
    _eq(TQ.fake_quant_activation(torch.from_numpy(y)), JQ.fake_quant_activation(jnp.asarray(y)))
    up = rng.normal(size=x.shape).astype(np.float32)
    got, want = _grad_pair(JQ.fake_quant_activation, TQ.fake_quant_activation, x, up)
    _eq(got, want)


def _dyadic(rng, shape, absmax_code, exp):
    """Values q · 2^exp (q integer, |q| ≤ absmax_code), one per tensor (or
    column) at ±absmax_code, so the fake-quant scale is exactly 2^exp."""
    q = rng.integers(-absmax_code, absmax_code + 1, size=shape).astype(np.float32)
    return q * np.float32(2.0**exp)


def test_qat_matmul_forward_bit_exact_on_dyadic_inputs():
    rng = np.random.default_rng(6)
    x = _dyadic(rng, (9, 64), 127, -4)
    x[0, 0] = 127 * 2.0**-4
    w = _dyadic(rng, (64, 24), 127, -5)
    w[0, :] = 127 * 2.0**-5  # every column's absmax: scale 2^-5 per channel
    _eq(TQ.qat_matmul(torch.from_numpy(x), torch.from_numpy(w)), JQ.qat_matmul(jnp.asarray(x), jnp.asarray(w)))


def test_qat_matmul_random_and_grads_within_bound():
    rng = np.random.default_rng(7)
    x = rng.normal(size=(12, 48)).astype(np.float32)
    w = rng.normal(scale=0.1, size=(48, 20)).astype(np.float32)
    want = np.asarray(JQ.qat_matmul(jnp.asarray(x), jnp.asarray(w)))
    got = TQ.qat_matmul(torch.from_numpy(x), torch.from_numpy(w)).numpy()
    assert np.abs(got - want).max() <= 1e-6 * np.abs(want).max()
    up = rng.normal(size=want.shape).astype(np.float32)
    gx, gw = jax.grad(lambda a, b: jnp.sum(JQ.qat_matmul(a, b) * up), argnums=(0, 1))(jnp.asarray(x), jnp.asarray(w))
    xt, wt = (torch.from_numpy(a.copy()).requires_grad_() for a in (x, w))
    (TQ.qat_matmul(xt, wt) * torch.from_numpy(up)).sum().backward()
    for g, gj in ((xt.grad, gx), (wt.grad, gw)):
        gj = np.asarray(gj)
        assert np.abs(g.numpy() - gj).max() <= 1e-6 * np.abs(gj).max()
