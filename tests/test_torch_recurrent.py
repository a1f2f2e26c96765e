"""The recurrent families as ``repro`` runs them, on the CPU.

* The chunked WKV6 (``models/rwkv6.py::_wkv_scan``: rematerialized chunks
  of 128 steps, each in sub-chunks of ``WKV_SUB`` steps in matmul form)
  against ``repro``'s sequential ``_wkv_scan`` (``jax.lax.scan``): the
  outputs, the final state, and the gradients of r, k, v, the log-decay,
  u and the state against ``jax.grad`` (``repro`` takes ``w``; its
  gradient in the log-decay is taken through ``w = exp(lw)``).  Cases:
  S = 128 and 256, S = 100 (sub-chunks of 32, 32, 32 and 4), decode
  (S = 1), decays where float32 ``w`` underflows to 0 for over half the
  entries, decays spread over five orders of magnitude, and log-decays of
  −inf and −3e38 between ordinary ones.  Bound: every
  value within 2e-6 · max(1, max |repro|) (measured ≤ 4e-7; the two sum
  float32 products in other orders); no NaN.  The per-step plain version
  (``wkv_scan_plain``, the oracle of ``chip_smoke.py``) is held to the
  same bound, and a length that is not a multiple of the chunk raises as
  ``repro`` asserts.
* Saved bytes: ``saved_tensors_hooks`` around the recurrence inside one
  layer (``rwkv6_block`` at ``rwkv6_3b``'s ``reduced()`` widths, B = 2,
  S = 256, 8 heads of 32; ``mamba2_block`` at ``zamba2_7b``'s, B = 1,
  S = 512, 16 heads of 32, N = 16, A = −0.05).  Beyond its inputs the recurrence
  saves exactly the state between its two chunks — (B, H, D, D) = 65,536
  bytes for WKV6, (B, H, P, N) = 32,768 bytes for the SSD — where
  without the rematerialization it saves more than 100 times as much.
* Mamba2's forward and gradients with each chunk rematerialized equal the
  same layer without it bit for bit (the arithmetic is unchanged).  The
  layer's A is −0.05: at the initial A = −1 a 256-step chunk's masked
  ``exp`` overflows and the SSD's backward gives NaN, in ``repro`` as in
  the port (ROADMAP §C).
* ``rwkv6_3b``'s ``train_4k`` dry-run cell at a cut shape (2 layers, seq
  256, batch 32 in 2 microbatches; widths full) comes out ``ok`` on the
  single-pod mesh with ``repro``'s argument bytes; the full cells run
  through ``python -m repro_torch.launch.dryrun --arch rwkv6_3b``.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as repro_get_config
from repro.configs.base import ShapeConfig as JShapeConfig
from repro.models.rwkv6 import _wkv_scan as repro_wkv_scan
from repro_torch.configs import get_config
from repro_torch.configs.base import ShapeConfig
from repro_torch.launch import dryrun as D
from repro_torch.models import mamba2, rwkv6
from repro_torch.models import model as TM

import test_torch_dryrun as tdr
from test_torch_dryrun import POD1, repro_argument_bytes

TOL = 2e-6


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _wkv_inputs(seed, s, x_mean=0.0, x_scale=1.0, b=2, h=2, d=16, blow_up=False):
    """r, k, v, the log-decay ``-exp(x)``, u and a state; x ~ N(x_mean,
    x_scale²) sets the decays.  ``blow_up``: at every 9th step from step 3
    the log-decay is −inf (float32 ``exp(x)`` overflows for x > 88.7), and
    at every 13th from step 5 it is −3e38, finite and near the overflow."""
    rng = np.random.default_rng(seed)
    r, k, v = (rng.normal(size=(b, s, h, d)).astype(np.float32) for _ in range(3))
    lw = -np.exp(rng.normal(x_mean, x_scale, size=(b, s, h, d))).astype(np.float32)
    if blow_up:
        lw[:, 3::9] = -np.inf
        lw[:, 5::13] = np.float32(-3e38)
    u = (rng.normal(size=(h, d)) * 0.5).astype(np.float32)
    st = rng.normal(size=(b, h, d, d)).astype(np.float32)
    return [r, k, v, lw, u, st]


def _repro(args, gy, gs):
    """repro's outputs and the gradients of <y, gy> + <state, gs>."""
    def f(r, k, v, lw, u, st):
        return repro_wkv_scan(r, k, v, jnp.exp(lw), u, st)

    def loss(*a):
        y, sn = f(*a)
        return (y * gy).sum() + (sn * gs).sum()

    y, sn = jax.jit(f)(*args)
    grads = jax.jit(jax.grad(loss, argnums=tuple(range(6))))(*args)
    return [np.asarray(y), np.asarray(sn)], [np.asarray(g) for g in grads]


def _port(fn, args, gy, gs):
    ts = [torch.tensor(a, requires_grad=True) for a in args]
    y, sn = fn(*ts)
    grads = torch.autograd.grad((y * torch.from_numpy(gy)).sum() + (sn * torch.from_numpy(gs)).sum(), ts)
    return [y.detach().numpy(), sn.detach().numpy()], [g.numpy() for g in grads]


def _within(got, want, what):
    for i, (g, w) in enumerate(zip(got, want)):
        assert g.shape == w.shape and np.isfinite(g).all(), (what, i)
        err = float(np.abs(g - w).max()) / max(1.0, float(np.abs(w).max()))
        assert err <= TOL, (what, i, err)


WKV_CASES = {
    "s128": dict(s=128),
    "s256": dict(s=256),
    "ragged_sub_chunks": dict(s=100),
    "decode": dict(s=1),
    "w_underflows": dict(s=128, x_mean=5.0),  # exp(-exp(x)) == 0 in float32 for x > 4.64
    "wide_decays": dict(s=256, x_scale=3.0),
    "log_decay_infinite": dict(s=128, blow_up=True),
}


@pytest.mark.parametrize("fn", ["chunked", "plain"])
@pytest.mark.parametrize("case", sorted(WKV_CASES))
def test_wkv_scan_matches_repro(case, fn):
    kw = WKV_CASES[case]
    args = _wkv_inputs(len(case), **kw)
    if case == "w_underflows":
        assert (np.exp(args[3]) == 0).mean() > 0.5
    rng = np.random.default_rng(9)
    gy = rng.normal(size=args[0].shape).astype(np.float32)
    gs = rng.normal(size=args[5].shape).astype(np.float32)
    outs_want, grads_want = _repro(args, gy, gs)
    outs, grads = _port(rwkv6._wkv_scan if fn == "chunked" else rwkv6.wkv_scan_plain, args, gy, gs)
    _within(outs, outs_want, f"{case} outputs")
    _within(grads, grads_want, f"{case} gradients")


def test_wkv_scan_refuses_a_partial_chunk():
    ts = [torch.from_numpy(a) for a in _wkv_inputs(0, 192)]
    for fn in (rwkv6._wkv_scan, rwkv6.wkv_scan_plain):
        with pytest.raises(ValueError, match="multiple of the WKV chunk"):
            fn(*ts)


# ---------------------------------------------------------------------------
# saved bytes: the chunk-boundary states
# ---------------------------------------------------------------------------

def _saved_bytes(monkeypatch, module, name):
    """Wrap ``module.name`` so each call counts the bytes of the storages
    it saves for the backward, beyond those of its own inputs."""
    real, rec = getattr(module, name), []

    def wrapped(*args, **kw):
        held = {a.untyped_storage().data_ptr() for a in args if isinstance(a, torch.Tensor)}
        saved = {}

        def pack(t):
            st = t.untyped_storage()
            if st.data_ptr() not in held:
                saved[st.data_ptr()] = st.nbytes()
            return t

        with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
            out = real(*args, **kw)
        rec.append(sum(saved.values()))
        return out

    monkeypatch.setattr(module, name, wrapped)
    return rec


def _layer(cfg, key, b, s, seed):
    """One layer's params (requiring grad), input and zero state."""
    gen = torch.Generator().manual_seed(seed)
    p = TM.init_params(gen, dataclasses.replace(cfg, n_layers=1), device="cpu")
    p = {k: v[0].requires_grad_() for k, v in p[key].items()}
    x = (torch.randn((b, s, cfg.d_model), generator=gen) * 0.5).requires_grad_()
    return p, x


def _rwkv_layer(b=2, s=256):
    cfg = get_config("rwkv6_3b", reduced=True)
    p, x = _layer(cfg, "layers", b, s, 0)
    state = rwkv6.init_rwkv6_state(b, cfg)
    norms = {"ln1": p["ln1"], "ln2": p["ln2"]}
    return lambda: rwkv6.rwkv6_block(p, x, state, cfg, norms), cfg, (p, x)


def _mamba_layer(b=1, s=512):
    cfg = get_config("zamba2_7b", reduced=True)
    gen = torch.Generator().manual_seed(1)
    p = mamba2.init_mamba2_layer(gen, cfg)
    p["A_log"].fill_(np.log(0.05))  # keeps exp of the in-chunk log-decay differences finite
    p = {k: v.requires_grad_() for k, v in p.items()}
    norm = torch.ones((cfg.d_model,), requires_grad=True)
    x = (torch.randn((b, s, cfg.d_model), generator=gen) * 0.5).requires_grad_()
    state = mamba2.init_mamba2_state(b, cfg)
    return lambda: mamba2.mamba2_block(p, x, state, cfg, norm), cfg, (p, x, norm)


def _no_remat(monkeypatch, module):
    monkeypatch.setattr(module, "remat_chunk", lambda fn, *args: fn(*args))


@pytest.mark.parametrize("remat", [True, False])
def test_rwkv6_layer_saves_the_chunk_boundary_states(monkeypatch, remat):
    b, s = 2, 256
    rec = _saved_bytes(monkeypatch, rwkv6, "_wkv_scan")
    if not remat:
        _no_remat(monkeypatch, rwkv6)
    run, cfg, _ = _rwkv_layer(b, s)
    out, _ = run()
    hd = cfg.ssm.head_dim
    boundary = b * (cfg.d_model // hd) * hd * hd * 4  # one (B, H, D, D) f32 state
    assert boundary == 65_536
    if remat:
        assert rec == [(s // 128 - 1) * boundary]
    else:
        assert rec[0] > 100 * boundary
    out.sum().backward()


@pytest.mark.parametrize("remat", [True, False])
def test_mamba2_layer_saves_the_chunk_boundary_states(monkeypatch, remat):
    b, s = 1, 512
    rec = _saved_bytes(monkeypatch, mamba2, "_ssd_scan")
    if not remat:
        _no_remat(monkeypatch, mamba2)
    run, cfg, _ = _mamba_layer(b, s)
    out, _ = run()
    _, nh, _ = mamba2._dims(cfg)
    boundary = b * nh * cfg.ssm.head_dim * cfg.ssm.d_state * 4  # one (B, H, P, N) f32 state
    assert boundary == 32_768
    if remat:
        assert rec == [(s // 256 - 1) * boundary]
    else:
        assert rec[0] > 100 * boundary
    out.sum().backward()


def test_mamba2_remat_is_bit_equal(monkeypatch):
    def grads():
        run, _, (p, x, norm) = _mamba_layer()
        out, st = run()
        leaves = [x, norm] + [p[k] for k in sorted(p)]
        return out, st["ssd"], torch.autograd.grad((out * out).sum(), leaves)

    out, st, g = grads()
    _no_remat(monkeypatch, mamba2)
    out0, st0, g0 = grads()
    assert torch.equal(out, out0) and torch.equal(st, st0)
    assert all(torch.equal(a, b) for a, b in zip(g, g0))


# ---------------------------------------------------------------------------
# rwkv6_3b's train_4k dry-run cell, cut
# ---------------------------------------------------------------------------

def test_rwkv6_train_cell_at_a_cut_shape(monkeypatch):
    """Full widths (40 heads of 64 over the 16-way model axis), 2 layers,
    seq 256, batch 32 in 2 microbatches: the chunked scan, its remat inside
    the layer's, and their backward on meta DTensors."""
    def cut(get, shape_cls):
        return (lambda arch, reduced=False: dataclasses.replace(get(arch), n_layers=2),
                {"train_4k": shape_cls("train_4k", "train", 256, 32, microbatches=2)})

    port_get, port_shapes = cut(get_config, ShapeConfig)
    monkeypatch.setattr(D, "get_config", port_get)
    monkeypatch.setattr(D, "SHAPE_BY_NAME", port_shapes)
    repro_get, repro_shapes = cut(repro_get_config, JShapeConfig)
    monkeypatch.setattr(tdr, "repro_get_config", repro_get)
    monkeypatch.setattr(tdr, "SHAPE_BY_NAME", repro_shapes)
    r = D.dryrun_cell("rwkv6_3b", "train_4k", multi_pod=False, q_chunk=256, kv_chunk=256)
    assert r["status"] == "ok", r.get("error", "") + r.get("trace", "")
    assert r["memory"]["argument_bytes"] == repro_argument_bytes("rwkv6_3b", "train_4k", POD1)
    assert r["memory"]["temp_bytes"] > 0 and r["collectives"]["count"] > 0
    assert 0 < r["cost"]["flops"] <= r["cost"]["global_flops"]
