"""The port's model zoo (``repro_torch.models``) against the JAX package's, on
the CPU.

Every architecture of ``configs.ARCH_IDS`` at ``reduced()``: ``repro``'s
float32 parameters (``init_params(PRNGKey(0))``) carried across with
``params_from_numpy``, the same batch (B = 2, S = 16, from a numpy seed,
vision and encoder stubs as ``tests/test_w8a8.py`` feeds them), compute
dtype float32, chunks of 8.  The port's prefill is held against ``repro``'s,
and so is each of 3 greedy decode steps, each fed ``repro``'s cache from the
step before, so every step is compared on equal inputs.  The W8A8 posture
is in ``tests/test_torch_w8a8.py`` and the engine in
``tests/test_torch_zoo_serving.py``; both reuse the helpers here.

Tolerances (the two packages sum float32 products in different orders, so
results agree to rounding, not bit for bit):

* logits: |Δ| ≤ 1e-4 · max(1, max |ref|) (measured: ≤ 1e-6 · max |ref|);
* float32 recurrent states (rwkv6 ``wkv``, mamba2 ``ssd``): the same bound;
* bf16 caches, compared as float32: at least 99.9 % of all bf16 entries
  equal, and each other entry one bf16 step off, ≤ 2⁻⁷ · max |ref| of its
  tensor — float32 values a few ulps apart can round to neighbouring bf16
  codes (measured: at most 0.088 % of entries, in zamba2's prefill);
* int8 KV codes: |Δ| ≤ 1 in at most 0.1 % of all int8 entries (measured:
  ≤ 0.01 %);
* KV scales: rtol 1e-6.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCH_IDS, get_config
from repro.models import model as JM
from repro.models import moe as Jmoe
from repro_torch.configs import get_config as port_get_config
from repro_torch.models import model as TM
from repro_torch.models import moe as Tmoe

B, S, STEPS = 2, 16, 3
CHUNK = 8
POSTURES = ("bf16", "int8")  # the KV cache dtype; weights as initialised


def batch_np(cfg, rng) -> dict:
    tok = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    batch = {"tokens": tok}
    if cfg.frontend == "vision":
        batch["tokens"] = tok[:, : S - cfg.frontend_tokens]
        batch["patch_embeds"] = rng.normal(size=(B, cfg.frontend_tokens, cfg.d_model)).astype(np.float32)
    if cfg.family == "encdec":
        batch["src_embeds"] = rng.normal(size=(B, S, cfg.d_model)).astype(np.float32)
    return batch


def to_np(a) -> np.ndarray:
    """A leaf of either package as numpy; bf16 as float32 (exact)."""
    if isinstance(a, torch.Tensor):
        return a.float().numpy() if a.dtype == torch.bfloat16 else a.numpy()
    a = np.asarray(a)
    return a.astype(np.float32) if a.dtype.name == "bfloat16" else a


def flat(tree, path=()):
    """(path, leaf) in sorted-key order over dict / tuple / list trees."""
    if tree is None:
        return
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from flat(tree[k], path + (k,))
    elif isinstance(tree, (tuple, list)):
        for i, v in enumerate(tree):
            yield from flat(v, path + (i,))
    else:
        yield path, tree


def dtype_name(a) -> str:
    return str(a.dtype).replace("torch.", "")


def np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def assert_logits_close(got, want, what="", rel=1e-4):
    want = np.asarray(want)
    tol = rel * max(1.0, float(np.abs(want).max()))
    err = float(np.abs(to_np(got) - want).max())
    assert err <= tol, f"{what}: max |Δ| {err:.3g} > {tol:.3g}"


def assert_caches_close(got, want, what="", rel=1e-4, flips=1e-3):
    g, w = dict(flat(got)), dict(flat(np_tree(want)))
    assert g.keys() == w.keys(), (what, sorted(g), sorted(w))
    counts = {"bf16": [0, 0], "int8": [0, 0]}
    for path, wl in w.items():
        gl = g[path]
        assert tuple(gl.shape) == wl.shape and dtype_name(gl) == wl.dtype.name, (what, path)
        a, b = to_np(gl), to_np(wl)
        if wl.dtype.name == "bfloat16":
            d = np.abs(a - b)
            assert d.max(initial=0) <= 2.0**-7 * np.abs(b).max(initial=0), (what, path, d.max())
            counts["bf16"][0] += int((d > 0).sum())
            counts["bf16"][1] += d.size
        elif wl.dtype == np.int8:
            d = np.abs(a.astype(np.int32) - b)
            assert d.max(initial=0) <= 1, (what, path, d.max())
            counts["int8"][0] += int((d > 0).sum())
            counts["int8"][1] += d.size
        elif str(path[-1]).endswith("scale"):
            np.testing.assert_allclose(a, b, rtol=1e-6, atol=0, err_msg=f"{what} {path}")
        else:
            assert_logits_close(gl, wl, f"{what} {path}", rel)
    for kind, (bad, total) in counts.items():
        assert bad <= flips * total, f"{what}: {bad} of {total} {kind} entries differ"


class Run:
    """One posture of one arch through both packages: prefill, then STEPS
    greedy decode steps, the port's each fed ``repro``'s cache."""

    def __init__(self, cfg, jparams):
        self.cfg = cfg
        tparams = TM.params_from_numpy(np_tree(jparams), device="cpu")
        batch = batch_np(cfg, np.random.default_rng(1))
        jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
        jcache = JM.init_cache(cfg, B, S + 4, src_len=S)
        self.init = (TM.init_cache(cfg, B, S + 4, src_len=S, device="cpu"), jcache)
        jprefill = jax.jit(lambda p, b, c: JM.prefill(p, b, cfg, c, compute_dtype=jnp.float32,
                                                      q_chunk=CHUNK, kv_chunk=CHUNK))
        jdecode = jax.jit(lambda p, t, pos, c: JM.decode_step(p, t, pos, c, cfg,
                                                              compute_dtype=jnp.float32))
        want, jcache = jprefill(jparams, jbatch, jcache)
        got, tcache = TM.prefill(tparams, batch, cfg, self.init[0], compute_dtype=torch.float32,
                                 q_chunk=CHUNK, kv_chunk=CHUNK)
        self.steps = [("prefill", got, want, tcache, jcache)]
        for step in range(STEPS):
            tok = np.asarray(jnp.argmax(want, -1))[:, None].astype(np.int32)
            pos = np.full((B,), S + step, np.int32)
            fed = TM.cache_from_numpy(np_tree(jcache), device="cpu")
            got, tcache = TM.decode_step(tparams, torch.from_numpy(tok), torch.from_numpy(pos), fed,
                                         cfg, compute_dtype=torch.float32)
            want, jcache = jdecode(jparams, jnp.asarray(tok), jnp.asarray(pos), jcache)
            self.steps.append((f"decode {step}", got, want, tcache, jcache))


def posture_cfg(arch, kv):
    return dataclasses.replace(get_config(arch, reduced=True), kv_cache_dtype=kv)


_init = jax.jit(lambda key, cfg: JM.init_params(key, cfg), static_argnums=1)


def repro_params(key, cfg):
    """``repro``'s f32 masters, as ``tests/test_w8a8.py`` makes them (jitted
    once per architecture: the KV cache dtype does not change them)."""
    return _init(key, dataclasses.replace(cfg, kv_cache_dtype="bf16"))


@pytest.fixture(scope="module")
def runs():
    memo = {}

    def get(arch, kv):
        if (arch, kv) not in memo:
            cfg = posture_cfg(arch, kv)
            memo[arch, kv] = Run(cfg, repro_params(jax.random.PRNGKey(0), cfg))
        return memo[arch, kv]

    return get


@pytest.mark.parametrize("kv", POSTURES)
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_prefill_and_decode_logits(runs, arch, kv):
    for what, got, want, _, _ in runs(arch, kv).steps:
        assert_logits_close(got, want, f"{arch} {kv} {what}")


@pytest.mark.parametrize("kv", POSTURES)
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_caches_written(runs, arch, kv):
    run = runs(arch, kv)
    assert_caches_close(run.init[0], run.init[1], f"{arch} {kv} init_cache")
    for what, _, _, got, want in run.steps:
        assert_caches_close(got, want, f"{arch} {kv} {what}")


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_init_tree_matches_repro(arch):
    """The port's own init: ``repro``'s key paths, shapes and dtypes, and the
    same logical sharding axes for parameters and caches."""
    cfg = get_config(arch, reduced=True)
    want = jax.eval_shape(lambda k: JM.init_params(k, cfg), jax.random.PRNGKey(0))
    got = TM.init_params(torch.Generator().manual_seed(0), port_get_config(arch, reduced=True),
                         device="cpu")
    gw, gg = dict(flat(want)), dict(flat(got))
    assert gg.keys() == gw.keys()
    for path, w in gw.items():
        assert (tuple(gg[path].shape), dtype_name(gg[path])) == (w.shape, w.dtype.name), path
    assert TM.param_logical_axes(got) == JM.param_logical_axes(want)
    jc = jax.eval_shape(lambda: JM.init_cache(cfg, B, S, src_len=S))
    tc = TM.init_cache(cfg, B, S, src_len=S, device="cpu")
    assert TM.cache_logical_axes(tc) == JM.cache_logical_axes(jc)


def test_scan_layers_false_takes_the_same_path():
    """``scan_layers=False`` (``repro`` unrolls the stack) against ``repro``'s
    unrolled run, and bit for bit against the port's scanned one."""
    cfg = dataclasses.replace(get_config("gemma2_2b", reduced=True), scan_layers=False)
    jparams = repro_params(jax.random.PRNGKey(0), cfg)
    run = Run(cfg, jparams)
    for what, got, want, tcache, jcache in run.steps:
        assert_logits_close(got, want, f"unrolled {what}")
        assert_caches_close(tcache, jcache, f"unrolled {what}")
    # the prefill depends on the port alone (each decode step is fed repro's cache)
    scanned = Run(dataclasses.replace(cfg, scan_layers=True), jparams)
    _, a, _, ca, _ = run.steps[0]
    _, b, _, cb, _ = scanned.steps[0]
    np.testing.assert_array_equal(a.numpy(), b.numpy())
    for (path, x), (_, y) in zip(flat(ca), flat(cb)):
        np.testing.assert_array_equal(to_np(x), to_np(y), err_msg=str(path))


def test_swa_ring_prompt_longer_than_window():
    """The mirror of ``tests/test_ring_cache.py::test_prefill_longer_than_
    window_then_decode``: a 24-token prompt into an 8-slot ring.  The port's
    ring prefill and its ring cache match ``repro``'s, and decoding from the
    ring matches the port's own full-length cache under the same window
    mask (``repro``'s test's bound, 2e-4)."""
    cfg = dataclasses.replace(get_config("mixtral_8x22b", reduced=True), window=8)
    jparams = JM.init_params(jax.random.PRNGKey(1), cfg)
    params = TM.params_from_numpy(np_tree(jparams), device="cpu")
    toks = np.random.default_rng(3).integers(0, cfg.vocab_size, (2, 24)).astype(np.int32)
    full_cfg = dataclasses.replace(cfg, attn_type="full")

    jl, jring = JM.prefill(jparams, {"tokens": jnp.asarray(toks)}, cfg, JM.init_cache(cfg, 2, 32),
                           compute_dtype=jnp.float32, q_chunk=8, kv_chunk=8)
    ring = TM.init_cache(cfg, 2, 32, device="cpu")
    assert ring["layers"]["k"].shape[2] == 8
    lr, ring = TM.prefill(params, {"tokens": toks}, cfg, ring, compute_dtype=torch.float32,
                          q_chunk=8, kv_chunk=8)
    assert_logits_close(lr, jl, "ring prefill")
    assert_caches_close(ring, jring, "ring prefill")

    full = TM.init_cache(full_cfg, 2, 32, device="cpu")
    assert full["layers"]["k"].shape[2] == 32
    lf, full = TM.prefill(params, {"tokens": toks}, cfg, full, compute_dtype=torch.float32,
                          q_chunk=8, kv_chunk=8)
    np.testing.assert_allclose(lr.numpy(), lf.numpy(), rtol=1e-5, atol=1e-5)
    tok = torch.argmax(lr, -1)[:, None].to(torch.int32)
    for step in range(6):
        pos = torch.full((2,), 24 + step, dtype=torch.int32)
        lr1, ring = TM.decode_step(params, tok, pos, ring, cfg, compute_dtype=torch.float32)
        lf1, full = TM.decode_step(params, tok, pos, full, cfg, compute_dtype=torch.float32)
        np.testing.assert_allclose(lr1.numpy(), lf1.numpy(), rtol=2e-4, atol=2e-4)
        tok = torch.argmax(lr1, -1)[:, None].to(torch.int32)


def _repro_route(p, xf, cfg):
    """``repro``'s routing, lines 96-108 of ``repro/models/moe.py``, on one
    dispatch group: (gate_idx, slot)."""
    m = cfg.moe
    tl, k, e = xf.shape[1], m.top_k, m.n_experts
    cap = (int(max(1, round(tl * k / e * m.capacity_factor))) + 7) // 8 * 8
    probs = jax.nn.softmax(xf.astype(jnp.float32) @ p["router"], axis=-1)
    _, gate_idx = jax.lax.top_k(probs, k)
    flat_e = gate_idx.reshape(1, tl * k)
    onehot = jax.nn.one_hot(flat_e, e, dtype=jnp.int32)
    pos = ((jnp.cumsum(onehot, axis=1) - 1) * onehot).max(axis=-1)
    slot = jnp.where(pos < cap, flat_e * cap + pos, e * cap)
    return np.asarray(gate_idx), np.asarray(slot)


@pytest.mark.parametrize("arch,tied", [("mixtral_8x22b", False), ("qwen2_moe_a2_7b", False),
                                       ("mixtral_8x22b", True)])
def test_moe_ffn_given_inputs(arch, tied):
    """``moe_ffn`` on one set of inputs: the same experts in the same slot
    order (equal), the same capacity slots (equal) and the same output and
    aux loss (float32 tolerance).  ``tied`` zeroes the router, so every
    expert ties: ``lax.top_k`` takes the lowest indices, and so must the
    port's stable sort; the tokens then overflow into the dead row."""
    cfg = get_config(arch, reduced=True)
    jp = jax.tree.map(lambda a: a[0], JM.init_params(jax.random.PRNGKey(2), cfg)["layers"]["moe"])
    if tied:
        jp = {**jp, "router": jnp.zeros_like(jp["router"])}
    x = np.random.default_rng(5).normal(size=(2, 40, cfg.d_model)).astype(np.float32)
    want_y, want_aux = Jmoe.moe_ffn(jp, jnp.asarray(x), cfg)
    tp = TM.params_from_numpy(np_tree(jp), device="cpu")
    got_y, got_aux = Tmoe.moe_ffn(tp, torch.from_numpy(x), cfg)
    assert_logits_close(got_y, want_y, f"{arch} moe out")
    assert abs(float(got_aux) - float(want_aux)) <= 1e-6 * max(1.0, abs(float(want_aux)))
    want_idx, want_slot = _repro_route(jp, jnp.asarray(x.reshape(1, -1, cfg.d_model)), cfg)
    _, _, got_idx, got_slot, _, _ = Tmoe.route(tp, torch.from_numpy(x.reshape(1, -1, cfg.d_model)), cfg)
    np.testing.assert_array_equal(got_idx.numpy(), want_idx)
    np.testing.assert_array_equal(got_slot.numpy(), want_slot)
    if tied:  # every token on experts 0..k-1, most of them past capacity: the dead row
        assert (want_idx == np.arange(cfg.moe.top_k)).all()
        assert (want_slot == want_slot.max()).sum() > want_slot.size // 2
