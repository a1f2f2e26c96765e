"""The port's decode loop and serving engine against the JAX package's, on
the CPU.

Same weights and sizes as ``tests/test_torch_token_path.py`` (whose helpers
this file reuses): ``repro``'s ``make_token_params(seed=3)`` at
``TokenPathConfig()``'s defaults, ``s_granularity=8``.  Decode steps after a
prefill must equal ``repro``'s jnp mirror ``decode_jax`` and ``repro``'s
compiled ``ref`` backend, and greedy generation through the port's
``ServeEngine`` must equal ``repro``'s engine token for token, on both port
backends.

Tolerance: 0.  Every path is integer arithmetic or an IEEE-exact float32
elementwise step in the codified order, so the results are bit-identical.
"""
import jax
import numpy as np
import pytest
import torch

from repro.serving.engine import EngineConfig as JEngineConfig
from repro.serving.engine import Request as JRequest
from repro.serving.engine import ServeEngine as JServeEngine
from repro.serving.token_path import CompiledTokenAdapter as JAdapter
from repro.serving.token_path import CompiledTokenPath as JTokenPath
from repro.serving.token_path import decode_jax
from repro_torch.serving.engine import EngineConfig, Request, ServeEngine
from repro_torch.serving.token_path import CompiledTokenAdapter, CompiledTokenPath
from test_torch_token_path import (
    BACKENDS, CFG, JCFG, JPARAMS, PARAMS, _causal, _states, _tokens, prefill_mirror,
)

decode_mirror = jax.jit(lambda tok, oh, mask, states: decode_jax(JCFG, JPARAMS, tok, oh, mask, states))


@pytest.fixture(scope="module")
def tps():
    return {b: CompiledTokenPath(CFG, PARAMS, backend=b, device="cpu", s_granularity=8)
            for b in BACKENDS}


@pytest.fixture(scope="module")
def jtp():
    return JTokenPath(JCFG, JPARAMS, backend="ref", s_granularity=8)


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("n,plen", [(1, 3), (2, 5)])
def test_decode_steps_follow_prefill(tps, jtp, backend, n, plen):
    tp = tps[backend]
    rng = np.random.default_rng(7 * n + plen)
    s_max = 16
    toks = _tokens(rng, n, plen)
    _, pcache = tp.prefill(toks, _causal(n, plen))
    cache = tp.init_cache(n, s_max)
    for k in cache:
        cache[k][:, :plen] = pcache[k][:, :plen]
    jstates = _states(tp, cache)
    rcache = {k: v.numpy().copy() for k, v in cache.items()}
    for step in range(3):
        pos = plen + step
        tok = _tokens(rng, n, 1)
        onehot = np.zeros((n, s_max, 1), np.int8)
        onehot[:, pos, 0] = 1
        mask = np.broadcast_to(np.arange(s_max)[None, None, :] <= pos, (n, 1, s_max)).astype(np.float32)
        logits, cache = tp.decode(tok, onehot, mask, cache)
        jl, jstates = decode_mirror(tok, onehot, mask, jstates)
        rl, rcache = jtp.decode(tok, onehot, mask, rcache)
        np.testing.assert_array_equal(logits.numpy(), np.asarray(jl))
        np.testing.assert_array_equal(logits.numpy(), rl)
        for (kj, vj), (kc, vc) in zip(jstates, _states(tp, cache)):
            np.testing.assert_array_equal(kc, np.asarray(kj))
            np.testing.assert_array_equal(vc, np.asarray(vj))
        jstates = [(np.asarray(k), np.asarray(v)) for k, v in jstates]


def _serve(engine_cls, config_cls, request_cls, adapter, prompts, **ecfg):
    eng = engine_cls(ecfg=config_cls(**ecfg), adapter=adapter)
    reqs = [request_cls(uid=i, prompt=p, max_new_tokens=m) for i, (p, m) in enumerate(prompts)]
    for r in reqs:
        eng.submit(r)
    eng.run_until_drained()
    return eng, [list(r.generated) for r in reqs]


def _prompts(seed, count):
    rng = np.random.default_rng(seed)
    return [(rng.integers(1, CFG.vocab, (int(rng.integers(2, 12)),)).astype(np.int32),
             int(rng.integers(1, 6))) for _ in range(count)]


@pytest.mark.parametrize("backend", BACKENDS)
def test_engine_matches_repro_engine(backend):
    tp = CompiledTokenPath(CFG, PARAMS, backend=backend, device="cpu", s_granularity=8)
    prompts = _prompts(11, 5)
    ecfg = dict(slots=2, max_len=24, prefill_bucket=8)
    _, got = _serve(ServeEngine, EngineConfig, Request, CompiledTokenAdapter(tp), prompts, **ecfg)
    jtp = JTokenPath(JCFG, JPARAMS, backend="ref", s_granularity=8)
    _, want = _serve(JServeEngine, JEngineConfig, JRequest, JAdapter(jtp), prompts, **ecfg)
    assert got == want
    assert [len(g) for g in got] == [m for _, m in prompts]


def test_engine_matches_mirror_generation(tps):
    """Greedy generation through the port's engine == a hand-rolled loop of
    ``repro``'s jnp mirrors (the counterpart of
    ``tests/test_token_path.py::test_engine_matches_mirror_generation``)."""
    eng = ServeEngine(ecfg=EngineConfig(slots=1, max_len=16, prefill_bucket=8),
                      adapter=CompiledTokenAdapter(tps["cuda"]))
    prompt = np.array([5, 9, 2], np.int32)
    req = Request(uid=0, prompt=prompt, max_new_tokens=4)
    eng.submit(req)
    eng.run_until_drained()

    bucket, s_max, plen = 8, 16, len(prompt)
    padded = np.zeros((1, bucket), np.int32)
    padded[0, :plen] = prompt
    jl, jcaches = prefill_mirror(padded, _causal(1, bucket))
    states = []
    for k, v in jcaches:
        ks = np.zeros((1, s_max, CFG.d_model), np.int8)
        vs = np.zeros((1, s_max, CFG.d_model), np.int8)
        ks[:, :bucket] = np.asarray(k)
        vs[:, :bucket] = np.asarray(v)
        states.append((ks, vs))
    toks = [int(np.asarray(jl)[0, plen - 1].argmax())]
    pos = plen
    for _ in range(3):
        onehot = np.zeros((1, s_max, 1), np.int8)
        onehot[0, pos, 0] = 1
        mask = (np.arange(s_max)[None, None, :] <= pos).astype(np.float32)
        jl, states = decode_mirror(np.array([[toks[-1]]], np.int32), onehot, mask, states)
        toks.append(int(np.asarray(jl)[0, 0].argmax()))
        pos += 1
    assert req.generated == toks


def test_one_specialization_per_visited_cell():
    tp = CompiledTokenPath(CFG, PARAMS, backend="cuda", device="cpu", s_granularity=8)
    eng, _ = _serve(ServeEngine, EngineConfig, Request, CompiledTokenAdapter(tp),
                    [(p, 4) for p, _ in _prompts(5, 4)], slots=2, max_len=16, prefill_bucket=8)
    stats = tp.cache_stats()
    # prompts of 2..11 tokens visit prefill cells (1, 8) and (1, 16); decode
    # runs one cell (2, 16): every other step is a cache hit
    visited = 1 + len({-(-len(p) // 8) for p, _ in _prompts(5, 4)})
    assert stats["misses"] == stats["size"] == visited
    assert stats["hits"] == eng.metrics["prefills"] + eng.metrics["decode_steps"] - visited


def test_scatter_writes_the_device_cache_in_place(tps):
    adapter = CompiledTokenAdapter(tps["cuda"])
    cache = adapter.init_cache(2, 16)
    before = {k: v for k, v in cache.items()}
    _, pcache = adapter.prefill(np.array([[3, 4, 5, 0, 0, 0, 0, 0]], np.int32), 3, 16)
    out = adapter.scatter(cache, 1, pcache)
    for k, v in out.items():
        assert v is before[k]  # no copy of the cache
        np.testing.assert_array_equal(v[1, :8].numpy(), pcache[k][0].numpy())
        assert not v[0].any()
