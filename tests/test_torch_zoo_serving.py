"""The port's ``ServeEngine`` over its default ``OpaqueModelAdapter`` against
``repro``'s, on the CPU.

``qwen3_1_7b`` at ``reduced()`` with ``repro``'s float32 parameters carried
across (``params_from_numpy``), served in the three postures of
``examples/serve_quantized.py`` — ``bf16/bf16-kv``, ``bf16/int8-kv`` and
``w8a8/int8-kv`` — by both engines with the same ``EngineConfig`` and the
same greedy requests: six prompts of 24 tokens and two of 40, so prompts
fill two prefill buckets (32 and 64) and every prefill re-decodes its last
token (``_logits_at``).  Tolerance: the generated tokens and the engine
metrics are equal.  Greedy tokens can only be held equal where the choice
is clear, so each logits row ``repro``'s engine picks from is first asserted
to have a top-2 margin above 1e-4 · max(1, max |row|), the model tests'
logits bound (``tests/test_torch_models.py``).

``serve_demo``'s budget cases mirror ``tests/test_serving_engine.py::
TestGenerationBudget`` on the port (its own seeded weights, on the CPU).
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config
from repro.core.convert import convert_params_w8a8 as jconvert
from repro.serving.engine import EngineConfig as JEngineConfig
from repro.serving.engine import Request as JRequest
from repro.serving.engine import ServeEngine as JServeEngine
from repro_torch.core.convert import convert_params_w8a8
from repro_torch.launch.serve import serve_demo
from repro_torch.models import model as TM
from repro_torch.serving.engine import EngineConfig, Request, ServeEngine
from test_torch_models import np_tree, repro_params

POSTURES = {"bf16/bf16-kv": ("bf16", False), "bf16/int8-kv": ("int8", False),
            "w8a8/int8-kv": ("int8", True)}
NEW_TOKENS, SLOTS = 8, 4


def _prompts(vocab):
    rng = np.random.default_rng(0)
    return [rng.integers(0, vocab, (n,)).astype(np.int32) for n in (24,) * 6 + (40,) * 2]


def _record(eng, log):
    """Log each logits row ``eng`` picks a greedy token from."""
    ad = eng.adapter
    prefill, decode = ad.prefill, ad.decode

    def logged_prefill(padded, plen, max_len):
        row, cache = prefill(padded, plen, max_len)
        log.append(np.asarray(row)[None])
        return row, cache

    def logged_decode(toks, pos, cache):
        logits, cache = decode(toks, pos, cache)
        log.append(np.asarray(logits)[eng.slot_live])
        return logits, cache

    ad.prefill, ad.decode = logged_prefill, logged_decode


def _serve(engine_cls, config_cls, request_cls, params, cfg, prompts, log=None):
    ecfg = config_cls(slots=SLOTS, max_len=max(len(p) for p in prompts) + NEW_TOKENS + 8)
    eng = engine_cls(params, cfg, ecfg)
    if log is not None:
        _record(eng, log)
    reqs = [request_cls(uid=i, prompt=p, max_new_tokens=NEW_TOKENS) for i, p in enumerate(prompts)]
    for r in reqs:
        eng.submit(r)
    eng.run_until_drained()
    return [list(r.generated) for r in reqs], eng.metrics


@pytest.mark.parametrize("posture", list(POSTURES))
def test_default_adapter_matches_repro_engine(posture):
    kv, w8a8 = POSTURES[posture]
    cfg = dataclasses.replace(get_config("qwen3_1_7b", reduced=True), kv_cache_dtype=kv)
    jparams = repro_params(jax.random.PRNGKey(0), cfg)
    params = TM.params_from_numpy(np_tree(jparams), device="cpu")
    if w8a8:
        jparams, params = jconvert(jparams), convert_params_w8a8(params)
    prompts = _prompts(cfg.vocab_size)

    log = []
    want, want_metrics = _serve(JServeEngine, JEngineConfig, JRequest, jparams, cfg, prompts, log)
    for rows in log:
        top2 = np.sort(rows, axis=-1)[:, -2:]
        margin = top2[:, 1] - top2[:, 0]
        tol = 1e-4 * np.maximum(1.0, np.abs(rows).max(axis=-1))
        assert (margin > tol).all(), "a greedy choice too close to call: the tokens cannot be held"
    got, metrics = _serve(ServeEngine, EngineConfig, Request, params, cfg, prompts)
    assert got == want
    assert [len(g) for g in got] == [NEW_TOKENS] * len(prompts)
    assert metrics == want_metrics
    assert metrics["prefill_cache_size"] == 2 and metrics["prefill_cache_hits"] == len(prompts) - 2


@pytest.mark.parametrize("budget", [1, 2, 16])
def test_serve_demo_generates_exactly_max_new_tokens(budget):
    """``tests/test_serving_engine.py::TestGenerationBudget`` on the port:
    the prefill token counts against the budget; a budget of 1 completes at
    admit, with no decode step."""
    reqs, eng = serve_demo("qwen3_1_7b", requests=5, prompt_len=12, new_tokens=budget, slots=2,
                           device="cpu")
    assert all(r.done for r in reqs)
    assert [len(r.generated) for r in reqs] == [budget] * 5
    assert eng.metrics["completed"] == 5
    if budget == 1:
        assert eng.metrics["decode_steps"] == 0
    assert all(r.t_done is not None and r.t_done >= r.t_first for r in reqs)


def test_prefill_cache_is_bounded_and_published():
    """``EngineConfig.prefill_cache_size`` bounds the prefill closures (LRU);
    the evictions reach the metrics and the registry's ``cache.prefill.*``
    gauges, as ``repro``'s engine publishes them."""
    cfg = get_config("qwen3_1_7b", reduced=True)
    params = TM.init_params(torch.Generator().manual_seed(0), cfg, device="cpu")
    eng = ServeEngine(params, cfg, EngineConfig(slots=1, max_len=96, prefill_cache_size=1))
    rng = np.random.default_rng(1)
    for i, n in enumerate((5, 40, 6, 70)):
        eng.submit(Request(uid=i, prompt=rng.integers(0, 512, (n,)).astype(np.int32),
                           max_new_tokens=2))
    eng.run_until_drained()
    assert eng.metrics["prefill_cache_size"] == 1
    assert eng.metrics["prefill_cache_evictions"] == 3
    assert eng.registry.snapshot()["cache.prefill.evictions"] == 3.0
