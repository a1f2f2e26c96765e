"""A bound decode plan replayed as one CUDA graph (``backend/graph.py``).

On the CPU:

* which plans capture: a bound bucket, the ``cuda`` backend on a CUDA
  device and state slots; every other plan runs its step loop, counted
  under ``eager``;
* the executor's buffer contract, with a stand-in for the capture that
  replays the eager loop on the static buffers: a cache fed back is not
  copied, a foreign one is copied in and left as it was, an in-place write
  into the returned cache between calls is what the next call reads, the
  logits outlive the next call, each replay adds the captured launches to
  ``launch_counts()``, and a capture that fails leaves every call eager;
* the token path's tiny config served by ``ServeEngine`` through the
  graphed executor equals the eager loop in every token, logit and KV row;
* every maker of a plan-cache entry (lazy specialization, an artifact's
  recorded cells, the server's tuned swap) goes through
  ``CompiledModel.install``.

On the card (marked ``card``; ``python -m pytest tests/test_torch_plan_graph.py -m card``):
40 decode steps replayed as a CUDA graph against the eager loop, with
prefilled rows scattered into slots between steps.

Every comparison is exact: the graph runs the eager loop's kernels on the
same bytes.  No tolerance.
"""
import numpy as np
import pytest
import torch

from repro_torch import kernels
from repro_torch.backend.artifact import load_artifact, save_artifact
from repro_torch.backend.autotune import Autotuner
from repro_torch.backend.graph import (
    EagerExecutor,
    GraphedExecutor,
    capturable,
    executor_for,
    record_launches,
)
from repro_torch.core.compile import CompiledModel, compile_model
from repro_torch.core.toolchain import MLPSpec, quantize_mlp
from repro_torch.serving import CompiledModelServer, CompiledServerConfig
from repro_torch.serving.engine import EngineConfig, Request, ServeEngine
from repro_torch.serving.token_path import CompiledTokenAdapter, CompiledTokenPath, TokenPathConfig

N, S = 2, 16
#: What the stand-in capture says each replay launches.
CAPTURED = {"qattention": 4, "qmatmul_packed": 2}


def standin_capture(body, device):
    """A capture as a CUDA graph behaves, with nothing recorded: ``body``
    (the eager loop on the static buffers, states copied back) runs once,
    and each replay runs it again and writes its outputs into the tensors
    that first run returned."""
    outs = body()

    def replay():
        for name, v in body().items():
            outs[name].copy_(v)
        return outs

    return replay, dict(CAPTURED)


def failing_capture(body, device):
    raise RuntimeError("operation not permitted when stream is capturing")


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.fixture(scope="module")
def tp():
    return CompiledTokenPath(TokenPathConfig(), backend="cuda", device="cpu", s_granularity=8)


def _cache(tp, seed, n=N, s=S):
    g = torch.Generator().manual_seed(seed)
    return {name: torch.randint(-127, 128, (n, s, tp.cfg.d_model), generator=g, dtype=torch.int8)
            for name in tp.init_cache(n, s)}


def _feeds(tp, cache, step=0):
    toks = np.array([[3 + step], [5 + 2 * step]], np.int32)[:N]
    return tp.decode_feeds(toks, np.array([4 + step, 7 + step], np.int32)[:N], cache)


def _plan(tp):
    return tp.decode_cm.specialized({"N": N, "S": S})[0]


def _graphed(tp, capture=standin_capture):
    return GraphedExecutor(_plan(tp), "cpu", {"captures": 0, "replays": 0, "eager": 0}, capture)


def _clone(d):
    return {k: v.clone() for k, v in d.items()}


def _assert_equal(got, want):
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == want[k].dtype and torch.equal(got[k], want[k]), k


def _states(tp, outs):
    return {s.input: outs[s.output] for s in tp.state_specs}


# -- which plans capture ------------------------------------------------------

@pytest.mark.parametrize("case, want", [
    ("decode", True), ("decode on the CPU", False), ("template", False),
    ("prefill", False), ("ref backend", False),
])
def test_capture_policy(tp, case, want):
    ref = CompiledTokenPath(TokenPathConfig(), backend="ref", device="cpu", s_granularity=8)
    plan, device = {
        "decode": (_plan(tp), "cuda"),
        "decode on the CPU": (_plan(tp), "cpu"),
        "template": (tp.decode_cm.plan, "cuda"),
        "prefill": (tp.prefill_cm.specialized({"N": 1, "S": 8})[0], "cuda"),
        "ref backend": (ref.decode_cm.specialized({"N": N, "S": S})[0], "cuda"),
    }[case]
    assert capturable(plan, torch.device(device)) is want
    run = executor_for(plan, device, {"captures": 0, "replays": 0, "eager": 0})
    assert type(run) is (GraphedExecutor if want else EagerExecutor)


def test_every_plan_on_the_cpu_runs_eagerly_and_counts_it():
    tp = CompiledTokenPath(TokenPathConfig(), backend="cuda", device="cpu", s_granularity=8)
    cache = tp.init_cache(N, S)
    for step in range(3):
        toks = np.array([[3 + step], [5 + step]], np.int32)
        _, cache = tp.decode_step(toks, np.array([4 + step, 7 + step], np.int32), cache)
    tp.prefill(np.ones((1, 8), np.int32), torch.tril(torch.ones((8, 8)))[None])
    assert tp.graph_stats() == {"captures": 0, "replays": 0, "eager": 4}


# -- the executor's buffer contract ---------------------------------------------

def test_a_cache_fed_back_is_not_copied(tp):
    run = _graphed(tp)
    first = run(_feeds(tp, _cache(tp, 0)))
    assert run.copied_in == 3 + len(tp.state_specs)  # tokens, onehot, mask and every state
    back = _states(tp, first)
    second = run(_feeds(tp, back, step=1))
    assert run.copied_in == 3  # the feeds decode_feeds built; no state
    assert all(_states(tp, second)[k] is back[k] for k in back)
    assert run.stats == {"captures": 1, "replays": 2, "eager": 0}


def test_a_foreign_cache_is_copied_in_and_left_alone(tp):
    plan, run = _plan(tp), _graphed(tp)
    for seed in (1, 2):
        mine = _cache(tp, seed)
        kept = _clone(mine)
        feeds = _feeds(tp, mine)
        want = plan.execute(_clone(feeds))
        got = run(feeds)
        assert run.copied_in == 3 + len(mine)
        _assert_equal(mine, kept)
        _assert_equal(got, want)
        assert not any(got[s.output] is mine[s.input] for s in tp.state_specs)


def test_an_in_place_write_between_calls_is_read_by_the_next(tp):
    plan, run = _plan(tp), _graphed(tp)
    cache = _states(tp, run(_feeds(tp, _cache(tp, 3))))
    g = torch.Generator().manual_seed(4)
    for buf in cache.values():  # as CompiledTokenAdapter.scatter writes a slot's prefilled rows
        buf[1, :5].copy_(torch.randint(-127, 128, (5, tp.cfg.d_model), generator=g, dtype=torch.int8))
    feeds = _feeds(tp, cache, step=1)
    want = plan.execute(_clone(feeds))
    _assert_equal(run(feeds), want)
    assert run.copied_in == 3


def test_the_logits_outlive_the_next_call(tp):
    run = _graphed(tp)
    logits = tp._logits_decode
    first = run(_feeds(tp, _cache(tp, 5)))
    kept = first[logits].clone()
    second = run(_feeds(tp, _states(tp, first), step=1))
    assert torch.equal(first[logits], kept)
    assert not torch.equal(second[logits], kept)


def test_each_replay_adds_the_captured_launches(tp):
    run = _graphed(tp)
    kernels.reset_launch_counts()
    cache = _cache(tp, 6)
    for step in range(3):
        cache = _states(tp, run(_feeds(tp, cache, step)))
        counts = kernels.launch_counts()
        assert {k: counts[k] for k in CAPTURED} == {k: (step + 1) * v for k, v in CAPTURED.items()}
    assert sum(kernels.launch_counts().values()) == 3 * sum(CAPTURED.values())


def test_record_launches_returns_what_was_counted_and_takes_it_back():
    kernels.reset_launch_counts()
    kernels.add_launch_counts({"qmatmul": 2})

    def launches():
        kernels.add_launch_counts({"qmatmul": 5, "qattention": 3})

    assert record_launches(launches) == {"qmatmul": 5, "qattention": 3}
    assert kernels.launch_counts()["qmatmul"] == 2 and kernels.launch_counts()["qattention"] == 0


@pytest.mark.parametrize("why", ["the capture failed", "a feed of another dtype"])
def test_what_cannot_replay_runs_eagerly(tp, why):
    plan = _plan(tp)
    run = _graphed(tp, failing_capture if why == "the capture failed" else standin_capture)
    feeds = _feeds(tp, _cache(tp, 7))
    if why == "a feed of another dtype":
        run(_clone(feeds))
        feeds["tokens"] = feeds["tokens"].to(torch.int64)
    _assert_equal(run(feeds), plan.execute(_clone(feeds)))
    want = {"captures": 0, "replays": 0, "eager": 1} if why == "the capture failed" \
        else {"captures": 1, "replays": 1, "eager": 1}
    assert run.stats == want


# -- the token path served through the graphed executor -------------------------

def _serve(tp, graphed: bool):
    """Three requests over two slots: admissions between decode steps."""
    if graphed:
        cm = tp.decode_cm
        key = cm.cache_key({"N": 2, "S": 32})
        plan = cm.specialized({"N": 2, "S": 32})[0]
        tp.plan_cache.put(key, (plan, GraphedExecutor(plan, "cpu", tp.plan_cache.graph_stats,
                                                       standin_capture)))
    eng = ServeEngine(ecfg=EngineConfig(slots=2, max_len=32, prefill_bucket=8, greedy=True),
                      adapter=CompiledTokenAdapter(tp))
    reqs = [Request(uid=i, prompt=np.arange(1, 5 + 3 * i), max_new_tokens=6 + 2 * i) for i in range(3)]
    for r in reqs:
        eng.submit(r)
    logits = []
    real = eng.adapter.decode

    def decode(toks, pos, cache):
        lg, nxt = real(toks, pos, cache)
        logits.append(lg.clone())
        return lg, nxt

    eng.adapter.decode = decode
    eng.run_until_drained()
    return [list(r.generated) for r in reqs], logits, _clone(eng.cache)


def test_the_served_token_path_equals_the_eager_loop():
    tps = [CompiledTokenPath(TokenPathConfig(), backend="cuda", device="cpu", s_granularity=8)
           for _ in range(2)]
    got, want = _serve(tps[0], graphed=True), _serve(tps[1], graphed=False)
    assert got[0] == want[0] and len(got[1]) == len(want[1]) > 10
    for a, b in zip(got[1], want[1]):
        assert torch.equal(a, b)
    _assert_equal(got[2], want[2])
    stats = tps[0].graph_stats()
    assert stats["captures"] == 1 and stats["replays"] == len(got[1])


# -- one maker of plan-cache entries --------------------------------------------

def _tuned_swap_cache():
    """An MLP served with a background tuner until its cell's tuned plan
    is swapped in."""
    rng = np.random.default_rng(4)
    spec = MLPSpec(weights=[rng.normal(0, 0.4, (64, 64)).astype(np.float32) for _ in range(2)],
                   biases=[rng.normal(0, 0.2, (64,)).astype(np.float32) for _ in range(2)],
                   activations=["Relu", None])
    cm = compile_model(quantize_mlp(spec, rng.normal(0, 1.0, (32, 64)).astype(np.float32)),
                       backend="cuda", device="cpu", batch="dynamic")
    tuner = Autotuner(budget=2, measure_fn=lambda step, shape, backend: 1.0)
    srv = CompiledModelServer(cm, CompiledServerConfig(max_batch=4), autotuner=tuner)
    for _ in range(4):
        srv.submit(rng.integers(-128, 128, (64,)).astype(np.int8))
    srv.step()
    while srv.tuning_pending:
        srv.step()
    assert srv.metrics["tuned_swaps"] == 1
    return cm.plan_cache


@pytest.mark.parametrize("maker", ["specialized", "load_artifact", "tuned swap"])
def test_every_cache_entry_is_made_by_install(maker, monkeypatch, tmp_path):
    """Lazy specialization, an artifact's recorded cells and the server's
    tuned swap all put their entries through ``CompiledModel.install``: each
    entry's executor is the type ``executor_for`` picks for its plan, and it
    counts into the graph stats of the cache that holds it."""
    made = {}
    real = CompiledModel.install

    def spy(self, bindings, tuner):
        entry = real(self, bindings, tuner)
        made[self.cache_key(bindings)] = (self, entry)
        return entry

    monkeypatch.setattr(CompiledModel, "install", spy)
    if maker == "tuned swap":
        cache = _tuned_swap_cache()
    else:
        tp = CompiledTokenPath(TokenPathConfig(), backend="cuda", device="cpu", s_granularity=8)
        tp.decode_cm.specialized({"N": N, "S": S})
        cache = tp.plan_cache
        if maker == "load_artifact":
            path = save_artifact(tp.decode_cm, str(tmp_path / "decode.json"))
            made.clear()
            cache = load_artifact(path, device="cpu").plan_cache
            assert cache.stats["misses"] == 0
    keys = list(cache.keys())
    assert keys and set(keys) == set(made)
    for key in keys:
        owner, entry = made[key]
        assert cache.peek(key) is entry
        plan, run = entry
        assert type(run) is type(executor_for(plan, owner.device, {}))
        assert run.stats is cache.graph_stats


# -- on the card ---------------------------------------------------------------

@pytest.mark.card
def test_graphed_decode_on_the_card_equals_the_eager_loop(card):
    tp = CompiledTokenPath(TokenPathConfig(), backend="cuda", device=card, s_granularity=8)
    n, s, steps = 4, 64, 40
    plan = tp.decode_cm.specialized({"N": n, "S": s})[0]
    rng = np.random.default_rng(0)
    graphed, eager = tp.init_cache(n, s), tp.init_cache(n, s)
    pos = np.full((n,), 8, np.int64)
    toks = rng.integers(1, tp.cfg.vocab, (n, 1)).astype(np.int32)
    for step in range(steps):
        if step % 9 == 0:  # an admission: a slot's prefilled rows scattered into both caches
            slot, plen = step % n, 8
            prompt = rng.integers(1, tp.cfg.vocab, (1, plen)).astype(np.int32)
            _, rows = tp.prefill(prompt, torch.tril(torch.ones((plen, plen), device=card))[None])
            for cache in (graphed, eager):
                for name, buf in cache.items():
                    buf[slot, :plen].copy_(rows[name][0])
            pos[slot] = plen
        lg_g, graphed = tp.decode_step(toks, pos, graphed)
        outs = plan.execute(tp.decode_feeds(toks, pos, eager))
        lg_e, eager = outs[tp._logits_decode][:, 0, :], _states(tp, outs)
        assert torch.equal(lg_g, lg_e), f"step {step}: logits"
        for name in eager:
            assert torch.equal(graphed[name], eager[name]), f"step {step}: {name}"
        toks = lg_g.argmax(-1).to(torch.int32).cpu().numpy()[:, None]
        pos = np.minimum(pos + 1, s - 1)
    assert tp.graph_stats()["captures"] == 1 and tp.graph_stats()["replays"] == steps
