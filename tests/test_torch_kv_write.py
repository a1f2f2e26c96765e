"""The decode step's KV update as one ``kv_write`` step
(``core/compile.py::_match_kv_write``, ``kernels/kv_write.py``,
``csrc/kv_write.cu``).

On the CPU:

* the plain version, the ``cuda`` wrapper and both backends' step equal the
  four generic int8 steps (Sub, Mul, Mul, Add) bit for bit: onehots with one
  1 a row, all-zero slots, two non-zero entries in a row, the values −1 and
  127, at a full cache's and a ring's row count;
* the compiler fuses two updates a layer on the MiniCPM-shaped and the
  Mellum2-shaped tiny decode graphs, and none on a look-alike whose cache is
  not a state or whose onehot is not ``(N, R, 1)``;
* an eager decode leaves the caller's cache as it was; a graphed executor's
  plan writes every state in place, so its returned states are its static
  buffers and nothing is copied back.

On the card (marked ``card``; ``python -m pytest tests/test_torch_kv_write.py
-m card``): the kernel against the plain version at the benchmark cells'
shapes, (16, 4,096, 2,304), the Mellum2 ring (64, 1,024, 512) and its
full cache (64, 7,680, 512), whose rows span two of a block's row chunks;
the wrapper refusing rows off 16 bytes; and a graphed decode at a tiny
config against the eager loop, its states on the static buffers across
replays and ``kv_write`` launched steps × matches times.

Every comparison is exact: the update is integer arithmetic.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch import kernels
from repro_torch.backend.generic import _TOPS
from repro_torch.backend.graph import GraphedExecutor, writes_states_in_place
from repro_torch.backend.plan import PlanStep
from repro_torch.backend.registry import lookup
from repro_torch.core.compile import compile_model
from repro_torch.core.pqir import GraphBuilder
from repro_torch.core.runtime import ReferenceRuntime
from repro_torch.kernels import kv_write as kvw
from repro_torch.serving.token_path import CompiledTokenPath, TokenPathConfig

MELLUM2_TINY = TokenPathConfig(vocab=97, d_model=64, n_heads=4, n_layers=4, n_kv_heads=2, head_dim=16,
                               layer_kinds=("window", "window", "window", "full"), window=8,
                               n_experts=8, top_k=2, d_expert=32)
CONFIGS = {"minicpm-shaped": TokenPathConfig(), "mellum2-shaped": MELLUM2_TINY}
#: On the card the experts' kernels take widths that are multiples of 64.
CARD_CONFIGS = {"minicpm-shaped": TokenPathConfig(),
                "mellum2-shaped": dataclasses.replace(MELLUM2_TINY, vocab=211, d_model=128, head_dim=32,
                                                      d_expert=64)}
ONEHOTS = ["one-a-row", "padded-slot", "two-in-a-row", "minus-one", "max"]


def _onehot(case, n, r, seed):
    g = torch.Generator().manual_seed(seed)
    h = torch.zeros((n, r, 1), dtype=torch.int8)
    pos = torch.randint(0, r, (n,), generator=g)
    h[torch.arange(n), pos] = 1
    if case == "padded-slot":
        h[1] = 0
    elif case == "two-in-a-row":
        h[0, (pos[0] + 1) % r] = 1
    elif case in ("minus-one", "max"):
        h[torch.arange(n), pos] = -1 if case == "minus-one" else 127
        h[2, (pos[2] + 3) % r] = 1
    return h


def _operands(n, r, w, seed, device="cpu"):
    g = torch.Generator().manual_seed(seed)
    s = torch.randint(-128, 128, (n, r, w), generator=g, dtype=torch.int8).to(device)
    qkv = torch.randint(-128, 128, (n, 1, 3 * w), generator=g, dtype=torch.int8).to(device)
    return s, qkv[:, :, w:2 * w]  # the new rows: a strided view, as the plan's Slice gives them


def _generic(s, h, x):
    """The four codified steps through the generic op table."""
    run = lambda op, *ins: _TOPS[op]({}, list(ins))[0]  # noqa: E731
    keep = run("Sub", torch.ones((1,), dtype=torch.int8), h)
    return run("Add", run("Mul", s, keep), run("Mul", x, h))


@pytest.mark.parametrize("rows", [40, 8], ids=["full", "ring"])
@pytest.mark.parametrize("case", ONEHOTS)
def test_the_update_equals_the_four_generic_steps(case, rows):
    n, w = 4, 48
    s, x = _operands(n, rows, w, seed=rows)
    h = _onehot(case, n, rows, seed=ONEHOTS.index(case))
    want = _generic(s, h, x)
    kept = s.clone()
    for got in (kvw.kv_write_plain(s.clone(), h, x), kvw.kv_write(s.clone(), h, x)):
        assert got.dtype == torch.int8 and torch.equal(got, want)
    for backend in ("ref", "cuda"):
        (got,) = lookup(backend, "kv_write")(PlanStep("kv_write", (), ()), [s, h, x])
        assert torch.equal(got, want) and got is not s
    assert torch.equal(s, kept)
    changed = (want != s).any(dim=2)
    assert bool((changed <= (h[..., 0] != 0)).all())  # only the rows h selects move


def test_the_wrapper_refuses_what_it_does_not_take():
    s, x = _operands(2, 8, 16, seed=0)
    h = _onehot("one-a-row", 2, 8, seed=0)
    with pytest.raises(ValueError, match="onehot"):
        kvw.kv_write(s, h[:, :4], x)
    with pytest.raises(ValueError, match="int8"):
        kvw.kv_write(s, h.to(torch.int32), x)


@pytest.mark.parametrize("config", CONFIGS)
def test_two_updates_a_layer_are_fused(config):
    cfg = CONFIGS[config]
    for backend in ("ref", "cuda"):
        tp = CompiledTokenPath(cfg, backend=backend, device="cpu", s_granularity=8)
        assert tp.decode_cm.stats["fused_kv_write"] == 2 * cfg.n_layers
        assert tp.prefill_cm.stats["fused_kv_write"] == 0
        steps = [s for s in tp.decode_cm.plan.steps if s.kernel == "kv_write"]
        assert {s.args[0].name for s in steps} == {sp.input for sp in tp.state_specs}
        assert not any(s.kernel in ("op.Sub", "op.Mul") and s.out_info[0].dtype == "int8"
                       for s in tp.decode_cm.plan.steps)


def _look_alike(case):
    """``Add(Mul(S, Sub(1, H)), Mul(X, H))`` at static shapes; ``S`` a
    state unless ``case`` is "not-a-state"; ``H`` full width where ``case``
    is "onehot-full-width"."""
    n, r, w = 2, 6, 16
    gb = GraphBuilder("kv_look_alike")
    gb.add_input("s", "int8", (n, r, w))
    gb.add_input("h", "int8", (n, r, w if case == "onehot-full-width" else 1))
    gb.add_input("x", "int8", (n, 1, w))
    one = gb.add_initializer("one", np.ones((1,), np.int8))
    keep = gb.op("Sub", [one, "h"], out_hint="keep")
    out = gb.op("Add", [gb.op("Mul", ["s", keep], out_hint="kept"), gb.op("Mul", ["x", "h"], out_hint="put")],
                out_hint="new")
    gb.add_output(out, "int8", (n, r, w))
    if case != "not-a-state":
        gb.add_state("kv", input="s", output=out)
    return gb.build(opset=17), (n, r, w)


@pytest.mark.parametrize("case, fused", [("a-state", 1), ("not-a-state", 0), ("onehot-full-width", 0)])
def test_the_matcher_takes_only_a_state_and_a_row_onehot(case, fused):
    model, (n, r, w) = _look_alike(case)
    rng = np.random.default_rng(1)
    feeds = {"s": rng.integers(-128, 128, (n, r, w)).astype(np.int8),
             "x": rng.integers(-128, 128, (n, 1, w)).astype(np.int8),
             "h": (rng.integers(0, 3, (n, r, w if case == "onehot-full-width" else 1)) - 1).astype(np.int8)}
    want = ReferenceRuntime(model).run(feeds)
    for backend in ("ref", "cuda"):
        cm = compile_model(model, backend=backend, device="cpu")
        assert cm.stats["fused_kv_write"] == fused
        assert [s.kernel for s in cm.plan.steps] == (["kv_write"] if fused else
                                                     ["op.Sub", "op.Mul", "op.Mul", "op.Add"])
        for k, v in want.items():
            np.testing.assert_array_equal(cm.run(feeds)[k].numpy(), v)


def _tiny(cfg=TokenPathConfig(), device="cpu"):
    return CompiledTokenPath(cfg, backend="cuda", device=device, s_granularity=8)


def _cache(tp, n, s, seed, device="cpu"):
    g = torch.Generator().manual_seed(seed)
    return {name: torch.randint(-127, 128, tuple(buf.shape), generator=g, dtype=torch.int8).to(device)
            for name, buf in tp.init_cache(n, s).items()}


@pytest.mark.parametrize("config", CONFIGS)
def test_an_eager_decode_leaves_the_callers_cache_unchanged(config):
    tp = _tiny(CONFIGS[config])
    cache = _cache(tp, 2, 16, seed=2)
    kept = {k: v.clone() for k, v in cache.items()}
    _, nxt = tp.decode_step(np.array([[3], [5]], np.int32), np.array([4, 9]), cache)
    for name in cache:
        assert torch.equal(cache[name], kept[name]), name
        assert nxt[name].data_ptr() != cache[name].data_ptr()
        assert not torch.equal(nxt[name], cache[name])  # the new rows were written, into a copy
    assert tp.graph_stats() == {"captures": 0, "replays": 0, "eager": 1}


def test_a_graphed_plan_writes_every_state_in_place():
    tp = _tiny(MELLUM2_TINY)
    plan = tp.decode_cm.specialized({"N": 2, "S": 16})[0]
    marked = [s for s in writes_states_in_place(plan).steps if s.params.get("in_place")]
    assert len(marked) == 2 * MELLUM2_TINY.n_layers
    assert not any(s.params.get("in_place") for s in plan.steps)  # the eager plan is left as it was


def test_a_state_read_elsewhere_is_not_written_in_place():
    tp = _tiny()
    plan = tp.decode_cm.specialized({"N": 2, "S": 16})[0]
    first = next(s for s in plan.steps if s.kernel == "kv_write")
    steps = list(plan.steps)
    i = next(i for i, s in enumerate(steps) if s.kernel == "op.Slice")
    steps[i] = dataclasses.replace(steps[i], args=(first.args[0],) + steps[i].args[1:])
    marked = [s.name for s in writes_states_in_place(dataclasses.replace(plan, steps=steps)).steps
              if s.params.get("in_place")]
    assert first.name not in marked and len(marked) == 2 * TokenPathConfig().n_layers - 1


def _replay_by_running(body, device):
    """A capture as a CUDA graph behaves, run eagerly (nothing recorded)."""
    outs = body()

    def replay():
        for name, v in body().items():
            outs[name].copy_(v)
        return outs

    return replay, {}


def test_the_graphed_states_are_written_in_place_and_never_copied_back(monkeypatch):
    tp = _tiny(MELLUM2_TINY)
    n, s = 2, 16
    plan = tp.decode_cm.specialized({"N": n, "S": s})[0]
    run = GraphedExecutor(plan, "cpu", {"captures": 0, "replays": 0, "eager": 0}, _replay_by_running)
    real_copy = torch.Tensor.copy_
    targets = []

    def spy(dst, src, *args, **kwargs):
        if dst.data_ptr() != src.data_ptr():
            targets.append(dst.data_ptr())
        return real_copy(dst, src, *args, **kwargs)

    cache, eager = _cache(tp, n, s, seed=3), _cache(tp, n, s, seed=3)
    for step in range(4):
        toks, pos = np.array([[3 + step], [8 + step]], np.int32), np.array([4 + step, 11 + step])
        want = plan.execute(tp.decode_feeds(toks, pos, eager))
        feeds = tp.decode_feeds(toks, pos, cache)
        targets.clear()
        with monkeypatch.context() as m:
            m.setattr(torch.Tensor, "copy_", spy)
            outs = run(feeds)
        for sp in tp.state_specs:
            assert torch.equal(outs[sp.output], want[sp.output])
        cache = {sp.input: outs[sp.output] for sp in tp.state_specs}
        eager = {sp.input: want[sp.output] for sp in tp.state_specs}
    static = {run._static[sp.input].data_ptr() for sp in tp.state_specs}
    assert {v.data_ptr() for v in cache.values()} == static
    assert targets and not static & set(targets)  # the feeds were copied in, no state copied back
    assert run.copied_in == 5 and run.stats["replays"] == 4  # tokens, onehot, mask and the ring's two


# -- on the card ---------------------------------------------------------------

@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kv_write kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.card
@pytest.mark.parametrize("shape", [(16, 4096, 2304), (64, 1024, 512), (64, 7680, 512)],
                         ids=["minicpm2b-cache", "mellum2-ring", "mellum2-cache-two-blocks"])
@pytest.mark.parametrize("case", ONEHOTS)
def test_kv_write_on_the_card_equals_the_plain_version(card, shape, case):
    n, r, w = shape
    s, x = _operands(n, r, w, seed=r, device=card)
    h = _onehot(case, n, r, seed=w).to(card)
    want = kvw.kv_write_plain(s.clone(), h, x)
    before = kvw.LAUNCHES["kv_write"]
    got = kvw.kv_write(s.clone(), h, x)
    torch.cuda.synchronize()
    assert kvw.LAUNCHES["kv_write"] - before == 1
    assert torch.equal(got, want) and not torch.equal(want, s)


@pytest.mark.card
@pytest.mark.parametrize("case", ["width-40", "row-base-off-8"])
def test_kv_write_on_the_card_refuses_rows_off_16_bytes(card, case):
    n, r, w = 3, 64, 40 if case == "width-40" else 48
    s, x = _operands(n, r, w, seed=1, device=card)
    if case == "row-base-off-8":
        x = torch.randint(-128, 128, (n, 1, 3 * w), dtype=torch.int8, device=card)[:, :, 8:8 + w]
    h = _onehot("one-a-row", n, r, seed=1).to(card)
    before = kvw.LAUNCHES["kv_write"]
    with pytest.raises(ValueError, match="16-byte"):
        kvw.kv_write(s, h, x)
    assert kvw.LAUNCHES["kv_write"] == before


@pytest.mark.card
@pytest.mark.parametrize("config", CARD_CONFIGS)
def test_graphed_decode_on_the_card_writes_in_place_and_equals_the_eager_loop(card, config):
    cfg = CARD_CONFIGS[config]
    tp = _tiny(cfg, device=card)
    n, s, steps = 4, 64, 12
    plan = tp.decode_cm.specialized({"N": n, "S": s})[0]
    rng = np.random.default_rng(1)
    graphed, eager = _cache(tp, n, s, seed=4, device=card), _cache(tp, n, s, seed=4, device=card)
    pos = rng.integers(0, 40, n)
    toks = rng.integers(1, cfg.vocab, (n, 1)).astype(np.int32)
    ptrs = None
    for step in range(steps):
        if step == 2:
            kernels.reset_launch_counts()
        lg_g, graphed = tp.decode_step(toks, pos, graphed)
        outs = plan.execute(tp.decode_feeds(toks, pos, eager))
        lg_e, eager = outs[tp._logits_decode][:, 0, :], {sp.input: outs[sp.output] for sp in tp.state_specs}
        assert torch.equal(lg_g, lg_e), f"step {step}: logits"
        for name in eager:
            assert torch.equal(graphed[name], eager[name]), f"step {step}: {name}"
        now = {k: v.data_ptr() for k, v in graphed.items()}
        assert ptrs is None or now == ptrs, f"step {step}: the states left the static buffers"
        ptrs = now
        toks = lg_g.argmax(-1).to(torch.int32).cpu().numpy()[:, None]
        pos = pos + 1
    assert tp.graph_stats()["captures"] == 1 and tp.graph_stats()["replays"] == steps
    # the eager loop launches too: each of the last steps - 2 steps counts twice
    assert kernels.launch_counts()["kv_write"] == 2 * (steps - 2) * 2 * cfg.n_layers
