"""The token path widened to Mellum2's block, on the CPU at a small size:
grouped-query attention (4 query heads over 2 KV heads of 16), window
layers with ring caches (window 8, layers window × 3 then full) and routed
int8 experts (8 experts of width 32, top-2), held to equality with the plain
reference (``portbench/reference/tokpath-mellum2.py``, loaded by path) and with
``ReferenceRuntime`` on the unfused expert region.

Tolerance: 0.  Every path is integer arithmetic or an IEEE-exact float32
step in the codified order.
"""
import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.core import moe, pqir
from repro_torch.core.compile import compile_model
from repro_torch.core.runtime import ReferenceRuntime
from repro_torch.kernels import qmoe as kqmoe
from repro_torch.kernels import ref as kref
from repro_torch.serving.token_path import (
    CompiledTokenAdapter,
    CompiledTokenPath,
    TokenPathConfig,
    make_token_params,
    ring_order,
)

_SPEC = importlib.util.spec_from_file_location(
    "mellum2_reference", Path(__file__).resolve().parents[1] / "portbench" / "reference" / "tokpath-mellum2.py")
reference = importlib.util.module_from_spec(_SPEC)
_SPEC.loader.exec_module(reference)

CFG = TokenPathConfig(vocab=97, d_model=64, n_heads=4, n_layers=4, n_kv_heads=2, head_dim=16,
                      layer_kinds=("window", "window", "window", "full"), window=8,
                      n_experts=8, top_k=2, d_expert=32)


def reference_params(cfg, params):
    """The token path's parameters in the plain reference's form."""
    def lin(q):
        b = None if q.bias_q is None else torch.from_numpy(q.bias_q)
        return torch.from_numpy(q.weight_q), b, int(q.rescale.quant_scale), int(q.rescale.shift)

    def rs(r):
        return int(r.quant_scale), int(r.shift)

    layers = []
    for lay in params.layers:
        m = lay["moe"]
        layers.append(dict(
            qkv=lin(lay["qkv"]), o=lin(lay["o"]), router=torch.from_numpy(m.router),
            gate=torch.from_numpy(m.gate), up=torch.from_numpy(m.up), down=torch.from_numpy(m.down),
            gate_rs=rs(m.gate_rescale), up_rs=rs(m.up_rescale), down_rs=rs(m.down_rescale),
            router_scale=m.router_scale, h_scale=m.h_scale, silu=torch.from_numpy(m.silu),
        ))
    return dict(embedding=torch.from_numpy(params.embedding), lm_head=torch.from_numpy(params.lm_head),
                lm_scale=params.lm_scale, act_scale=cfg.act_scale, heads=cfg.n_heads,
                kv_heads=cfg.kv_heads, head_dim=cfg.d_head, window=cfg.window,
                kinds=list(cfg.layer_kinds), top_k=cfg.top_k, layers=layers)


@pytest.fixture(scope="module")
def paths():
    params = make_token_params(CFG, seed=5)
    return params, {b: CompiledTokenPath(CFG, params, backend=b, device="cpu", s_granularity=8)
                    for b in ("ref", "cuda")}


@pytest.mark.parametrize("backend", ["ref", "cuda"])
@pytest.mark.parametrize("plen,steps", [(5, 19), (13, 12)], ids=["short-prompt", "prompt-past-window"])
def test_prefill_then_decode_through_the_rings_equals_the_reference(paths, backend, plen, steps):
    """Prefill through the adapter (rings in ring order), then decode past
    several wraps of the 8-row rings: every logit, and every K/V row of the
    full caches and of the rings, equals the reference's full forward."""
    params, tps = paths
    tp = tps[backend]
    ad = CompiledTokenAdapter(tp)
    rng = np.random.default_rng(plen)
    prompt = rng.integers(1, CFG.vocab, plen)
    bucket, max_len = 16, 40
    padded = np.zeros((1, bucket), np.int32)
    padded[0, :plen] = prompt
    cache = ad.init_cache(1, max_len)
    last, pcache = ad.prefill(padded, plen, max_len)
    cache = ad.scatter(cache, 0, pcache)
    seq, got = list(prompt), [last]
    tok = int(last.argmax())
    for i in range(steps):
        seq.append(tok)
        lg, cache = ad.decode(np.array([[tok]], np.int32), np.array([plen + i]), cache)
        got.append(lg[0])
        tok = int(lg[0].argmax())
    want, kv = reference.forward(reference_params(CFG, params), np.array(seq), plen - 1)
    assert torch.equal(torch.stack(got), want)
    n = len(seq)
    rings = 0
    for l, kind in enumerate(CFG.layer_kinds):
        for i, name in enumerate((f"k_cache_{l}", f"v_cache_{l}")):
            if kind == "full":
                assert torch.equal(cache[name][0, :n], kv[l][i])
            else:
                slots, pos = reference.ring_rows(kv[l][i], n, CFG.window)
                assert torch.equal(cache[name][0, slots], kv[l][i][pos])
                rings += 1
    assert rings == 6 and n > 2 * CFG.window
    assert len(torch.unique(want.argmax(dim=1))) > 1  # the logits are informative


def _moe_model(p, d):
    gb = pqir.GraphBuilder("moe")
    gb.add_input("x", "int8", ("N", "S", d))
    y = moe.emit_qmoe(gb, "x", p, "l0_moe")
    gb.add_output(y, "int8", ("N", "S", d))
    return gb.build(opset=17), y


def _tied(p):
    """Experts 1, 4 and 6 share the router column of expert 3: their
    accumulators tie on every token, and the lower id must win."""
    r = p.router.copy()
    r[:, [1, 4, 6]] = r[:, [3]]
    p.router = r
    return p


@pytest.mark.parametrize("case", ["random", "tied"])
@pytest.mark.parametrize("backend", ["ref", "cuda"])
def test_fused_expert_step_equals_the_runtime_on_the_unfused_region(case, backend):
    rng = np.random.default_rng(11)
    d = 64
    p = moe.make_moe_params(rng, d, 32, 8, 3, 0.05)
    if case == "tied":
        p = _tied(p)
    model, y = _moe_model(p, d)
    x = rng.integers(-70, 71, (3, 7, d)).astype(np.int8)
    want = ReferenceRuntime(model).run({"x": x})[y]
    cm = compile_model(model, backend=backend, device="cpu", batch="dynamic",
                       dynamic_axes={"N": None, "S": 4})
    assert cm.stats["fused_qmoe"] == 1
    assert [s.kernel for s in cm.plan.steps] == ["qmoe"]
    got = cm.run({"x": torch.from_numpy(x)})[y]
    assert np.array_equal(got.numpy(), want)
    unfused = compile_model(model, backend=backend, device="cpu", fuse=False)
    assert np.array_equal(unfused.run({"x": torch.from_numpy(x)})[y].numpy(), want)
    assert len(np.unique(want)) > 20
    if case == "tied":  # among tied experts the lower id is chosen first
        step = cm.plan.steps[0]
        wr, _, _, lut, _ = step.consts
        chosen, _ = kqmoe.route_plain(torch.from_numpy(x.reshape(-1, d)), wr, lut,
                                      kqmoe.MoEScalars(**step.params["moe"]))
        c = chosen[:, [1, 3, 4, 6]]
        assert bool((c[:, 1:] <= c[:, :-1]).all())
        assert bool((c[:, 0] & ~c[:, 3]).any())  # a token on which the tie decided


def test_the_expert_region_is_one_region_whatever_the_experts():
    """The region's node count does not grow with E."""
    rng = np.random.default_rng(2)
    sizes = {e: len(_moe_model(moe.make_moe_params(rng, 64, 32, e, 2, 0.05), 64)[0].graph.nodes)
             for e in (4, 8, 64)}
    assert len(set(sizes.values())) == 1


@pytest.mark.parametrize("shift", [1, 3, 7])
def test_ring_order_changes_no_attention_result(shift):
    """qattention's sums are integers: keys (with their mask) in ring order
    give the context of the same keys in position order, bit for bit."""
    rng = np.random.default_rng(shift)
    q = torch.from_numpy(rng.integers(-90, 91, (3, 1, 16)).astype(np.int8))
    k = torch.from_numpy(rng.integers(-90, 91, (3, 8, 16)).astype(np.int8))
    v = torch.from_numpy(rng.integers(-90, 91, (3, 8, 16)).astype(np.int8))
    mask = torch.from_numpy((rng.random((3, 1, 8)) < 0.7).astype(np.float32))
    mask[:, :, 0] = 1.0
    lut = torch.from_numpy(moe.build_exp_lut())
    args = dict(qk_scale=0.01, big=30000.0, lut_scale=0.125, lut=lut, p_scale=127.0, rescale=1 / 127)

    def att(k_, v_, m_):
        return kref.qattention_ref(q, k_, v_, m_, args["qk_scale"], args["big"], args["lut_scale"],
                                   args["lut"], args["p_scale"], args["rescale"], out_dtype=torch.int8)

    rolled = att(torch.roll(k, shift, 1), torch.roll(v, shift, 1), torch.roll(mask, shift, 2))
    assert torch.equal(rolled, att(k, v, mask))
    # and the prefill's rows land in the slots the decode ring reads
    rows = torch.arange(20)[None, :, None].expand(1, 20, 2).to(torch.int8)
    ring = ring_order(rows, torch.tensor([13 + shift]), 8)
    n = 13 + shift
    want = [max(p for p in range(n) if p % 8 == r) for r in range(8)]
    assert ring[0, :, 0].tolist() == want


# -- on the card ---------------------------------------------------------------

@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the qmoe kernels have no CPU mode")
    return torch.device("cuda")


def _card_step(card, tokens, tie):
    """The qmoe kernels against their plain version on the card, at
    Mellum2's expert widths (D 2304, F 896, 64 experts, top-8)."""
    rng = np.random.default_rng(tokens)
    p = moe.make_moe_params(rng, 2304, 896, 64, 8, 0.05)
    if tie:
        p = _tied(p)
    dev = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(card)  # noqa: E731
    wr, gu, wd = kqmoe.prepare(dev(p.router), dev(p.gate), dev(p.up), dev(p.down))
    lut, silu = dev(moe.build_exp_lut()), dev(p.silu)
    s = kqmoe.MoEScalars(top_k=8, router_scale=p.router_scale, lut_scale=0.125, p_scale=127.0,
                         gate=(float(np.float32(p.gate_rescale.quant_scale)), float(p.gate_rescale.quant_shift)),
                         up=(float(np.float32(p.up_rescale.quant_scale)), float(p.up_rescale.quant_shift)),
                         down=(float(np.float32(p.down_rescale.quant_scale)), float(p.down_rescale.quant_shift)),
                         h_scale=p.h_scale, out_rescale=float(np.float32(1 / 127)))
    x = dev(rng.integers(-40, 41, (tokens, 2304)).astype(np.int8))
    before = kqmoe.LAUNCHES["qmoe"]
    got = kqmoe.qmoe(x, wr, gu, wd, lut, silu, s)
    assert kqmoe.LAUNCHES["qmoe"] - before == kqmoe.LAUNCHES_PER_CALL
    return got, kqmoe.qmoe_plain(x, wr, gu, wd, lut, silu, s)


@pytest.mark.card
@pytest.mark.parametrize("tokens,tie", [(64, False), (64, True), (7, False), (700, False)],
                         ids=["decode-bm16", "decode-tied", "ragged", "prefill-bm64"])
def test_qmoe_kernels_on_the_card_equal_the_plain_version(card, tokens, tie):
    got, want = _card_step(card, tokens, tie)
    assert torch.equal(got, want) and len(torch.unique(want)) > 50


@pytest.mark.card
def test_graphed_mellum2_decode_on_the_card_equals_the_reference(card):
    """A small Mellum2 block whose widths the kernels take (D 128, experts of
    64), prefilled and then decoded as CUDA graph replays past two ring wraps,
    against the plain reference on the card."""
    cfg = TokenPathConfig(vocab=211, d_model=128, n_heads=4, n_layers=4, n_kv_heads=2, head_dim=32,
                          layer_kinds=("window", "window", "window", "full"), window=8,
                          n_experts=8, top_k=2, d_expert=64)
    params = make_token_params(cfg, seed=9)
    tp = CompiledTokenPath(cfg, params, backend="cuda", device=card, s_granularity=8)
    ad = CompiledTokenAdapter(tp)
    plen, steps, max_len = 11, 20, 40
    prompt = np.random.default_rng(9).integers(1, cfg.vocab, plen)
    padded = np.zeros((1, 16), np.int32)
    padded[0, :plen] = prompt
    cache = ad.init_cache(1, max_len)
    last, pcache = ad.prefill(padded, plen, max_len)
    cache = ad.scatter(cache, 0, pcache)
    seq, got = list(prompt), [last]
    tok = int(last.argmax())
    for i in range(steps):
        seq.append(tok)
        lg, cache = ad.decode(np.array([[tok]], np.int32), np.array([plen + i]), cache)
        got.append(lg[0])
        tok = int(lg[0].argmax())
    ref = reference_params(cfg, params)
    ref = {k: (v.to(card) if isinstance(v, torch.Tensor) else v) for k, v in ref.items()}
    ref["layers"] = [{k: (v.to(card) if isinstance(v, torch.Tensor) else
                          tuple(t.to(card) if isinstance(t, torch.Tensor) else t for t in v)
                          if isinstance(v, tuple) else v) for k, v in lay.items()} for lay in ref["layers"]]
    want, _ = reference.forward(ref, np.array(seq), plen - 1)
    assert torch.equal(torch.stack(got), want)
    assert tp.graph_stats()["replays"] == steps and tp.graph_stats()["captures"] == 1
