"""The ``mellum2-decode64`` cell through the harness at small sizes on the
CPU (the harness's look for a card skipped): a sound program comes out
correct, a routed expert id altered where the router produces it comes out
not correct, and the reference's int4 control fails the limits; the work
model against hand counts."""
import json
import os

import numpy as np
import pytest
import torch

from harness import cell
from portbench_tiny import engine_mix

BENCH = cell.load_benchmark()
CELL = "mellum2-decode64"
SEED = 2**31 + 7


def mellum2_config():
    with open(os.path.join(cell.HERE, "configs", "tokpath-mellum2.json")) as f:
        cfg = json.load(f)
    cfg.update(hidden_size=64, num_attention_heads=4, num_key_value_heads=2, head_dim=16, num_experts=8,
               num_experts_per_tok=2, moe_intermediate_size=64, sliding_window=8, num_hidden_layers=4,
               vocab_size=300)
    return cfg


def _run(trace=False, **mix):
    return cell.run(BENCH, CELL, SEED, 0.6, trace, device="cpu", config=mellum2_config(),
                    mix=engine_mix("decode-code64", **mix))


def test_sound_run_is_correct():
    res = _run()["result"]
    assert res["correct"] is True
    assert set(res["checks"]) == {"token_gap", "kv_rows_wrong"}
    assert res["metrics"]["tokens_per_s"]["value"] > 0 and "setup_s" in res["metrics"]


def test_traced_run_reports_per_layer_metrics_only():
    res = _run(trace=True)["result"]
    assert res["correct"] is True
    names = {"moe_roofline.mellum2", "moe_device_ms.mellum2", "qattention_roofline.mellum2",
             "mfu.mellum2", "device_idle.mellum2"}
    assert set(res["metrics"]) <= names  # the CPU trace has no device kernel to read


def test_a_routed_expert_altered_where_produced_is_caught(monkeypatch):
    """From the third call on, the first token's last chosen expert is
    swapped for one the router did not choose."""
    from repro_torch.kernels import qmoe

    real = qmoe.route_plain
    calls = {"n": 0}

    def altered(x2, wr, lut, s):
        chosen, pq = real(x2, wr, lut, s)
        calls["n"] += 1
        if calls["n"] >= 3:
            chosen = chosen.clone()
            on, off = chosen[0].nonzero()[-1, 0], (~chosen[0]).nonzero()[0, 0]
            chosen[0, on], chosen[0, off] = False, True
            pq = pq.clone()
            pq[0, off], pq[0, on] = pq[0, on], 0
        return chosen, pq

    monkeypatch.setattr(qmoe, "route_plain", altered)
    assert _run(check_requests=10_000)["result"]["correct"] is False


def test_the_control_fails_a_limit_and_the_program_none():
    limits = cell.load_cell(BENCH, CELL).reference.LIMITS
    rows = cell.calibrate(BENCH, CELL, [SEED, SEED + 1], 0.4, device="cpu", config=mellum2_config(),
                          mix=engine_mix("decode-code64"), log=lambda line: None)
    for row in rows:
        assert all(v <= limits[n] for n, v in row["program"].items())
        assert any(v > limits[n] for n, v in row["control"].items())


def test_the_tiny_mix_wraps_the_rings():
    mix, cfg = engine_mix("decode-code64"), mellum2_config()
    assert mix["prompt_tokens"][0] > cfg["sliding_window"] and cfg["layer_types"][:4].count("full_attention") == 1


def test_one_decode_step_by_hand():
    work = cell.load_module(os.path.join(cell.HERE, "work", "tokpath-mellum2.py"))
    cfg = mellum2_config()
    step = ("decode", np.array([5, 9, 40]), np.array([True, True, False]))
    acc = work.account(cfg, [step])
    assert acc["launches"] == {"qmatmul": 8, "qattention": 16, "qmoe": 20}
    # 3 window layers: rows at 5 and 9 attend 6 and 8 keys; the full layer 6 and 10
    mm = 4 * 2 * 2 * (64 * (64 + 2 * 32) + 64 * 64)
    att = 4 * 16 * (3 * 4 * (6 + 8) + 4 * (6 + 10))
    moe = 4 * (2 * 2 * 64 * 8 + 2 * 4 * (64 * 128 + 64 * 64))
    lm = 2 * 64 * 300 * 2
    assert acc["ops"] == mm + att + moe + lm
    assert work.window_pairs(0, 11, 8) == sum(min(p + 1, 8) for p in range(12))
    assert work.window_pairs(5, 20, 8) == sum(min(p + 1, 8) for p in range(5, 21))


def test_a_kv_head_is_read_once_for_its_group():
    """The attention bound of a decode step: per layer and KV head, the two
    query heads of its group each read their q row, the mask at the pairs
    they attend and the table and write their context; the KV head's K and
    V rows count once."""
    from harness.peaks import bound_s

    work = cell.load_module(os.path.join(cell.HERE, "work", "tokpath-mellum2.py"))
    step = ("decode", np.array([5, 9, 40]), np.array([True, True, False]))
    acc = work.account(mellum2_config(), [step])
    window = bound_s(2 * 4 * 16 * 14, 2 * (2 * 2 * 16 + 4 * 14 + 256) + 2 * 14 * 16)
    full = bound_s(2 * 4 * 16 * 16, 2 * (2 * 2 * 16 + 4 * 16 + 256) + 2 * 16 * 16)
    assert acc["bound_s"]["qattention"] == pytest.approx(2 * (3 * window + full), rel=1e-12)


@pytest.mark.parametrize("n,window", [(5, 8), (8, 8), (21, 8)])
def test_ring_rows_are_the_latest_positions(n, window):
    ref = cell.load_module(os.path.join(cell.HERE, "reference", "tokpath-mellum2.py"))
    slots, pos = ref.ring_rows(torch.zeros(1), n, window)
    assert len(slots) == min(n, window)
    for s, p in zip(slots.tolist(), pos.tolist()):
        assert p % window == s and n - window <= p < n


@pytest.mark.parametrize("tokens", [7, 64, 4608])
def test_the_smoke_bounds_the_expert_step_as_the_work_model_counts_it(tokens):
    """``chip_smoke.py``'s qmoe row and ``moe_roofline.mellum2`` share one
    count of the step's operations and bytes."""
    smoke = cell.load_module(os.path.join(cell.ROOT, "chip_smoke.py"))
    work = cell.load_module(os.path.join(cell.HERE, "work", "tokpath-mellum2.py"))
    ops, nbytes = work.moe_step(tokens, smoke.QMOE_D, smoke.QMOE_F, smoke.QMOE_E, smoke.QMOE_K)
    assert smoke.qmoe_bound(tokens) == (nbytes, ops)
