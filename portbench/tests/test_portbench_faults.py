"""Whole runs of each cell at small sizes on the CPU (the harness's look for
a card skipped): a sound program comes out correct; the timed path broken
underneath, in each way the cell can break, comes out not correct; and the
reference's control fails the limits."""
import numpy as np
import pytest
import torch

from harness import cell
from portbench_tiny import cnn_config, engine_mix, server_mix, token_config

BENCH = cell.load_benchmark()
SEED = 2**31 + 3


def _traffic(workload):
    return "decode-long" if workload == "tokpath-decode" else "prefill-long"


def _token_run(workload="tokpath-decode", **mix):
    return cell.run(BENCH, workload, SEED, 0.6, False, device="cpu", config=token_config(),
                    mix=engine_mix(_traffic(workload), **mix))


def _cnn_run():
    return cell.run(BENCH, "cnn-batch64", SEED, 0.3, False, device="cpu", config=cnn_config(),
                    mix=server_mix())


@pytest.mark.parametrize("workload", ["tokpath-decode", "tokpath-prefill"])
def test_sound_token_runs_are_correct(workload):
    res = _token_run(workload)["result"]
    assert res["correct"] is True
    assert list(res)[-1] == "checks" and set(res["checks"]) == {"token_gap", "kv_rows_wrong"}
    assert res["metrics"]["tokens_per_s"]["value"] > 0 and "setup_s" in res["metrics"]


def test_sound_cnn_run_is_correct():
    res = _cnn_run()["result"]
    assert res["correct"] is True and res["metrics"]["images_per_s"]["value"] > 0


def _limits(workload):
    return cell.load_cell(BENCH, workload).reference.LIMITS


@pytest.mark.parametrize("workload", ["tokpath-decode", "tokpath-prefill", "cnn-batch64"])
def test_the_control_fails_a_limit_and_the_program_none(workload):
    if workload == "cnn-batch64":
        kw = dict(config=cnn_config(), mix=server_mix())
    else:
        kw = dict(config=token_config(), mix=engine_mix(_traffic(workload)))
    limits = _limits(workload)
    for row in cell.calibrate(BENCH, workload, [SEED, SEED + 1, SEED + 2], 0.4, device="cpu",
                              log=lambda line: None, **kw):
        assert all(v <= limits[n] for n, v in row["program"].items())
        assert any(v > limits[n] for n, v in row["control"].items())


def _patch_decode(monkeypatch, fault):
    from repro_torch.serving.token_path import CompiledTokenPath

    real = CompiledTokenPath.decode_step
    calls = {"n": 0}

    def broken(self, tokens, pos, cache):
        before = {k: v.clone() for k, v in cache.items()}  # the plan may update its state in place
        logits, nxt = real(self, tokens, pos, cache)
        calls["n"] += 1
        return fault(logits, nxt, before, calls["n"])

    monkeypatch.setattr(CompiledTokenPath, "decode_step", broken)


def _state_unchanged(logits, nxt, cache, n):
    return logits, cache


def _half_batch(logits, nxt, cache, n):
    half = logits.shape[0] // 2
    out = logits.clone()
    out[half:] = logits[:half]
    return out, nxt


def _token_altered(logits, nxt, cache, n):
    if n != 3:
        return logits, nxt
    out = logits.clone()
    out[0, (int(logits[0].argmax()) + 1) % logits.shape[1]] = float(logits[0].max()) + 1.0
    return out, nxt


@pytest.mark.parametrize("fault", [_state_unchanged, _half_batch, _token_altered],
                         ids=["state-unchanged", "half-batch", "token-altered"])
def test_token_faults_are_caught(monkeypatch, fault):
    _patch_decode(monkeypatch, fault)
    # every finished request judged, so the one altered token is among them
    assert _token_run(check_requests=10_000)["result"]["correct"] is False


def _patch_cnn(monkeypatch, fault):
    from repro_torch.core.compile import CompiledModel

    real = CompiledModel.run

    def broken(self, feeds):
        return {k: fault(v) for k, v in real(self, feeds).items()}

    monkeypatch.setattr(CompiledModel, "run", broken)


def _cnn_half_batch(v):
    out = v.clone()
    half = v.shape[0] // 2
    out[half:2 * half] = v[:half]
    return out


def _cnn_answer_altered(v):
    out = v.clone()
    out[0, 0] = torch.where(v[0, 0] == 127, v[0, 0] - 1, v[0, 0] + 1)
    return out


@pytest.mark.parametrize("fault", [_cnn_half_batch, _cnn_answer_altered], ids=["half-batch", "answer-altered"])
def test_cnn_faults_are_caught(monkeypatch, fault):
    _patch_cnn(monkeypatch, fault)
    assert _cnn_run()["result"]["correct"] is False


def test_traced_token_run_reports_per_layer_metrics_only():
    res = cell.run(BENCH, "tokpath-prefill", SEED, 0.6, True, device="cpu", config=token_config(),
                   mix=engine_mix("prefill-long"))["result"]
    assert res["correct"] is True
    names = set(res["metrics"])
    assert {"decode_dispatch_ms", "prefill_dispatch_ms"} <= names
    assert not names & {"tokens_per_s", "setup_s", "ttft_p90_ms"}
    assert set(res["breakdown"]) == {"device_ops", "idle_gaps"}
    assert res["device"]["window_s"] > 0 and np.isfinite(res["device"]["busy_s"])


@pytest.mark.parametrize("workload,strata", [("tokpath-decode", 2), ("tokpath-prefill", 4)],
                         ids=["primed-together", "staggered"])
def test_setup_prefills_every_bucket_once_before_the_window(monkeypatch, workload, strata):
    """warm() prefills only the buckets that priming will not, and the
    requests come in the seed's order either way: every bucket the mix can
    send is prefilled in set-up, the ones primed by the prime alone."""
    from harness import engine as engine_mod
    from harness import traffic

    mix = engine_mix(_traffic(workload), strata=strata, prompt_tokens=[17, 60])
    c = cell.load_cell(BENCH, workload, token_config(), mix)
    inputs = c.maker.make_inputs(c.config, SEED, "cpu")
    system = c.maker.build(c.config, inputs, "cpu")
    seen = []
    prefill = type(system.adapter).prefill

    def spy(self, padded, plen, max_len):
        seen.append(int(padded.shape[1]))
        return prefill(self, padded, plen, max_len)

    monkeypatch.setattr(type(system.adapter), "prefill", spy)
    loop = cell.make_loop(c, system, SEED, "cpu", lambda: None)
    loop.warm()
    warmed = list(seen)
    loop.prime()
    gen = traffic.EngineTraffic(mix, c.config["vocab_size"], SEED)
    want = [gen.next()[0] for _ in loop.requests]
    assert all(np.array_equal(r.prompt, p) for r, p in zip(loop.requests, want))
    assert set(seen) == set(gen.prefill_buckets())
    assert len(warmed) == len(set(warmed))
    primed = {engine_mod.bucket(len(r.prompt), mix["prefill_bucket"]) for r in loop.requests[: len(loop.clients)]}
    assert not primed & set(warmed)
