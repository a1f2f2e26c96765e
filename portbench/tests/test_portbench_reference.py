"""Each reference against the program at small sizes on the CPU: the same
codes, logits and K/V rows, bit for bit; the control (int4 activations)
differs."""
import numpy as np
import pytest
import torch

from harness import cell
from portbench_tiny import cnn_config, token_config

TOKEN = "tokpath-minicpm2b"
CNN = "cnn-r18-stages"


def _modules(name):
    root = cell.HERE
    return (cell.load_module(f"{root}/configs/{name}.py"),
            cell.load_module(f"{root}/reference/{name}.py"))


@pytest.mark.parametrize("seed", [0, 2**31 + 5, 77])
def test_token_reference_matches_prefill_and_decode(seed):
    maker, ref = _modules(TOKEN)
    cfg = token_config()
    inputs = maker.make_inputs(cfg, seed, "cpu")
    tp = maker.build(cfg, inputs, "cpu").adapter.tp
    rng = np.random.default_rng(seed)
    plen, bucket, max_len, steps = 23, 32, 64, 4
    prompt = rng.integers(1, cfg["vocab_size"], plen)
    padded = np.zeros((1, bucket), np.int32)
    padded[0, :plen] = prompt
    logits, pcache = tp.prefill(padded, torch.tril(torch.ones((bucket, bucket)))[None])
    cache = tp.init_cache(1, max_len)
    for name in cache:
        cache[name][0, :bucket] = pcache[name][0]
    seq = list(prompt)
    step_logits = []
    tok = int(logits[0, plen - 1].argmax())
    for i in range(steps):
        seq.append(tok)
        lg, cache = tp.decode_step(np.array([[tok]], np.int32), np.array([plen + i]), cache)
        step_logits.append(lg[0])
        tok = int(lg[0].argmax())
    want, kv = ref.forward(inputs, np.array(seq), 0)
    assert torch.equal(logits[0, :plen], want[:plen])
    for i, lg in enumerate(step_logits):
        assert torch.equal(lg, want[plen + i])
    n = plen + steps
    for l in range(cfg["num_hidden_layers"]):
        assert torch.equal(cache[f"k_cache_{l}"][0, :n], kv[l, 0])
        assert torch.equal(cache[f"v_cache_{l}"][0, :n], kv[l, 1])
    low, kv_low = ref.forward(inputs, np.array(seq), 0, bits=4)
    assert not torch.equal(kv_low, kv) and not torch.equal(low, want)


@pytest.mark.parametrize("seed", [0, 2**31 + 9])
def test_cnn_reference_matches_the_compiled_model(seed):
    maker, ref = _modules(CNN)
    cfg = cnn_config()
    inputs = maker.make_inputs(cfg, seed, "cpu")
    cm = maker.build(cfg, inputs, "cpu").cm
    imgs = maker.make_examples(cfg, 6, seed, "cpu")
    got = cm.run({"input_q": imgs})[cm.output_names[0]]
    want = ref.forward(cfg, inputs, torch.from_numpy(imgs))
    assert got.dtype == torch.int8 and torch.equal(got, want)
    assert len(torch.unique(want)) > 2
    assert not torch.equal(ref.forward(cfg, inputs, torch.from_numpy(imgs), bits=4), want)


def test_rescale_pair_codifies_the_multiplier():
    from harness import codes

    for m in (1.7e-4, 0.25, 3.0, 0.0123):
        qs, shift = codes.rescale_pair(m)
        assert 2**23 <= qs < 2**24
        assert abs(qs * 2.0**-shift - m) <= m * 2.0**-23
