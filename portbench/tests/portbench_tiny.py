"""Small sizes of the benchmark's configurations and mixes for the CPU
tests: the same files with widths, depth, slots and lengths cut down."""
import json
import os

PORTBENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _load(*parts):
    with open(os.path.join(PORTBENCH, *parts)) as f:
        return json.load(f)


def token_config(layers=2):
    cfg = _load("configs", "tokpath-minicpm2b.json")
    cfg.update(hidden_size=64, num_attention_heads=2, num_key_value_heads=2, intermediate_size=128,
               vocab_size=300, num_hidden_layers=layers)
    return cfg


def engine_mix(traffic="decode-long", **kw):
    mix = _load("traffic", f"{traffic}.json")
    mix.update(slots=2, clients=2, max_len=128, prefill_bucket=16, prompt_tokens=[17, 60],
               output_tokens=[4, 12], strata=4, check_requests=8, trace_seconds=1)
    if mix["prime"] == "staggered":
        mix.update(output_tokens=[3, 3])
    mix.update(kw)
    return mix


def cnn_config():
    cfg = _load("configs", "cnn-r18-stages.json")
    cfg.update(input_shape=[3, 16, 16], convs=[[4, 3, 3, 2, 1], [8, 4, 3, 1, 1]], max_pool=[3, 2, 1],
               avg_pool=[4, 4, 0], classes=10)
    return cfg


def server_mix(**kw):
    mix = _load("traffic", "batch64-closed.json")
    mix.update(max_batch=4, clients=8, pool=12, trace_seconds=1)
    mix.update(kw)
    return mix
