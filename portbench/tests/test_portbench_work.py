"""Operations and bytes of ``work/`` against hand counts."""
import importlib.util
import json
import os

import numpy as np
import pytest

from harness.peaks import bound_s

PORTBENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _module(kind, name):
    spec = importlib.util.spec_from_file_location(f"pbtest_{kind}_{name.replace('-', '_')}",
                                                  os.path.join(PORTBENCH, kind, f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _config(name):
    with open(os.path.join(PORTBENCH, "configs", f"{name}.json")) as f:
        return json.load(f)


TOK = _module("work", "tokpath-minicpm2b")
CNN = _module("work", "cnn-r18-stages")


def test_qmatmul_launch_at_minicpm_decode():
    # qkv at M = 16: 2·16·2304·6912 ops; x 16·2304, W int4 2304·6912/2, bias 4·6912,
    # two scalars, out 16·6912
    assert TOK.qmatmul_launch(16, 2304, 6912, 4) == (509607936.0, 8137736.0)


def test_qattention_launch():
    # one head, 2 rows attending 6 and 10 keys, dh 32: 4·32·16 ops;
    # q and out 2·2·32, k and v 2·16·32, mask 4·16, table 256
    assert TOK.qattention_launch(2, 16, 16, 32) == (2048.0, 128 + 1024 + 64 + 256)


def test_one_decode_step_by_hand():
    cfg = _config("tokpath-minicpm2b")
    cfg.update(hidden_size=64, num_attention_heads=2, intermediate_size=128, vocab_size=300,
               num_hidden_layers=2)
    step = ("decode", np.array([5, 9, 40]), np.array([True, True, False]))
    acc = TOK.account(cfg, [step])
    # matmuls: 2 rows · 2·(64·192 + 64·64 + 64·128 + 128·64) per layer, 2 layers
    mm = 2 * (2 * 2 * (64 * 192 + 64 * 64 + 64 * 128 + 128 * 64))
    att = 2 * 2 * (4 * 32 * (6 + 10))  # 2 layers x 2 heads, keys up to each row's position
    lm = 2 * 64 * 300 * 2  # the lm_head at the 2 live rows
    assert acc["ops"] == mm + att + lm
    assert acc["launches"] == {"qmatmul": 8, "qattention": 4}
    qkv = bound_s(2 * 2 * 64 * 192, 2 * 64 + 64 * 192 // 2 + 4 * 192 + 8 + 2 * 192)
    o = bound_s(2 * 2 * 64 * 64, 2 * 64 + 64 * 64 + 4 * 64 + 8 + 2 * 64)
    up = bound_s(2 * 2 * 64 * 128, 2 * 64 + 64 * 128 + 4 * 128 + 8 + 2 * 128)
    down = bound_s(2 * 2 * 128 * 64, 2 * 128 + 128 * 64 // 2 + 4 * 64 + 8 + 2 * 64)
    assert acc["bound_s"]["qmatmul"] == pytest.approx(2 * (qkv + o + up + down))
    head = bound_s(4 * 32 * 16, 2 * 2 * 32 + 2 * 16 * 32 + 4 * 16 + 256)
    assert acc["bound_s"]["qattention"] == pytest.approx(4 * head)


def test_one_prefill_by_hand():
    cfg = _config("tokpath-minicpm2b")
    cfg.update(hidden_size=64, num_attention_heads=2, intermediate_size=128, vocab_size=300,
               num_hidden_layers=1)
    acc = TOK.account(cfg, [("prefill", 20, 32)])
    mm = 2 * 20 * (64 * 192 + 64 * 64 + 64 * 128 + 128 * 64)  # the prompt's rows, not the bucket's
    att = 2 * 4 * 32 * (20 * 21 // 2)  # causal pairs
    assert acc["ops"] == mm + att + 2 * 64 * 300
    assert acc["launches"] == {"qmatmul": 4, "qattention": 2}


def test_one_cnn_batch_by_hand():
    cfg = _config("cnn-r18-stages")
    # ResNet-18's stem at 112x112, the max pool to 56x56, conv2_1..conv5_1,
    # the global average pool to 512 values, the 512 -> 1000 head
    assert CNN.gemms(cfg) == [(12544, 147, 64), (3136, 576, 64), (784, 576, 128),
                              (196, 1152, 256), (49, 2304, 512), (1, 512, 1000)]
    per_image = (2 * 12544 * 147 * 64 + 2 * 3136 * 576 * 64 + 2 * 784 * 576 * 128
                 + 2 * 196 * 1152 * 256 + 2 * 49 * 2304 * 512 + 2 * 512 * 1000)
    assert per_image == 815079424
    acc = CNN.account(cfg, [("batch", 64)])
    assert acc["ops"] == 64 * per_image
    assert acc["launches"] == {"qmatmul": 6}
    stem = bound_s(2.0 * 64 * 12544 * 147 * 64, 64 * 12544 * 147 + 147 * 64 + 8 * 64 + 64 * 12544 * 64)
    assert stem <= acc["bound_s"]["qmatmul"]
    assert CNN.account(cfg, [("batch", 0)])["ops"] == 0
