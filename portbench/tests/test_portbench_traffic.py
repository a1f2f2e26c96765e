"""The generator is deterministic by seed, and every seed gives the same
set of sizes in another order."""
import glob
import os
from collections import Counter

import numpy as np
import pytest

from harness import traffic

PORTBENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MIXES = sorted(glob.glob(os.path.join(PORTBENCH, "traffic", "*.json")))


@pytest.mark.parametrize("path", MIXES, ids=os.path.basename)
def test_mix_files_load(path):
    mix = traffic.load(path)
    assert mix["loop"] in ("engine", "server")


def test_strata_are_the_middles_of_equal_parts():
    assert traffic.strata(1, 8, 4) == [2, 4, 6, 8]
    vals = traffic.strata(1025, 3072, 16)
    assert vals == sorted(set(vals)) and vals[0] >= 1025 and vals[-1] <= 3072


def _draws(mix, seed, n):
    gen = traffic.EngineTraffic(mix, 1000, seed)
    return [gen.next() for _ in range(n)]


@pytest.mark.parametrize("name", ["decode-long", "prefill-long"])
def test_engine_traffic_is_deterministic_by_seed(name):
    mix = traffic.load(os.path.join(PORTBENCH, "traffic", f"{name}.json"))
    a, b = _draws(mix, 2**31 + 11, 40), _draws(mix, 2**31 + 11, 40)
    assert all(np.array_equal(x[0], y[0]) and x[1] == y[1] for x, y in zip(a, b))
    c = _draws(mix, 2**31 + 12, 40)
    assert any(not np.array_equal(x[0], y[0]) for x, y in zip(a, c))


@pytest.mark.parametrize("name", ["decode-long", "prefill-long"])
def test_every_seed_sends_the_same_sizes(name):
    mix = traffic.load(os.path.join(PORTBENCH, "traffic", f"{name}.json"))
    n = int(mix["strata"])
    sizes = {}
    for seed in (1, 2, 3):
        draws = _draws(mix, seed, 2 * n)
        sizes[seed] = (Counter(len(p) for p, _ in draws), Counter(o for _, o in draws))
        lo, hi = mix["prompt_tokens"]
        assert all(lo <= len(p) <= hi and p.min() >= 1 and p.max() < 1000 for p, _ in draws)
        olo, ohi = mix["output_tokens"]
        assert all(olo <= o <= ohi for _, o in draws)
    assert sizes[1] == sizes[2] == sizes[3]


def test_prefill_buckets_cover_every_prompt():
    mix = traffic.load(os.path.join(PORTBENCH, "traffic", "prefill-long.json"))
    gen = traffic.EngineTraffic(mix, 1000, 5)
    buckets = set(gen.prefill_buckets())
    assert all(traffic.bucket(len(gen.next()[0]), 128) in buckets for _ in range(100))
    assert buckets == set(range(640, 2049, 128))


def test_server_traffic_covers_the_pool_per_block():
    mix = traffic.load(os.path.join(PORTBENCH, "traffic", "batch64-closed.json"))
    a = traffic.ServerTraffic(mix, 7)
    first = [a.next() for _ in range(mix["pool"])]
    assert sorted(first) == list(range(mix["pool"]))
    b = traffic.ServerTraffic(mix, 7)
    assert [b.next() for _ in range(mix["pool"])] == first


def test_check_sample_holds_the_longest():
    lengths = [5, 9, 30, 2, 7, 11]
    pick = traffic.check_sample(6, 3, lengths, seed=4)
    assert len(pick) == 3 and 2 in pick and pick == traffic.check_sample(6, 3, lengths, seed=4)
    assert traffic.check_sample(2, 3, [1, 2], seed=4) == [0, 1]
