"""The one generator that every traffic mix's data file feeds.

A mix is a JSON object under ``traffic/<name>.json``. Its ``loop`` says
which closed loop serves it (``engine``: a token engine with slots and
clients; ``server``: a batching server with clients). Sizes are drawn so
that every seed gives the same set of sizes in another order: a range
``[lo, hi]`` cut into ``strata`` equal parts gives one size from the middle
of each part, and each block of ``strata`` requests takes them in an order
drawn from the seed. Token ids and pool indices come from the seed too.
"""
from __future__ import annotations

import json
import os
from typing import Dict, List, Sequence

import numpy as np

ENGINE_KEYS = ("loop", "slots", "clients", "max_len", "prefill_bucket", "prompt_tokens",
               "output_tokens", "strata", "prime", "stagger_cycles", "check_requests",
               "trace_seconds")
SERVER_KEYS = ("loop", "max_batch", "clients", "pool", "trace_seconds")


def load(path: str) -> Dict:
    with open(path) as f:
        mix = json.load(f)
    keys = {"engine": ENGINE_KEYS, "server": SERVER_KEYS}.get(mix.get("loop"))
    if keys is None:
        raise ValueError(f"{os.path.basename(path)}: loop must be 'engine' or 'server'")
    missing = [k for k in keys if k not in mix]
    if missing:
        raise ValueError(f"{os.path.basename(path)}: missing keys {missing}")
    return mix


def strata(lo: int, hi: int, n: int) -> List[int]:
    """``n`` sizes from the middles of ``n`` equal parts of ``[lo, hi]``."""
    if not 1 <= lo <= hi or n < 1:
        raise ValueError(f"sizes over [{lo}, {hi}] in {n} strata")
    width = (hi - lo + 1) / n
    return [int(lo + (i + 0.5) * width) for i in range(n)]


class SizeStream:
    """Sizes from :func:`strata`, each block of ``n`` in a seeded order."""

    def __init__(self, lo: int, hi: int, n: int, rng: np.random.Generator) -> None:
        self.values = strata(lo, hi, n)
        self.rng = rng
        self.block: List[int] = []

    def next(self) -> int:
        if not self.block:
            self.block = [self.values[i] for i in self.rng.permutation(len(self.values))]
        return self.block.pop()


def bucket(n: int, multiple: int) -> int:
    return -(-int(n) // multiple) * multiple


class EngineTraffic:
    """Prompts and output budgets for the token engine's closed loop."""

    def __init__(self, mix: Dict, vocab: int, seed: int) -> None:
        self.mix = mix
        self.vocab = int(vocab)
        root = np.random.SeedSequence(int(seed))
        p, o, t = (np.random.default_rng(s) for s in root.spawn(3))
        n = int(mix["strata"])
        self.prompt_len = SizeStream(*mix["prompt_tokens"], n, p)
        self.output_len = SizeStream(*mix["output_tokens"], n, o)
        self.tokens = t
        if self.vocab < 2:
            raise ValueError("the vocabulary must hold a token besides padding")

    def prefill_buckets(self) -> List[int]:
        """Every prefill bucket the mix can send: the cell warms these."""
        b = int(self.mix["prefill_bucket"])
        return sorted({bucket(s, b) for s in self.prompt_len.values})

    def next(self):
        """(prompt as int32 token ids in [1, vocab), output budget)."""
        plen = self.prompt_len.next()
        prompt = self.tokens.integers(1, self.vocab, plen, dtype=np.int64).astype(np.int32)
        return prompt, self.output_len.next()


class ServerTraffic:
    """The order in which clients send the examples of a pool."""

    def __init__(self, mix: Dict, seed: int) -> None:
        self.pool = int(mix["pool"])
        self.rng = np.random.default_rng(np.random.SeedSequence(int(seed)).spawn(1)[0])
        self.block: List[int] = []

    def next(self) -> int:
        if not self.block:
            self.block = list(self.rng.permutation(self.pool))
        return int(self.block.pop())


def check_sample(n_candidates: int, k: int, lengths: Sequence[int], seed: int) -> List[int]:
    """Indices of ``k`` candidates drawn from the seed, the longest always
    among them (all of them when there are no more than ``k``)."""
    if n_candidates <= k:
        return list(range(n_candidates))
    longest = int(np.argmax(lengths))
    rng = np.random.default_rng(np.random.SeedSequence(int(seed)).spawn(2)[1])
    rest = [i for i in rng.permutation(n_candidates) if i != longest][: k - 1]
    return sorted([longest] + [int(i) for i in rest])
