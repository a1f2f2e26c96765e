"""Operations and bytes of the token path's kernel launches and of the work
the served tokens need, from the shapes the harness drove.

Per layer and call the program launches one qmatmul per projection (qkv and
down on the packed-int4 lane, o and up on the int8 one) and one qattention
per head over all the call's rows. Each launch's bound counts every input
byte read once and every output byte written once, and only what the
served rows need: the rows of the prompt (not its bucket's padding), the
live slots of a decode step, and the keys each query row attends
(positions up to its own, not ``max_len``).

``ops`` is the int8 work the window's calls need: the matmuls, the causal
attention, and the lm_head only at the positions whose logits the engine
uses (the prompt's last, each decode row).
"""
from __future__ import annotations

from typing import Dict, Iterable, Tuple

from harness.peaks import bound_s


def qmatmul_launch(m: int, k: int, n: int, bits: int) -> Tuple[float, float]:
    """(ops, bytes): x (m, k) int8, W (k, n) at ``bits``, an int32 bias and
    two float32 rescale scalars read; (m, n) int8 written."""
    return 2.0 * m * k * n, float(m * k + k * n * bits // 8 + 4 * n + 8 + m * n)


def qattention_launch(q_rows: int, kv_rows: int, pairs: int, dh: int) -> Tuple[float, float]:
    """(ops, bytes) of one head over ``q_rows`` query rows and ``kv_rows``
    distinct key rows, with ``pairs`` (query, key) pairs attended: q, k and v
    int8, the float32 mask at the attended pairs and the 256-byte table
    read; the int8 context written. Q·Kᵀ and P·V: 4·dh per pair."""
    return 4.0 * dh * pairs, float(2 * q_rows * dh + 2 * kv_rows * dh + 4 * pairs + 256)


def projections(cfg) -> Dict[str, Tuple[int, int, int]]:
    d, f = cfg["hidden_size"], cfg["intermediate_size"]
    bits = cfg["assumed"]["bits"]
    return {"qkv": (d, 3 * d, bits["qkv"]), "o": (d, d, bits["o"]),
            "up": (d, f, bits["up"]), "down": (f, d, bits["down"])}


def call_shapes(call) -> Tuple[int, int, int, int]:
    """(query rows, distinct key rows, attended pairs, lm_head rows) of one
    logged call: ``("prefill", plen, bucket)`` or ``("decode", pos, live)``."""
    if call[0] == "prefill":
        plen = int(call[1])
        return plen, plen, plen * (plen + 1) // 2, 1
    if call[0] == "decode":
        pos, live = call[1], call[2]
        keys = int((pos[live] + 1).sum())
        rows = int(live.sum())
        return rows, keys, keys, rows
    raise ValueError(f"unknown call {call[0]!r}")


def account(cfg, calls: Iterable[tuple]) -> Dict:
    """Launches, summed bounds (s) by kernel, and the int8 ops needed."""
    layers, heads = cfg["num_hidden_layers"], cfg["num_attention_heads"]
    d, vocab = cfg["hidden_size"], cfg["vocab_size"]
    dh = d // heads
    launches = {"qmatmul": 0, "qattention": 0}
    bound = {"qmatmul": 0.0, "qattention": 0.0}
    ops = 0.0
    for call in calls:
        rows, kv_rows, pairs, lm_rows = call_shapes(call)
        if rows == 0:
            continue
        for k, n, bits in projections(cfg).values():
            o, b = qmatmul_launch(rows, k, n, bits)
            launches["qmatmul"] += layers
            bound["qmatmul"] += layers * bound_s(o, b)
            ops += layers * o
        o, b = qattention_launch(rows, kv_rows, pairs, dh)
        launches["qattention"] += layers * heads
        bound["qattention"] += layers * heads * bound_s(o, b)
        ops += layers * heads * o + 2.0 * d * vocab * lm_rows
    return {"launches": launches, "bound_s": bound, "ops": ops}
