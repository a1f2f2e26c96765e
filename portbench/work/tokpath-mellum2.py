"""Operations and bytes of the Mellum2 token path's kernel launches and of
the work the served tokens need, from the shapes the harness drove.

Per layer and call the program launches one qmatmul per projection (qkv on
the packed-int4 lane, o on the int8 one), one qattention per query head
over all the call's rows, and one routed-expert step of five launches
(``kernels/qmoe.py``: route, plan, gate|up, down, combine). Each bound
counts every input byte read once and every output byte written once, and
only what the served rows need: the rows of the prompt (not its bucket's
padding), the live slots of a decode step, and the keys each query row
attends — positions up to its own in a full layer, and only the last
``sliding_window`` of them in a window layer. The query heads of a group
share their KV head: its K and V rows count once a group, while each
query head counts its q rows, its mask, the table and its context.

The expert step's bound: the router (``E × D`` int8) and the weights of
``min(E, rows × k)`` experts (gate, up and down, ``3 × D × F`` each) read,
the rows read and written, the routed hidden ``h`` and outputs ``y``
written and read back; its operations are the router's and the ``k``
chosen experts' of each row.

``ops`` is the int8 work the window's calls need: the matmuls, the routed
experts, the attention over the keys each row attends, and the lm_head only
at the positions whose logits the engine uses (the prompt's last, each
decode row).
"""
from __future__ import annotations

from typing import Dict, Iterable, Tuple

from harness.peaks import bound_s

#: Launches of one routed-expert step.
MOE_LAUNCHES = 5


def qmatmul_launch(m: int, k: int, n: int, bits: int) -> Tuple[float, float]:
    """(ops, bytes): x (m, k) int8 and W (k, n) at ``bits`` read, two float32
    rescale scalars; (m, n) int8 written (no bias: attention_bias false)."""
    return 2.0 * m * k * n, float(m * k + k * n * bits // 8 + 8 + m * n)


def qattention_group(q_rows: int, kv_rows: int, pairs: int, dh: int, group: int) -> Tuple[float, float]:
    """(ops, bytes) of one KV head and the ``group`` query heads that read
    it: each query head's q, the float32 mask at the attended pairs and the
    256-byte table read and its int8 context written; the KV head's k and v
    read once."""
    return group * 4.0 * dh * pairs, float(group * (2 * q_rows * dh + 4 * pairs + 256) + 2 * kv_rows * dh)


def moe_step(rows: int, d: int, f: int, e: int, k: int) -> Tuple[float, float]:
    """(ops, bytes) of one routed-expert step over ``rows`` tokens."""
    pairs = rows * k
    ops = 2.0 * rows * d * e + 2.0 * pairs * (d * 2 * f + f * d)
    weights = e * d + min(e, pairs) * 3 * d * f
    moved = rows * d * 2 + 2 * pairs * (f + d) + 512
    return ops, float(weights + moved)


def window_pairs(first: int, last: int, window: int) -> int:
    """Σ over positions p in [first, last] of min(p + 1, window)."""
    if last < first:
        return 0
    full = max(first, window - 1)
    below = sum(p + 1 for p in range(first, min(last, window - 2) + 1))
    return below + max(0, last - full + 1) * window


def call_shapes(call, window: int) -> Tuple[int, int, int, int, int, int]:
    """(query rows, full-layer key rows, full pairs, window key rows, window
    pairs, lm_head rows) of one logged call: ``("prefill", plen, bucket)``
    or ``("decode", pos, live)``."""
    if call[0] == "prefill":
        plen = int(call[1])
        wp = window_pairs(0, plen - 1, window)
        return plen, plen, plen * (plen + 1) // 2, plen, wp, 1
    if call[0] == "decode":
        pos, live = call[1], call[2]
        keys = int((pos[live] + 1).sum())
        wkeys = int(sum(min(int(p) + 1, window) for p in pos[live]))
        rows = int(live.sum())
        return rows, keys, keys, wkeys, wkeys, rows
    raise ValueError(f"unknown call {call[0]!r}")


def account(cfg, calls: Iterable[tuple]) -> Dict:
    """Launches, summed bounds (s) by kernel, and the int8 ops needed."""
    n_layers = cfg["num_hidden_layers"]
    kinds = cfg["layer_types"][:n_layers]
    n_window = sum(1 for t in kinds if t == "sliding_attention")
    n_full = n_layers - n_window
    heads, kv_heads, dh = cfg["num_attention_heads"], cfg["num_key_value_heads"], cfg["head_dim"]
    d, vocab, window = cfg["hidden_size"], cfg["vocab_size"], cfg["sliding_window"]
    qw, kw = heads * dh, kv_heads * dh
    f, e, k = cfg["moe_intermediate_size"], cfg["num_experts"], cfg["num_experts_per_tok"]
    bits = cfg["assumed"]["bits"]
    launches = {"qmatmul": 0, "qattention": 0, "qmoe": 0}
    bound = {"qmatmul": 0.0, "qattention": 0.0, "qmoe": 0.0}
    ops = 0.0
    for call in calls:
        rows, keys, pairs, wkeys, wpairs, lm_rows = call_shapes(call, window)
        if rows == 0:
            continue
        for kk, n, b in ((d, qw + 2 * kw, bits["qkv"]), (qw, d, bits["o"])):
            o, by = qmatmul_launch(rows, kk, n, b)
            launches["qmatmul"] += n_layers
            bound["qmatmul"] += n_layers * bound_s(o, by)
            ops += n_layers * o
        for count, kv_rows, p in ((n_full, keys, pairs), (n_window, wkeys, wpairs)):
            o, by = qattention_group(rows, kv_rows, p, dh, heads // kv_heads)
            launches["qattention"] += count * heads
            bound["qattention"] += count * kv_heads * bound_s(o, by)
            ops += count * kv_heads * o
        o, by = moe_step(rows, d, f, e, k)
        launches["qmoe"] += n_layers * MOE_LAUNCHES
        bound["qmoe"] += n_layers * bound_s(o, by)
        ops += n_layers * o + 2.0 * d * vocab * lm_rows
    return {"launches": launches, "bound_s": bound, "ops": ops}
