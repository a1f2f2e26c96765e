"""Operations and bytes of the CNN's kernel launches and of the work the
served images need, from the batches the harness drove.

Per batch the program launches one qmatmul per conv, over the im2col rows
(M = images · out side², K = in channels · k², N = out channels), and one
for the head (M = images, K = 512, N = 1000). The max pool after the first
conv and the average pool after the last are the program's generic ops:
they shape the next layer's rows and count no operations. Each launch's bound counts
every input byte read once (the rows, the int8 weights, an int32 bias and a
float32 multiplier per channel) and the int8 output written once, for the
images served (a batch's padding rows are not counted).
"""
from __future__ import annotations

from typing import Dict, Iterable, List, Tuple

from harness.peaks import bound_s


def gemms(cfg) -> List[Tuple[int, int, int]]:
    """(rows per image, K, N) of each layer's matmul."""
    _, side, _ = cfg["input_shape"]
    last = len(cfg["convs"]) - 1
    out = []
    for i, (m, c, k, st, pd) in enumerate(cfg["convs"]):
        side = (side + 2 * pd - k) // st + 1
        out.append((side * side, c * k * k, m))
        for pool in ([cfg["max_pool"]] if i == 0 else []) + ([cfg["avg_pool"]] if i == last else []):
            pk, ps, pp = pool
            side = (side + 2 * pp - pk) // ps + 1
    out.append((1, cfg["convs"][-1][0] * side * side, cfg["classes"]))
    return out


def qmatmul_launch(m: int, k: int, n: int) -> Tuple[float, float]:
    return 2.0 * m * k * n, float(m * k + k * n + 8 * n + m * n)


def account(cfg, calls: Iterable[tuple]) -> Dict:
    launches, bound, ops = 0, 0.0, 0.0
    for call in calls:
        if call[0] != "batch":
            raise ValueError(f"unknown call {call[0]!r}")
        images = int(call[1])
        if images == 0:
            continue
        for rows, k, n in gemms(cfg):
            o, b = qmatmul_launch(images * rows, k, n)
            launches += 1
            bound += bound_s(o, b)
            ops += o
    return {"launches": {"qmatmul": launches}, "bound_s": {"qmatmul": bound}, "ops": ops}
