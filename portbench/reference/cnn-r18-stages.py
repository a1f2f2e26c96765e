"""Plain PyTorch reference of the pre-quantized CNN, and the comparison that
decides ``correct`` for ``cnn-r18-stages``.

It imports nothing of the program. From the harness's codes it computes, op
for op as the artifact states them: each conv as an int8 convolution summed
exactly in float64 (+ int32 bias) → float32 → × the channel's float32
multiplier → ReLU → round half to even → clip to int8; after the first conv
the max of each window (padding never wins); after the last the average of
each window, its integer sum divided by the window's size and truncated
to int8 (which the float32 quotient of such a sum truncates to as well); the flatten; the head as an int8 matmul (+ bias) → float32 →
× multiplier → round → clip.

The comparison judges every answer due in the window against the
reference's codes for its image: the number of answers that differ, limit
0 (the program is exact). The control is this reference with every int8
activation (the image codes and each layer's output codes) rounded to int4
precision: the nearest step below the configuration's int8.
"""
from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np
import torch
import torch.nn.functional as F

#: Images computed together.
BLOCK = 32
LIMITS = {"answers_wrong": 0}


def coarsen(x: torch.Tensor, bits: int) -> torch.Tensor:
    """int8 codes rounded to ``bits``-bit precision (the control)."""
    if bits == 8:
        return x
    step = 2 ** (8 - bits)
    lo, hi = -(2 ** (bits - 1)), 2 ** (bits - 1) - 1
    return (torch.round(x.float() / step).clamp_(lo, hi) * step).to(torch.int8)


def forward(cfg, inputs: Dict, images: torch.Tensor, bits: int = 8) -> torch.Tensor:
    """(n, classes) int8 codes for (n, C, H, W) int8 images."""
    x = coarsen(images, bits)
    last = len(cfg["convs"]) - 1
    for i, (p, spec) in enumerate(zip(inputs["layers"], cfg["convs"] + [None])):
        m = torch.from_numpy(np.asarray(p["multiplier"], np.float32)).to(x.device)
        if p["kind"] == "conv":
            _, _, _, st, pd = spec
            acc = F.conv2d(x.double(), p["w"].double(), stride=st, padding=pd)
            acc = acc + p["b"].double().view(1, -1, 1, 1)
            f = torch.relu(acc.float() * m.view(1, -1, 1, 1))
        else:
            acc = x.flatten(1).double() @ p["w"].double() + p["b"].double()
            f = acc.float() * m
        x = coarsen(torch.round(f).clamp_(-128, 127).to(torch.int8), bits)
        if i == 0:
            k, st, pd = cfg["max_pool"]
            x = F.max_pool2d(x.float(), k, st, pd).to(torch.int8)
        if i == last:
            k, st, pd = cfg["avg_pool"]
            s = F.avg_pool2d(x.double(), k, st, pd, count_include_pad=True, divisor_override=1)
            x = torch.div(s.to(torch.int64), k * k, rounding_mode="trunc").to(torch.int8)
    return x


def compare(cfg, inputs: Dict, served: Dict, control: bool = False) -> List[Tuple[str, float, float]]:
    """Every answer of ``served["answers"]`` (pool index, codes) against the
    reference's codes for ``served["pool"][index]``. With ``control`` the
    int4 reference's codes stand in for the answers."""
    pool, served = served["pool"], served["answers"]
    if not served:
        raise ValueError("no answer to compare")
    dev = inputs["layers"][0]["w"].device
    used = sorted({i for i, _ in served})
    want: Dict[int, np.ndarray] = {}
    low: Dict[int, np.ndarray] = {}
    for s in range(0, len(used), BLOCK):
        idx = used[s:s + BLOCK]
        imgs = torch.from_numpy(pool[idx]).to(dev)
        ref = forward(cfg, inputs, imgs).cpu().numpy()
        want.update(zip(idx, ref))
        if control:
            low.update(zip(idx, forward(cfg, inputs, imgs, bits=4).cpu().numpy()))
    answers = [(i, low[i]) for i, _ in served] if control else served
    wrong = sum(1 for i, got in answers
                if got.shape != want[i].shape or got.dtype != want[i].dtype or not np.array_equal(got, want[i]))
    return [("answers_wrong", wrong, LIMITS["answers_wrong"])]
