"""What the readers of the program's host spans share: a family of spans
summed per step of the loop that holds it.

The spans are the program's own (``repro_torch.obs.trace``), recorded on
the host clock over the traced window: ``plan.<kind>`` for each step of an
``ExecutionPlan``, ``xfer.h2d`` for each copy of host memory into a feed.
A program without such spans gives None, and the metric is left out.
"""
from __future__ import annotations

from typing import Optional


def ms_per(ctx, name: str, per: str) -> Optional[float]:
    """The window's ``name`` spans summed, over the count of its ``per``
    spans, in ms; None unless both are there."""
    xs, steps = ctx.spans.get(name), ctx.spans.get(per)
    if not xs or not steps:
        return None
    return sum(xs) / len(steps) * 1e3
