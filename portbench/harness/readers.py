"""What the per-layer metric files under ``metrics/`` read.

A reader takes the traced run's context and returns a number or None: None
when it found nothing to read (no span of that name, no launch of that
kernel, or launches the work model does not account for), and the harness
then leaves the metric out of the line. A share of a roofline or of the
peak is never reported as 0 for want of a reading.

The context holds the program's spans of the window (``spans``: name →
seconds each), the profiler's ``timeline``, the work model's account of
the calls the harness drove (``work``), and the program's own launch
counters over the window (``launches``).
"""
from __future__ import annotations

from typing import Optional

from . import peaks, stats

#: Each kernel family, its device kernel's name and the program's counters.
KERNELS = {
    "qmatmul": ("qmatmul_kernel", ("qmatmul", "qmatmul_packed")),
    "qattention": ("qattention_kernel", ("qattention",)),
}


def span_median_ms(ctx, name: str) -> Optional[float]:
    xs = ctx.spans.get(name) or []
    return stats.median(xs) * 1e3 if xs else None


#: The share of a window's launches the profiler may fail to record before a
#: roofline is withheld (a run has seen 1 of 2,880 qmatmul events missing).
TRACE_LOSS = 0.001


def roofline(ctx, kernel: str) -> Optional[float]:
    """The summed bounds of the window's launches of ``kernel`` over their
    summed device time, in %. None unless the work model accounts for
    exactly the launches the program counted, and the trace holds all of
    them but at most ``TRACE_LOSS``; the time of launches the trace lost is
    taken as their mean's."""
    part, counters = KERNELS[kernel]
    want = ctx.work["launches"].get(kernel, 0)
    counted = sum(ctx.launches.get(c, 0) for c in counters)
    seconds, traced = ctx.timeline.kernel_seconds(part)
    if not want or want != counted or not counted * (1 - TRACE_LOSS) <= traced <= counted:
        ctx.notes.append(f"{kernel}: work {want}, counted {counted}, traced {traced} launches")
        return None
    if traced < counted:
        ctx.notes.append(f"{kernel}: the trace lost {counted - traced} of {counted} launches")
        seconds *= counted / traced
    return peaks.roofline_pct(ctx.work["bound_s"][kernel], seconds)


def mfu(ctx) -> Optional[float]:
    return peaks.mfu_pct(ctx.work["ops"], ctx.timeline.window_s)


def idle_pct(ctx) -> Optional[float]:
    tl = ctx.timeline
    if tl.window_s <= 0.0 or not tl.device:
        return None
    return 100.0 * (1.0 - tl.busy_s() / tl.window_s)


def kernels_per_quiet_cycle(ctx) -> Optional[float]:
    """The median number of device kernels in an engine cycle that admitted
    nothing. The cycle ends with the host waiting for its decode step's
    result, so each cycle's kernels run inside its host range."""
    tl = ctx.timeline
    admits = tl.ranges("engine.prefill")
    counts = [tl.kernels_in(a, b) for a, b in tl.ranges("engine.step")
              if not any(a <= pa and pb <= b for pa, pb in admits)]
    counts = [c for c in counts if c]
    return float(stats.median(counts)) if counts else None
