"""moe_roofline.mellum2: the routed-expert step's share of its roofline over
the window's launches (``kernels/qmoe.py``, the five ``qmoe_*`` kernels of
each step): the summed bounds of ``work/tokpath-mellum2.py`` (the router,
and the weights of the experts the step's rows can reach) over their summed
device time. ``harness/readers.py``'s rule, applied here to the expert
kernels: read only when the work model, the program's ``qmoe`` counter and
the trace agree on the number of launches, the trace losing at most
``readers.TRACE_LOSS`` of them."""
from harness import peaks, readers

PART, COUNTER = "qmoe_", "qmoe"


def read(ctx):
    want = ctx.work["launches"].get(COUNTER, 0)
    counted = ctx.launches.get(COUNTER, 0)
    seconds, traced = ctx.timeline.kernel_seconds(PART)
    if not want or want != counted or not counted * (1 - readers.TRACE_LOSS) <= traced <= counted:
        ctx.notes.append(f"qmoe: work {want}, counted {counted}, traced {traced} launches")
        return None
    if traced < counted:
        ctx.notes.append(f"qmoe: the trace lost {counted - traced} of {counted} launches")
        seconds *= counted / traced
    return peaks.roofline_pct(ctx.work["bound_s"][COUNTER], seconds)
