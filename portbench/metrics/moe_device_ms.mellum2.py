"""moe_device_ms.mellum2: the device time of the routed-expert kernels
(``qmoe_*``, all layers) per decode step: their summed time in the traced
window over the count of the program's ``engine.decode`` spans there (one a
step; the trace holds each as a profiler range too, beside the harness's own
mark of the same name, so its ranges are not counted)."""
PART = "qmoe_"


def read(ctx):
    steps = ctx.spans.get("engine.decode") or []
    seconds, launches = ctx.timeline.kernel_seconds(PART)
    if not steps or not launches:
        return None
    return seconds / len(steps) * 1e3
