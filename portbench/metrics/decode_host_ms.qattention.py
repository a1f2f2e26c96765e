"""decode_host_ms.qattention: The host's time in the decode plan's fused
attention steps, per decode step: the program's ``plan.fused_qattention``
spans (``backend/plan.py`` ``ExecutionPlan.execute``, one a step, each from
its kernel lookup to its outputs stored) summed, over the count of
``engine.decode`` spans, in ms. The decode cell runs no prefill in its
window, so every plan step there belongs to a decode step."""
from harness import program_spans


def read(ctx):
    return program_spans.ms_per(ctx, "plan.fused_qattention", "engine.decode")
