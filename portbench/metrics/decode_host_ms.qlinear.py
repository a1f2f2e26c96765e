"""decode_host_ms.qlinear: The host's time in the decode plan's fused
qmatmul steps (the w4 and w8 projections), per decode step: the program's
``plan.fused_qlinear`` spans summed, over the count of ``engine.decode``
spans, in ms."""
from harness import program_spans


def read(ctx):
    return program_spans.ms_per(ctx, "plan.fused_qlinear", "engine.decode")
