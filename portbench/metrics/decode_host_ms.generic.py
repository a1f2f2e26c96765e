"""decode_host_ms.generic: The host's time in the decode plan's generic
steps (the op table of ``backend/generic.py``: casts, slices, the KV update,
the lm_head), per decode step: the program's ``plan.generic`` spans summed,
over the count of ``engine.decode`` spans, in ms."""
from harness import program_spans


def read(ctx):
    return program_spans.ms_per(ctx, "plan.generic", "engine.decode")
