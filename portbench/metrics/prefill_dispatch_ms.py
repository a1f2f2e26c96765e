"""prefill_dispatch_ms: The median ``engine.prefill`` span of the program (``serving/engine.py``):
the host's dispatch of one prompt's prefill."""
from harness import readers


def read(ctx):
    return readers.span_median_ms(ctx, "engine.prefill")
