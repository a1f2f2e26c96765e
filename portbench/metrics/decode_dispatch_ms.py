"""decode_dispatch_ms: The median ``engine.decode`` span of the program (``serving/engine.py``).
The span ends when the adapter returns, before the device has finished:
it is the host's dispatch of one decode step."""
from harness import readers


def read(ctx):
    return readers.span_median_ms(ctx, "engine.decode")
