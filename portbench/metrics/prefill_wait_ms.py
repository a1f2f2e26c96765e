"""prefill_wait_ms: The median ``engine.prefill.wait`` span of the program
(``serving/engine.py``): the host's wait, after dispatching a prefill, for
its first token, so the device's work left over when the dispatch ends."""
from harness import readers


def read(ctx):
    return readers.span_median_ms(ctx, "engine.prefill.wait")
