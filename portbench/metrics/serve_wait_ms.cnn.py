"""serve_wait_ms.cnn: The median ``serve.wait`` span of the program
(``serving/compiled.py``): inside ``serve.compute``, the host's wait for a
batch's outputs to reach it, so the device's work left over when the
dispatch ends."""
from harness import readers


def read(ctx):
    return readers.span_median_ms(ctx, "serve.wait")
