"""serve_compute_ms.cnn: The median ``serve.compute`` span of the program
(``serving/compiled.py``). It ends after the outputs' ``.cpu()``, so it
holds the batch's dispatch and its device time."""
from harness import readers


def read(ctx):
    return readers.span_median_ms(ctx, "serve.compute")
