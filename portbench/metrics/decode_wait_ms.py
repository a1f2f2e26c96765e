"""decode_wait_ms: The median ``engine.decode.wait`` span of the program
(``serving/engine.py``): the host's wait, after dispatching a decode step,
for its next tokens (the argmax's ``.cpu()``), so the device's work left
over when the dispatch ends."""
from harness import readers


def read(ctx):
    return readers.span_median_ms(ctx, "engine.decode.wait")
