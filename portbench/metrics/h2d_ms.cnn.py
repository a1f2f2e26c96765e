"""h2d_ms.cnn: The host's time copying a batch into the device, per batch:
the program's ``xfer.h2d`` spans (``core/compile.py``, a pageable copy of
the stacked images, which waits for the copy to end) summed, over the count
of ``serve.step`` spans, in ms."""
from harness import program_spans


def read(ctx):
    return program_spans.ms_per(ctx, "xfer.h2d", "serve.step")
