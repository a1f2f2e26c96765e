"""device_idle.cnn: As ``device_idle.tokpath``, for the CNN server."""
from harness import readers


def read(ctx):
    return readers.idle_pct(ctx)
