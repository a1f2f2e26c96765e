"""mfu.prefill: As ``mfu.decode``: the int8 operations the window's calls need over the
card's peak in the window."""
from harness import readers


def read(ctx):
    return readers.mfu(ctx)
