"""mfu.cnn: The conv and head operations of the images served in the window over
the card's 1,979 TOP/s in the window."""
from harness import readers


def read(ctx):
    return readers.mfu(ctx)
