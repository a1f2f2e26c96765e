"""device_idle.mellum2: the share of the traced window in which no operation
ran on the card: 1 - the union of device activity over the window."""
from harness import readers


def read(ctx):
    return readers.idle_pct(ctx)
