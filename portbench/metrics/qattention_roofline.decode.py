"""qattention_roofline.decode: qattention's share of its roofline over the window's launches
(``kernels/qattention.py``): the summed bounds of ``work/<config>.py``,
which count only the keys each row attends, over the summed device time."""
from harness import readers


def read(ctx):
    return readers.roofline(ctx, "qattention")
