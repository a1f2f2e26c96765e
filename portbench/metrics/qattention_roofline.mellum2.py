"""qattention_roofline.mellum2: qattention's share of its roofline over the
window's launches (``kernels/qattention.py``): the summed bounds of
``work/tokpath-mellum2.py``, which count only the keys each row attends —
in a window layer the last ``sliding_window`` positions — and each KV
head's rows once for the query heads that share it, over the summed device
time."""
from harness import readers


def read(ctx):
    return readers.roofline(ctx, "qattention")
