"""qmatmul_roofline.prefill: qmatmul's share of its roofline over every launch of the window, both
lanes (``kernels/qmatmul.py``)."""
from harness import readers


def read(ctx):
    return readers.roofline(ctx, "qmatmul")
