"""qmatmul_roofline.cnn: qmatmul's share of its roofline over every launch of the window
(``kernels/qmatmul.py``: the convs over im2col rows and the head)."""
from harness import readers


def read(ctx):
    return readers.roofline(ctx, "qmatmul")
