"""mfu.decode: The int8 operations the window's tokens need (matmuls, causal attention,
the lm_head at the positions whose logits the engine uses) over what the
card's 1,979 TOP/s could do in the window."""
from harness import readers


def read(ctx):
    return readers.mfu(ctx)
