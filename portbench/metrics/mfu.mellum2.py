"""mfu.mellum2: the int8 operations the window's tokens need (the qkv and o
matmuls, the router and each token's 8 chosen experts only, the attention
over the keys each row attends, the lm_head at the positions whose logits
the engine uses) over what the card's 1,979 TOP/s could do in the window."""
from harness import readers


def read(ctx):
    return readers.mfu(ctx)
