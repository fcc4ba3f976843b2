"""Least model FLOPs of one forward (`lib/counts.py`) over the window's
time per forward, against the card's float32 peak, in %."""
from portbench.lib.readers import mfu


def read(ctx):
    return mfu(ctx, train=False)
