"""Least model FLOPs of one step (`lib/counts.py`) over the window's
time per step, against the card's float32 peak, in %."""
from portbench.lib.readers import mfu


def read(ctx):
    return mfu(ctx, train=True)
