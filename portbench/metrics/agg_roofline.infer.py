"""Least aggregate time of one forward (merged entries at 12 B, each
aggregated row in and out once, at 3.35 TB/s) over the device time the
trace gives the kernels of role "aggregate" (`kernels/*.json`), in %."""
from portbench.lib.readers import aggregate_roofline


def read(ctx):
    return aggregate_roofline(ctx, train=False)
