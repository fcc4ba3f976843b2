"""Device operations per traced step."""
from portbench.lib.readers import launches


def read(ctx):
    return launches(ctx, train=True)
