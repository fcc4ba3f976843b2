"""Device operations per traced forward."""
from portbench.lib.readers import launches


def read(ctx):
    return launches(ctx, train=False)
