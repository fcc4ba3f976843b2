"""Share of the traced forwards' window in which the device ran nothing,
in %: 1 - (union of device operations) / (window)."""
from portbench.lib.readers import device_idle


def read(ctx):
    return device_idle(ctx, train=False)
