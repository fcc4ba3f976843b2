"""Device ms per traced forward inside the port's `engn.extract` spans:
the layers' feature extraction (X W, or R-GCN's payload), from the
spans' CUDA events (`repro_torch.tracing`)."""
from portbench.lib.spans import span_ms


def read(ctx):
    return span_ms(ctx, False, ["engn.extract"])
