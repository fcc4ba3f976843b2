"""Device ms per traced forward inside the port's `engn.update` spans:
the layers' update (ReLU; R-GCN's self term), from the spans' CUDA
events (`repro_torch.tracing`)."""
from portbench.lib.spans import span_ms


def read(ctx):
    return span_ms(ctx, False, ["engn.update"])
