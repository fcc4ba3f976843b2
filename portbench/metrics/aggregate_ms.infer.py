"""Device ms per traced forward inside the port's `engn.aggregate`
spans: the layers' aggregate (the padded copy and B2's launches on the
packed route), from the spans' CUDA events (`repro_torch.tracing`)."""
from portbench.lib.spans import span_ms


def read(ctx):
    return span_ms(ctx, False, ["engn.aggregate"])
