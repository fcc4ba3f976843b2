"""Device ms per traced step inside the port's `engn.aggregate_bwd` span:
the packed aggregate's backward over the plan's bucket groups (the sum's
B2 transposed scatter; the max's winner count and scatter), from the
span's CUDA events (`repro_torch.tracing`)."""
from portbench.lib.spans import span_ms


def read(ctx):
    return span_ms(ctx, True, ["engn.aggregate_bwd"])
