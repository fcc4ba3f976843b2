"""Device ms per traced step inside the port's `step.optimizer` span:
the schedule, the clip and AdamW, from the span's CUDA events
(`repro_torch.tracing`)."""
from portbench.lib.spans import span_ms


def read(ctx):
    return span_ms(ctx, True, ["step.optimizer"])
