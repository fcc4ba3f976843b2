"""Device ms per traced step inside the port's `step.forward` span:
the loss through the stack, from the span's CUDA events
(`repro_torch.tracing`)."""
from portbench.lib.spans import span_ms


def read(ctx):
    return span_ms(ctx, True, ["step.forward"])
