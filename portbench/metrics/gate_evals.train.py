"""Gate evaluations per (entry, feature) of one traced step: the port's
counter `gated.gate_evals` (`repro_torch.tracing`, counted from the
plan's tables only while a profiler records: entries x F for each gated
walk) over the traced steps times the sum over layers of merged entries
x F.  A forward and two backward walks that each recompute the gate read
3.0.  None in an inference cell, on the CPU, and where the port counts
no gate (a cell of another model, or a port before the gated kernels)."""
from portbench.lib.spans import counter


def read(ctx):
    if not ctx.train or ctx.trace is None:
        return None
    evals = counter(ctx, "gated.gate_evals")
    per_step = float(ctx.work["entries"]) * sum(ctx.dims[:-1])
    if not evals or per_step <= 0:
        return None
    return evals / (per_step * ctx.trace.iters)
