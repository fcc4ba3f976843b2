"""% of the destination rows of the port's packed max backwards that
their resolve pass flagged for the tie walk, over the traced steps: the
port's counters `max_bwd.walk_rows` / `max_bwd.rows`
(`repro_torch.tracing`, taken only while a profiler records).  None in
an inference cell, on the CPU, and where the port counts neither (a
cell with no max aggregate, or a port before the three-pass backward)."""
from portbench.lib.spans import counter


def read(ctx):
    if not ctx.train:
        return None
    rows = counter(ctx, "max_bwd.rows")
    walk = counter(ctx, "max_bwd.walk_rows")
    if not rows or walk is None:
        return None
    return 100.0 * walk / rows
