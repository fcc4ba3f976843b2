"""Least time of one step's gated aggregates and their backwards, the
larger of `reference/gated_gcn.py::gated_bytes` at the card's bandwidth
(3.35 TB/s) and `gated_flops` at its float32 peak (67 TFLOP/s), over the
device time the trace gives the kernels of role "gated"
(`kernels/rer_gather_gated.json`: the forward, the source walk and the
destination walk), in %.  None untraced, in an inference cell, without
a peak for the card, and where no kernel of the role ran (a cell of
another model, or a port before the gated kernels)."""
from portbench.lib import spec


def read(ctx):
    if not ctx.train or ctx.trace is None or ctx.peaks is None:
        return None
    spent = ctx.role_seconds("gated")
    if spent <= 0:
        return None
    ref = spec.load_module("reference", "gated_gcn")
    least = max(ref.gated_bytes(ctx.dims, ctx.work, True)
                / ctx.peaks["hbm_bytes_per_s"],
                ref.gated_flops(ctx.dims, ctx.work, True)
                / ctx.peaks["fp32_flops_per_s"])
    return 100.0 * least * ctx.trace.iters / spent
