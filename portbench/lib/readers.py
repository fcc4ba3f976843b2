"""What the per-layer metric readers share.  A reader gets a `Context`
and returns a number, or None where its cell has nothing to read (no
trace, no kernel of the family, no peak for the card): it never returns
0 for a share of a roofline or of a peak."""
from __future__ import annotations

from typing import Dict, List, Optional

from portbench.lib import counts
from portbench.lib.trace import TraceSummary


class Context:
    """One run's readings: `train` says whether an iteration is a step;
    `iter_s` is the window's seconds per iteration; `work` the least-work
    counts of the graph, and `model_flops` / `aggregate_bytes` the
    model's arithmetic over them (`counts.least_work`); `trace` the
    traced stretch (None untraced)."""

    def __init__(self, *, train: bool, dims: List[int], work: Dict,
                 iter_s: float, trace: Optional[TraceSummary],
                 peaks: Optional[Dict], families: List[Dict],
                 prepare_s: float, plan_bytes: int, build_s: float,
                 model_flops: counts.Count = counts.model_flops,
                 aggregate_bytes: counts.Count = counts.aggregate_bytes):
        self.train = train
        self.dims = dims
        self.work = work
        self.model_flops = model_flops
        self.aggregate_bytes = aggregate_bytes
        self.iter_s = iter_s
        self.trace = trace
        self.peaks = peaks
        self.families = families
        self.prepare_s = prepare_s
        self.plan_bytes = plan_bytes
        self.build_s = build_s

    def role_seconds(self, role: str) -> float:
        """Device seconds of the traced kernels of every family whose
        `role` is `role`."""
        pats = [p for f in self.families if f.get("role") == role
                for p in f["patterns"]]
        return self.trace.family_seconds(pats) if pats else 0.0


def aggregate_roofline(ctx: Context, train: bool) -> Optional[float]:
    """% of the aggregate kernels' traced time that the least aggregate
    bytes need at the card's peak bandwidth."""
    if ctx.train != train or ctx.trace is None or ctx.peaks is None:
        return None
    spent = ctx.role_seconds("aggregate")
    if spent <= 0:
        return None
    least = (ctx.aggregate_bytes(ctx.dims, ctx.work, train)
             / ctx.peaks["hbm_bytes_per_s"])
    return 100.0 * least * ctx.trace.iters / spent


def mfu(ctx: Context, train: bool) -> Optional[float]:
    """% of the card's float32 peak that the least model FLOPs of one
    iteration take over the window's time per iteration."""
    if ctx.train != train or ctx.peaks is None or ctx.iter_s <= 0:
        return None
    flops = ctx.model_flops(ctx.dims, ctx.work, train)
    return 100.0 * flops / (ctx.iter_s * ctx.peaks["fp32_flops_per_s"])


def launches(ctx: Context, train: bool) -> Optional[float]:
    """Device operations (kernels, copies, fills) per traced iteration."""
    if ctx.train != train or ctx.trace is None or not ctx.trace.launches():
        return None
    return ctx.trace.launches() / ctx.trace.iters


def device_idle(ctx: Context, train: bool) -> Optional[float]:
    """% of the traced window in which no operation ran on the device."""
    if (ctx.train != train or ctx.trace is None or ctx.trace.busy_s <= 0
            or ctx.trace.window_s <= 0):
        return None
    return 100.0 * (1.0 - ctx.trace.busy_s / ctx.trace.window_s)
