"""Reading the port's own spans, stages and counters
(`repro_torch.tracing`) for the per-layer metrics that read them.

The port is imported inside `program_report`, as `lib/program.py`
imports it, so that the harness's tests import this module without it;
a port without the tracing module (an older commit) reads as no report,
and every reader then returns None.  The pure helpers take a report
(`{name: {"calls", "host_s", "device_s"}}`) and name sets, so they are
tested on hand-made reports.
"""
from __future__ import annotations

from typing import Dict, Iterable, Optional

from portbench.lib.readers import Context


def program_report() -> Optional[Dict[str, Dict]]:
    """The port's table (`tracing.report()`), or None where the port has
    no tracing module."""
    try:
        from repro_torch import tracing
    except ImportError:
        return None
    return tracing.report()


def device_ms_per_iter(report: Dict[str, Dict], names: Iterable[str],
                       iters: int) -> Optional[float]:
    """Device ms per iteration of the spans `names`: the sum of their
    `device_s` over `iters`; None where none of them holds device time."""
    secs = [report[k]["device_s"] for k in names
            if k in report and report[k]["device_s"] is not None]
    if not secs or iters <= 0:
        return None
    return 1e3 * sum(secs) / iters


def host_seconds(report: Dict[str, Dict], names: Iterable[str]
                 ) -> Optional[float]:
    """Host seconds of the stages `names`; None where none was run."""
    secs = [report[k]["host_s"] for k in names if k in report]
    return sum(secs) if secs else None


def _on_device(ctx: Context) -> bool:
    """Whether the run traced a stretch that ran operations on a device:
    a CPU run (another route: flat entries, no groups, no upload, no
    build) reads nothing."""
    return ctx.trace is not None and ctx.trace.launches() > 0


def span_ms(ctx: Context, train: bool, names: Iterable[str]
            ) -> Optional[float]:
    """Device ms per traced iteration of the spans `names`, in cells of
    the mode `train`."""
    if ctx.train != train or not _on_device(ctx):
        return None
    report = program_report()
    if report is None:
        return None
    return device_ms_per_iter(report, names, ctx.trace.iters)


def stage_s(ctx: Context, names: Iterable[str]) -> Optional[float]:
    """Host seconds of the set-up stages `names`."""
    report = program_report() if _on_device(ctx) else None
    return None if report is None else host_seconds(report, names)


def counter(ctx: Context, name: str) -> Optional[int]:
    """A counter of the port; None where it was never counted."""
    report = program_report() if _on_device(ctx) else None
    if report is None or name not in report:
        return None
    return report[name]["calls"]
