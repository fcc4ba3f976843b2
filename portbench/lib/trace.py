"""Tracing a few timed iterations under `torch.profiler` and summing the
trace: the device's busy time, its operations by name and by kernel
family, and the idle gaps by what the host was doing.

Rewritten from the profiler summing of `benchmarks/torch/profile_tiled.py`
(which summed an operator's kernels twice before it was fixed): here the
device side is read from the exported Chrome trace by category
(`kernel`, `gpu_memcpy`, `gpu_memset`), each operation once, and busy
time is the union of their intervals, so overlapping copies and kernels
are not counted twice.
"""
from __future__ import annotations

import json
import re
import time
from collections import defaultdict
from pathlib import Path
from typing import Callable, Dict, Iterable, List, Optional, Tuple

import torch

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation", "cuda_runtime")
WINDOW = "portbench.window"
ITERATION = "portbench.iteration"
TOP = 10


def union_length(intervals: Iterable[Tuple[float, float]], lo: float,
                 hi: float) -> Tuple[float, List[Tuple[float, float]]]:
    """(length of the union of the intervals clipped to [lo, hi], the
    merged intervals in order)."""
    merged: List[List[float]] = []
    for s, e in sorted(intervals):
        s, e = max(s, lo), min(e, hi)
        if e <= s:
            continue
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return sum(e - s for s, e in merged), [(s, e) for s, e in merged]


def short_name(name: str, width: int = 96) -> str:
    """A kernel's name without its argument list and its anonymous
    namespace, at most `width` long."""
    base = name.replace("(anonymous namespace)::", "").split("(")[0].strip()
    return (base or name)[:width]


class TraceSummary:
    """What one traced stretch of `iters` iterations held: times in
    seconds; `device_ops` as (name, start_s, end_s) within the window."""

    def __init__(self, iters: int, window_s: float, busy_s: float,
                 device_ops: List[Tuple[str, float, float]],
                 gaps: List[Tuple[str, float]]):
        self.iters = iters
        self.window_s = window_s
        self.busy_s = busy_s
        self.device_ops = device_ops
        self.gaps = gaps

    def launches(self) -> int:
        return len(self.device_ops)

    def family_seconds(self, patterns: List[str]) -> float:
        regs = [re.compile(p) for p in patterns]
        return sum(e - s for name, s, e in self.device_ops
                   if any(r.search(name) for r in regs))

    def breakdown(self) -> Dict[str, List[List]]:
        by_name: Dict[str, float] = defaultdict(float)
        for name, s, e in self.device_ops:
            by_name[short_name(name)] += e - s
        gaps: Dict[str, float] = defaultdict(float)
        for label, sec in self.gaps:
            gaps[label] += sec
        top = lambda d: [[k, v] for k, v in sorted(
            d.items(), key=lambda kv: kv[1], reverse=True)[:TOP]]
        return {"device_ops": top(by_name), "idle_gaps": top(gaps)}


def summarise(events: List[Dict], iters: int) -> Optional[TraceSummary]:
    """Reduce a Chrome trace's events to a `TraceSummary`; None where the
    trace holds no window annotation."""
    win = [e for e in events if e.get("name") == WINDOW
           and e.get("cat") == "user_annotation" and e.get("ph") == "X"]
    if not win:
        return None
    lo = float(win[0]["ts"])
    hi = lo + float(win[0]["dur"])
    dev = [(e["name"], float(e["ts"]), float(e["ts"]) + float(e["dur"]))
           for e in events if e.get("ph") == "X"
           and e.get("cat") in DEVICE_CATS
           and float(e["ts"]) < hi and float(e["ts"]) + float(e["dur"]) > lo]
    busy, merged = union_length(((s, e) for _, s, e in dev), lo, hi)
    host = sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"]),
                   e["name"]) for e in events if e.get("ph") == "X"
                  and e.get("cat") in HOST_CATS and e["name"] != WINDOW)
    gaps = []
    edges = [lo] + [x for s, e in merged for x in (s, e)] + [hi]
    for k in range(0, len(edges), 2):
        g0, g1 = edges[k], edges[k + 1]
        if g1 > g0:
            gaps.append((_host_at(host, g0), (g1 - g0) * 1e-6))
    ops = [(name, s * 1e-6, e * 1e-6) for name, s, e in dev]
    return TraceSummary(iters, (hi - lo) * 1e-6, busy * 1e-6, ops, gaps)


def _host_at(host: List[Tuple[float, float, str]], t: float) -> str:
    """The innermost host operation running at time t (the one that began
    last among those that cover t), or "host" where none does."""
    label, best = "host", None
    for s, e, name in host:
        if s > t:
            break
        if e > t and (best is None or s >= best):
            label, best = name, s
    return short_name(label)


def traced(run: Callable[[], None], iters: int, device: torch.device,
           out: Path) -> Optional[TraceSummary]:
    """Run `run` `iters` times under `torch.profiler` (host and, on a card,
    device activity), each iteration in its own annotation inside one
    window annotation; export the Chrome trace to `out` and sum it."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    out.parent.mkdir(parents=True, exist_ok=True)
    with torch.profiler.profile(activities=acts) as prof:
        with torch.profiler.record_function(WINDOW):
            for _ in range(iters):
                with torch.profiler.record_function(ITERATION):
                    run()
    prof.export_chrome_trace(str(out))
    with open(out) as fh:
        data = json.load(fh)
    events = data["traceEvents"] if isinstance(data, dict) else data
    return summarise(events, iters)


def host_window(run: Callable[[], None], seconds: float
                ) -> Tuple[int, float]:
    """Run `run` back to back until `seconds` have passed on the host
    clock; (iterations completed, seconds from the first start to the
    last end).  Each `run` ends in a synchronise or a read of its result,
    so the window covers all of its work."""
    n = 0
    t0 = time.perf_counter()
    while True:
        run()
        n += 1
        elapsed = time.perf_counter() - t0
        if elapsed >= seconds:
            return n, elapsed
