"""One run of one cell: set-up, the measured window, the traced stretch,
the check against the reference, and the result line.

The order is fixed: the graph is made on the device and handed to the
port as host arrays, the peak memory counter is reset, the seed's inputs
are drawn, the port prepares and warms up (`setup_s` ends at the start
of the window), the window runs for `seconds`, an optional traced
stretch follows, the peak is read, the program's state is dropped, and
only then does the reference run.
"""
from __future__ import annotations

import gc
import sys
import time
from pathlib import Path
from typing import Dict, List, Tuple

import torch

from portbench.lib import counts, program, spec, trace
from portbench.lib.readers import Context


def device_info(device: torch.device, chips: int) -> Dict:
    if device.type == "cuda":
        return {"platform": "gpu", "kind": torch.cuda.get_device_name(device),
                "count": chips}
    return {"platform": "cpu", "kind": "cpu", "count": 1}


def log(msg: str) -> None:
    print(f"portbench: {msg}", file=sys.stderr, flush=True)


class Clock:
    """Host seconds between laps, kept by name."""

    def __init__(self):
        self.t = time.perf_counter()
        self.laps: Dict[str, float] = {}

    def lap(self, name: str) -> float:
        now = time.perf_counter()
        self.laps[name] = now - self.t
        self.t = now
        return self.laps[name]


def _free(device: torch.device) -> None:
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()


def run(cell_name: str, *, seed: int, seconds: float, traced: bool,
        device: torch.device, t0: float, root: Path = spec.ROOT
        ) -> Tuple[Dict, List[Tuple[str, float, float]]]:
    """(the result line as a dict, the checks as (name, value, limit))."""
    cell = spec.Cell(cell_name, root)
    torch.backends.cuda.matmul.allow_tf32 = False   # the configs are fp32
    torch.backends.cudnn.allow_tf32 = False
    mode = cell.mode().Mode(cell, device)
    clock = Clock()
    program.build_kernels(device)
    clock.lap("build_s")
    mode.make_graph()
    _free(device)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    clock.lap("graph_s")
    inputs = mode.draw(seed)
    clock.lap("inputs_s")
    mode.prepare(inputs)
    prepare_s = clock.lap("prepare_s")
    plan_bytes = mode.plan_bytes()
    mode.bind(inputs)
    clock.lap("warmup_s")
    setup_s = time.perf_counter() - t0

    failed = [0]

    def one():
        if not mode.iterate():
            failed[0] += 1
    n, elapsed = trace.host_window(one, seconds)
    summary = None
    if traced:
        out = root / "build" / "portbench" / f"trace-{cell_name}.json"
        summary = trace.traced(one, int(cell.own["trace_iters"]), device,
                               out)
    peak = (torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else 0)
    outputs = mode.outputs()
    mode.release()
    _free(device)

    clock.lap("window_s")
    ref = mode.reference(inputs)
    readings = mode.compare(inputs, ref, outputs)
    work = mode.work()
    clock.lap("check_s")
    log(f"{cell_name}: seed {seed}, {n} iterations; "
        + ", ".join(f"{k} {v:.3f}" for k, v in {**clock.laps,
                                                 **mode.times}.items()))
    limits = cell.limits()
    checks = [(k, float(readings[k]), float(limits[k])) for k in limits]
    correct = failed[0] == 0 and all(v <= lim for _, v, lim in checks)

    window = mode.window_metrics(n, elapsed)
    window.update({"peak_gib": peak / 2 ** 30, "setup_s": setup_s})
    dev = device_info(device, cell.chips)
    dev["memory_peak_bytes"] = int(peak)
    metrics: Dict[str, Dict] = {}
    if not traced:
        for m in cell.metrics("end_to_end"):
            metrics[m["name"]] = {"value": float(window[m["name"]]),
                                  "unit": m["unit"]}
    else:
        flops, agg_bytes = counts.least_work(mode.ref)
        ctx = Context(train=mode.train, dims=cell.config["dims"], work=work,
                      iter_s=elapsed / n, trace=summary,
                      peaks=counts.load_peaks(dev["kind"]),
                      families=spec.kernel_families(root),
                      prepare_s=prepare_s, plan_bytes=plan_bytes,
                      build_s=clock.laps["build_s"], model_flops=flops,
                      aggregate_bytes=agg_bytes)
        for m in cell.metrics("per_layer"):
            value = spec.load_module("metrics", m["name"], root).read(ctx)
            if value is not None:
                metrics[m["name"]] = {"value": float(value),
                                      "unit": m["unit"]}
        if summary is not None:
            dev["busy_s"] = summary.busy_s
            dev["window_s"] = summary.window_s
    line = {"correct": bool(correct), "attempted": n, "failed": failed[0],
            "metrics": metrics, "device": dev}
    if summary is not None:
        line["breakdown"] = summary.breakdown()
    line["work"] = work
    return line, checks


def card_limit() -> str:
    """The card's name and power limit as `nvidia-smi` prints them, or
    "unknown" where it cannot say."""
    import subprocess
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=60)
    except (OSError, subprocess.TimeoutExpired):
        return "unknown"
    return out.stdout.strip().splitlines()[0] if out.stdout.strip() \
        else "unknown"
