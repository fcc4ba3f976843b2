#!/usr/bin/env python3
"""Where a streamed `tiled` forward, or training step, of the port
spends its time.

    python3 benchmarks/torch/profile_tiled.py [--vertices 65536]
        [--model gcn] [--budget BYTES] [--top 15]
    python3 benchmarks/torch/profile_tiled.py --train a|b [--steps 6]

`--train` profiles a streamed training step as `chip_smoke.py`'s phase
11 runs it: `build_gnn` on uncut pubmed, GCN [128, 64, 3], batch 256,
AdamW, spilled from "blocked" by a 30 MB budget, on the chunk queue (a:
B5 forward, B5^T backward) or with streaming_mode="callback" (b: the
tile-by-tile loop both ways).  It runs the steps, then one more under
`torch.profiler` and one under `cProfile`, and prints the median host
time per step, the device time of the profiled step and its idle share,
as below.

Builds the synthD stand-in as `chip_smoke.py` does (degree-sorted,
GCN-normalised; multi-edges merged for gs_pool), a [50, 64, 16] stack on
"tiled" (or on "blocked" with `--budget`, which spills), runs one warm
forward, then:

* one forward under `torch.profiler` (CPU and CUDA activities): the
  device time is the sum of the self device time of every operation
  (kernels and copies, so copies that overlap compute count twice: the
  idle share printed, 1 - device / wall, is a lower bound);
* one forward under `cProfile`: the host functions with the most own
  time (cProfile adds its cost to every Python call, so read the shares,
  not the absolute times).

Prints the top entries of both and one JSON line with the card's name and
power limit.  Needs a CUDA card.
"""
from __future__ import annotations

import argparse
import cProfile
import json
import pstats
import subprocess
import sys
import time
from pathlib import Path


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--vertices", type=int, default=65536)
    ap.add_argument("--model", default="gcn", choices=("gcn", "gs_pool"))
    ap.add_argument("--budget", type=int, default=None)
    ap.add_argument("--top", type=int, default=15)
    ap.add_argument("--train", choices=("a", "b"), default=None,
                    help="profile phase 11's streamed training run a "
                         "(queue) or b (callback) instead of a forward")
    ap.add_argument("--steps", type=int, default=6)
    args = ap.parse_args()
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("profile_tiled: no CUDA card available", file=sys.stderr)
        return 2
    sys.path.insert(0, str(Path(__file__).resolve().parents[2] / "src"))
    import repro_torch as rt
    from repro_torch.graphs.degree import (apply_vertex_permutation,
                                           degree_sort_permutation,
                                           permute_features)
    from repro_torch.graphs.format import COOGraph
    from repro_torch.graphs.generate import make_dataset, random_features
    from repro_torch.graphs.partition import merge_by_key

    if args.train:
        return profile_training(args)
    g, f, _ = make_dataset("synthD", seed=0, max_vertices=args.vertices)
    perm = degree_sort_permutation(g)
    g = apply_vertex_permutation(g, perm).gcn_normalized()
    if args.model == "gs_pool":
        n = g.num_vertices
        key, val = merge_by_key(g.dst.astype(np.int64) * n + g.src,
                                g.weights())
        g = COOGraph(n, (key % n).astype(np.int32),
                     (key // n).astype(np.int32), val)
    x = torch.from_numpy(permute_features(
        random_features(g.num_vertices, f, seed=1), perm)).cuda()
    backend = "blocked" if args.budget else "tiled"
    layers = rt.make_gnn_stack(args.model, [f, 64, 16], backend=backend)
    for layer in layers:
        layer.cfg.device_budget_bytes = args.budget
    plan = rt.prepare_graph(g, layers[0].cfg)
    ex = plan.carrier["tiled_exec"]

    def forward():
        y = rt.apply_stack(layers, plan, x)
        torch.cuda.synchronize()
        return y

    with torch.inference_mode():
        forward()
        ex.reset_stats()
        t = time.perf_counter()
        forward()
        wall_ms = (time.perf_counter() - t) * 1e3
        steps = ex.stats.steps
        prof_wall_ms, device_ms = _device_profile(forward, args.top)
        top = _host_profile(forward, args.top, "forward")
    print(json.dumps({
        "model": args.model, "backend": plan.backend,
        "streaming": plan.streaming_mode, "vertices": g.num_vertices,
        "steps": steps, "forward_ms": wall_ms,
        "profiled_forward_ms": prof_wall_ms, "device_ms": device_ms,
        "idle_share_lower_bound": 1.0 - device_ms / prof_wall_ms,
        "host_top": top[:5], "card": _smi()}))
    return 0


def _smi() -> str:
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60).stdout.strip()


def _device_profile(run, top_n):
    """One call of `run` under `torch.profiler` (CPU and CUDA): its wall
    time and the sum of every operation's self device time (kernels and
    copies; copies that overlap compute count twice, so 1 - device /
    wall is a lower bound of the idle share).  Prints the top entries."""
    import torch
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t = time.perf_counter()
        run()
        wall_ms = (time.perf_counter() - t) * 1e3
    events = prof.key_averages()

    def dev_us(e):
        return float(getattr(e, "self_device_time_total", None)
                     or getattr(e, "self_cuda_time_total", 0.0))

    device_ms = sum(dev_us(e) for e in events) / 1e3
    print(f"profiler: wall {wall_ms:.1f} ms under the profiler, device "
          f"{device_ms:.1f} ms (sum of self device times)")
    for e in sorted(events, key=dev_us, reverse=True)[:top_n]:
        if dev_us(e) <= 0:
            break
        print(f"  device {dev_us(e) / 1e3:9.2f} ms  {e.count:7d} x  "
              f"{e.key[:90]}")
    return wall_ms, device_ms


def _host_profile(run, top_n, what):
    """One call of `run` under `cProfile`: the host functions with the
    most own time (cProfile adds its cost to every Python call, so read
    the shares, not the absolute times)."""
    prof_c = cProfile.Profile()
    prof_c.enable()
    run()
    prof_c.disable()
    stats = pstats.Stats(prof_c)
    total = stats.total_tt
    rows = sorted(stats.stats.items(), key=lambda kv: kv[1][2],
                  reverse=True)[:top_n]
    print(f"cProfile: {total:.2f} s of own time in one {what}")
    top = []
    for (file, line, name), (_, ncalls, tottime, _, _) in rows:
        label = f"{Path(file).name}:{line} {name}"
        top.append({"fn": label, "calls": ncalls,
                    "own_share": tottime / total})
        print(f"  {100 * tottime / total:5.1f}%  {ncalls:8d} calls  {label}")
    return top


def profile_training(args) -> int:
    """Phase 11's run (a) or (b): `args.steps` steps on the host clock,
    then one step under each profiler."""
    import statistics

    import torch
    from repro_torch.kernels import launch_counts
    from repro_torch.launch.train import build_gnn

    torch.backends.cuda.matmul.allow_tf32 = False
    _, state, data, _, aux = build_gnn(
        model="gcn", dataset="pubmed", backend="blocked", steps=args.steps,
        hidden=64, batch=256, max_vertices=None, max_edges=None,
        device_budget_bytes=30_000_000)
    tr = aux["trainer"]
    for layer in tr.layers:
        layer.cfg.streaming_mode = "auto" if args.train == "a" else "callback"
    plan = tr.rebuild()
    ex = plan.carrier["tiled_exec"]
    box = {"ps": state["params"], "opt": state["opt"], "loss": None}

    def step():
        box["ps"], box["opt"], m = tr.step(box["ps"], box["opt"], next(data))
        box["loss"] = float(m["loss"])             # waits for the step

    times = []
    for _ in range(args.steps):
        t = time.perf_counter()
        step()
        times.append((time.perf_counter() - t) * 1e3)
    ex.reset_stats()
    before = launch_counts()
    prof_wall_ms, device_ms = _device_profile(step, args.top)
    launches = {k: v - before[k] for k, v in launch_counts().items()
                if v > before[k]}
    stats = {k: v for k, v in ex.stats.as_dict().items() if v}
    top = _host_profile(step, args.top, "step")
    print(json.dumps({
        "run": args.train, "backend": plan.backend,
        "streaming": "queue" if args.train == "a" else "callback",
        "tile": plan.meta["tile"], "chunk": plan.meta["chunk"],
        "steps": args.steps, "step_ms": times,
        "median_step_ms": statistics.median(times[1:] or times),
        "profiled_step_ms": prof_wall_ms, "device_ms": device_ms,
        "idle_share_lower_bound": 1.0 - device_ms / prof_wall_ms,
        "launches_in_profiled_step": launches,
        "stats_of_profiled_step": stats, "host_top": top[:5],
        "card": _smi()}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
