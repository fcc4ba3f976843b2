#!/usr/bin/env python3
"""Time the `chunk_queue` kernel of whichever `repro_torch` is on the path.

    PYTHONPATH=<tree>/src python3 benchmarks/torch/time_chunk_queue.py \
        --label new [--vertices 262144] [--width 50] [--reps 5] \
        [--unchecked]

Builds the synthD stand-in (degree-sorted, GCN-normalised) at
`--vertices`, its TileQueue at T=256 on the card, checks
`tile_queue_aggregate` against
`tile_queue_plain` (`allclose(rtol=1e-4, atol=1e-5)`) without and with
its relu epilogue, then times both with CUDA events, `--reps` times
each ("ms": the sum, "relu_ms": with relu).  `--unchecked` skips the
comparison, to time a variant tree whose kernel computes something else
on purpose (one that gathers no X, say).  Prints one JSON line with the times, the card's
name and its power limit.  Put two source trees on the path in turns
(old, new, new, old) within one call to compare kernel versions; each
tree builds its kernels into its own `build/`.  Needs a CUDA card.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--label", required=True)
    ap.add_argument("--vertices", type=int, default=262144)
    ap.add_argument("--width", type=int, default=50)
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--unchecked", action="store_true")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("time_chunk_queue: no CUDA card available", file=sys.stderr)
        return 2
    from repro_torch.graphs.degree import (apply_vertex_permutation,
                                           degree_sort_permutation)
    from repro_torch.graphs.generate import make_dataset
    from repro_torch.graphs.partition import build_tile_store, pack_tile_store
    from repro_torch.kernels.chunk_queue import ops
    dev = torch.device("cuda")
    g, _, _ = make_dataset("synthD", seed=0, max_vertices=args.vertices)
    g = apply_vertex_permutation(g, degree_sort_permutation(g)).gcn_normalized()
    tq = ops.build_tile_queue(pack_tile_store(build_tile_store(g, 256)),
                              device=dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    x = torch.randn((g.num_vertices, args.width), generator=gen,
                    device=dev) * 0.1
    times = {}
    err = 0.0
    with torch.inference_mode():
        for act in (None, "relu"):
            y = ops.tile_queue_aggregate(tq, x, activation=act)
            want = ops.tile_queue_plain(tq, x, act)
            torch.cuda.synchronize()
            err = max(err, float((y - want).abs().max()))
            if not (args.unchecked
                    or torch.allclose(y, want, rtol=1e-4, atol=1e-5)):
                raise AssertionError(f"kernel disagrees with activation "
                                     f"{act} (max abs err {err})")
            times[act] = []
            for _ in range(args.reps):
                start = torch.cuda.Event(enable_timing=True)
                stop = torch.cuda.Event(enable_timing=True)
                start.record()
                for _ in range(20):
                    ops.tile_queue_aggregate(tq, x, activation=act)
                stop.record()
                stop.synchronize()
                times[act].append(start.elapsed_time(stop) / 20)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    print(json.dumps({"label": args.label, "vertices": g.num_vertices,
                      "entries": tq.entries, "width": args.width,
                      "ms": times[None], "relu_ms": times["relu"],
                      "max_abs_err": err, "card": smi}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
