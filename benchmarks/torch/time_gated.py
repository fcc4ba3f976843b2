#!/usr/bin/env python3
"""Time Gated-GCN's kernels (`kernels/rer_gather_gated`) at the shapes of
the benchmark's `gatedgcn-reddit.train` cell, on the card.

    PYTHONPATH=src python3 benchmarks/torch/time_gated.py \
        [--seed 7] [--steps 1] [--reps 3] [--label change]

Sets the cell up as the benchmark does (`portbench`'s train mode: the
R-MAT Reddit graph made on the card, the seed's inputs, the trainer's
packed plan and its checked first steps), runs `--steps` more steps,
then takes the arguments of one step's gated aggregates (layer 1 at
width 602, layer 2 at 128) and their backwards from the calls the step
makes, and times each kernel on them with CUDA events (min over `--reps`
runs of 3 calls each): the forward, the source walk (dx where that
layer's input takes a gradient, and dpc) and the destination walk
(dph).  Beside each: its bound, the larger of the least bytes of the
walk (12 B an entry, each (N, F) operand read and each output written
once) at the card's 3.35 TB/s and its least operations at its 67
TFLOP/s of fp32 (per entry and feature, the exponential not counted:
the forward 5, the source walk 7 and 2 more for dx, the dph walk 8,
each with the gate's 3 it recomputes), and which of the two binds; the
plain version's time where its (entries, F)
tensors fit the card's free memory (they do not at Reddit's size:
"not measured" with the bytes they need); no library call computes a
gated aggregate.  Prints one JSON line with the times, the card's name
and its power limit.  Needs a CUDA card.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
CELL = "gatedgcn-reddit.train"
HBM = 3.35e12
FP32 = 67e12


def bound(nbytes: float, ops: float) -> tuple:
    """(ms, "bytes" or "operations") of the larger least time."""
    tb, to = 1e3 * nbytes / HBM, 1e3 * ops / FP32
    return (tb, "bytes") if tb >= to else (to, "operations")


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--seed", type=int, default=7)
    ap.add_argument("--steps", type=int, default=1)
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--label", default="")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("time_gated: no CUDA card available", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    from portbench.lib import program, spec
    from repro_torch.kernels.rer_gather_gated import ops
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    program.build_kernels(dev)

    cell = spec.Cell(CELL)
    mode = cell.mode().Mode(cell, dev)
    mode.make_graph()
    inputs = mode.draw(args.seed)
    mode.prepare(inputs)
    mode.bind(inputs)
    for _ in range(args.steps):
        mode.iterate()

    # the arguments of one step's gated forwards and backwards
    fwd, bwd = [], []
    real_f, real_b = ops.gated_forward, ops.gated_backward

    def spy_f(groups, ph, pc, x, *, q):
        fwd.append((groups, ph, pc, x, q))
        return real_f(groups, ph, pc, x, q=q)

    def spy_b(groups, ph, pc, x, g, *, q, need_dx=True, need_dph=True):
        bwd.append((x.shape[1], g, need_dx))
        return real_b(groups, ph, pc, x, g, q=q, need_dx=need_dx,
                      need_dph=need_dph)
    ops.gated_forward, ops.gated_backward = spy_f, spy_b
    mode.iterate()
    ops.gated_forward, ops.gated_backward = real_f, real_b
    torch.cuda.synchronize()
    grads = {f: (g, need_dx) for f, g, need_dx in bwd}

    def timed(fn, n=3) -> float:
        fn()
        torch.cuda.synchronize()
        best = float("inf")
        for _ in range(args.reps):
            start = torch.cuda.Event(enable_timing=True)
            stop = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(n):
                fn()
            stop.record()
            stop.synchronize()
            best = min(best, start.elapsed_time(stop) / n)
        return best

    layers = {}
    for groups, ph, pc, x, q in fwd:
        n, f = x.shape
        g, need_dx = grads[f]
        entries = ops._entries(groups)
        row_b = 4.0 * n * f
        need = 5 * 4.0 * entries * f        # the plain forward's tensors
        free = torch.cuda.mem_get_info(dev)[0]
        ef = float(entries) * f
        row = {
            "rows": n, "entries": entries, "need_dx": need_dx,
            "fwd_ms": timed(lambda: ops.forward_launch(groups, ph, pc, x,
                                                        q)),
            "fwd_bound": bound(12.0 * entries + 4 * row_b, 5 * ef),
            "src_ms": timed(lambda: ops.src_launch(groups, ph, pc, x, g, q,
                                                   need_dx)),
            "src_bound": bound(12.0 * entries + (5 + int(need_dx)) * row_b,
                               (7 + 2 * int(need_dx)) * ef),
            "dph_ms": timed(lambda: ops.dph_launch(groups, ph, pc, x, g,
                                                   q)),
            "dph_bound": bound(12.0 * entries + 5 * row_b, 8 * ef),
            "plain_ms": None, "plain_bytes": need,
            "library_ms": "none: no single call computes a gated sum"}
        if need < 0.8 * free:
            s, d, v = ops._flat(groups, n // q)
            row["plain_ms"] = timed(lambda: ops.gated_flat_plain(
                s, d, v, ph, pc, x, n=n), n=1)
        layers[str(f)] = row
        print(f"{args.label} width {f}: {json.dumps(row)}", flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(json.dumps({"label": args.label, "card": smi, "seed": args.seed,
                      "layers": layers}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
