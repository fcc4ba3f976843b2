#!/usr/bin/env python3
"""Time the packed max aggregate's backward (`kernels/rer_gather_bwd`) at
the shapes of the benchmark's `gspool-reddit.train` cell, on the card.

    PYTHONPATH=src python3 benchmarks/torch/time_max_backward.py \
        [--seed 7] [--steps 3] [--reps 3] [--label change]

Sets the cell up as the benchmark does (`portbench`'s train mode: the
R-MAT Reddit graph made on the card, the seed's inputs, the trainer's
packed max plan and its checked first steps), runs `--steps` more
steps, then takes the arguments of one step's two max backwards (layer
1 at width 256, layer 2 at 41) from the call the step makes and times,
with CUDA events (min over `--reps` runs of 3 calls each):

  * `count_ms`: the count pass alone (`packed_max_words`);
  * `backward_ms`: the whole max backward as the step runs it
    (`packed_max_backward`);
  * the resolve pass and the tie walk alone, the rows the resolve pass
    flagged and the share of the entries that lie in them;
  * `weighted_count_ms`, `weighted_backward_ms`, `weighted_walk_rows`:
    the same on the same groups with every weight halved (no weight 1,
    as a GCN-normalised max plan has), y the forward max over them.

The same script times a port that still chose a two-pass backward for
plans with no weight 1 (`PlanGroups.unit`; put its `src` first on
PYTHONPATH): the halved groups then take that route.  Prints one JSON
line with the times, the card's name and its power limit.  Needs a CUDA
card.
"""
from __future__ import annotations

import argparse
import copy
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
CELL = "gspool-reddit.train"


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--seed", type=int, default=7)
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--label", default="")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("time_max_backward: no CUDA card available", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    import repro_torch.kernels.rer_gather_bwd as bwd
    from portbench.lib import program, spec
    from repro_torch.kernels.rer_gather import ops as gather_ops
    from repro_torch.kernels.rer_gather_bwd import ops
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

    # the arguments of one step's max backwards, in the order it calls them
    calls = []
    real = bwd.packed_max_backward

    def spy(groups, x, y, g, *, q):
        calls.append((groups, x, y, g, q))
        return real(groups, x, y, g, q=q)
    bwd.packed_max_backward = spy
    mode.iterate()
    bwd.packed_max_backward = real
    torch.cuda.synchronize()

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
    for groups, x, y, g, q in calls:
        f = x.shape[1]
        row = {"rows": x.shape[0]}
        row["count_ms"] = timed(
            lambda: ops.packed_max_words(groups, x, y, q=q))
        row["backward_ms"] = timed(
            lambda: ops.packed_max_backward(groups, x, y, g, q=q))
        words = ops.packed_max_words(groups, x, y, q=q)
        dx = torch.empty_like(g)
        _, flag = ops.packed_max_resolve(words, g, dx=dx)
        row["resolve_ms"] = timed(
            lambda: ops.packed_max_resolve(words, g, dx=dx))
        row["walk_ms"] = timed(lambda: ops.scatter_launch(
            groups, g, q, x, y, words, flag, dx))
        entries = torch.zeros(g.shape[0], dtype=torch.int64, device=dev)
        t = x.shape[0] // q
        for gr in groups:
            dst, _, v = ops.group_entries(gr, t)
            entries.index_add_(0, dst, (v != 0).long())
        row["walk_rows"] = int(flag.sum())
        row["walk_row_share"] = row["walk_rows"] / g.shape[0]
        row["walk_entry_share"] = (int(entries[flag != 0].sum())
                                   / int(entries.sum()))
        row["lone_share"] = float((words < 0).sum()) / float(
            (words != 0).sum())
        # the same groups with every weight halved: no weight 1; the
        # kernels read the weights through the work table's pointers, so
        # the halved groups get a table of their own
        half = copy.copy(groups)
        for i, gr in enumerate(groups):
            half[i] = dict(gr, vals=gr["vals"] * 0.5)
        half.work = gather_ops.groups_work(list(half), q, x.shape[0] // q,
                                           x.device)
        if hasattr(half, "unit"):
            half.unit = False
        with torch.no_grad():
            y_half = gather_ops.packed_groups_spmm(half, x, q=q, op="max")
        row["weighted_count_ms"] = timed(
            lambda: ops.packed_max_words(half, x, y_half, q=q))
        row["weighted_backward_ms"] = timed(
            lambda: ops.packed_max_backward(half, x, y_half, g, q=q))
        words = ops.packed_max_words(half, x, y_half, q=q)
        row["weighted_walk_rows"] = int(((words > 0) & (g != 0))
                                        .any(dim=1).sum())
        layers[str(f)] = row
        print(f"{args.label} width {f}: " + ", ".join(
            f"{k} {v:.4f}" if isinstance(v, float) else f"{k} {v}"
            for k, v in row.items()), flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(json.dumps({"label": args.label, "card": smi, "seed": args.seed,
                      "layers": layers}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
