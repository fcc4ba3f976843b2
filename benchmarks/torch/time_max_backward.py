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

  * `count_ms`: the count pass alone (`packed_max_words`, or
    `packed_max_count` where the port has no words);
  * `backward_ms`: the whole max backward as the step runs it
    (`packed_max_backward`, or `packed_max_count` + `packed_max_scatter`);
  * with the three-pass port, the resolve pass and the tie walk alone,
    the rows the resolve pass flagged and the share of the entries that
    lie in them, and a check of its dX against the two-pass entry
    points' (within 1e-5 of the largest magnitude);
  * `weighted_count_ms`, `weighted_backward_ms`: the same two on the
    same groups with every weight halved (no weight 1, as a
    GCN-normalised max plan has), y the forward max over them.

The same script times any port that has `packed_max_count` and
`packed_max_scatter` (a parent commit: put its `src` first on
PYTHONPATH).  Prints one JSON line with the times, the card's name and
its power limit.  Needs a CUDA card.
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
    three = hasattr(bwd, "packed_max_backward")

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
    name = "packed_max_backward" if three else "packed_max_count"
    real = getattr(bwd, name)

    def spy(groups, x, y, *rest, q):
        calls.append((groups, x, y, rest[0] if rest else None, q))
        return real(groups, x, y, *rest, q=q)
    setattr(bwd, name, spy)
    if not three:
        real_scatter = bwd.packed_max_scatter

        def spy_scatter(groups, x, y, g, cnt, *, q):
            calls[-1] = calls[-1][:3] + (g, q)
            return real_scatter(groups, x, y, g, cnt, q=q)
        bwd.packed_max_scatter = spy_scatter
    mode.iterate()
    setattr(bwd, name, real)
    if not three:
        bwd.packed_max_scatter = real_scatter
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
        if three:
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
            got = ops.packed_max_backward(groups, x, y, g, q=q)
            cnt = ops.packed_max_count(groups, x, y, q=q)
            want = ops.packed_max_scatter(groups, x, y, g, cnt, q=q)
            scale = max(1e-30, float(want.abs().max()))
            err = float((got - want).abs().max())
            row["dx_err_vs_two_pass"] = err / scale
            if err > 1e-5 * scale:
                raise SystemExit(f"width {f}: the three passes' dX differs "
                                 f"from the two-pass one by {err}")
        else:
            row["count_ms"] = timed(
                lambda: ops.packed_max_count(groups, x, y, q=q))
            row["backward_ms"] = timed(lambda: ops.packed_max_scatter(
                groups, x, y, g, ops.packed_max_count(groups, x, y, q=q),
                q=q))
        # the same groups with every weight halved: no weight 1
        half = copy.copy(groups)
        for i, gr in enumerate(groups):
            half[i] = dict(gr, vals=gr["vals"] * 0.5)
        half.unit = False
        with torch.no_grad():
            y_half = gather_ops.packed_groups_spmm(half, x, q=q, op="max")
        row["weighted_count_ms"] = timed(
            lambda: ops.packed_max_count(half, x, y_half, q=q))
        if three:
            row["weighted_backward_ms"] = timed(
                lambda: ops.packed_max_backward(half, x, y_half, g, q=q))
        else:
            row["weighted_backward_ms"] = timed(
                lambda: ops.packed_max_scatter(
                    half, x, y_half, g,
                    ops.packed_max_count(half, x, y_half, q=q), q=q))
        layers[str(f)] = row
        print(f"{args.label} width {f}: " + ", ".join(
            f"{k} {v:.4f}" if isinstance(v, float) else f"{k} {v}"
            for k, v in row.items()), flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(json.dumps({"label": args.label, "card": smi, "seed": args.seed,
                      "three_pass": three, "layers": layers}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
