#!/usr/bin/env python3
"""Time the packed sum aggregate's backward (B2^T, `kernels/rer_gather_bwd`
`packed_groups_t`) at the shapes of the benchmark's `gcn-reddit.train`
cell, on the card.

    PYTHONPATH=src python3 benchmarks/torch/time_sum_backward.py \
        [--seed 7] [--steps 2] [--reps 3] [--label change] \
        [--piece 2048,4096] [--library]

Sets the cell up as the benchmark does (`portbench`'s train mode: the
R-MAT Reddit graph made on the card, the seed's inputs, the trainer's
packed sum plan and its checked first steps), runs `--steps` more
steps, then takes the arguments of one step's two sum backwards (layer
1 at width 128, layer 2 at 41) from the call the step makes and times
`packed_groups_t` on them with CUDA events (`backward_ms`, min over
`--reps` runs of 3 calls each).  Where the plan holds B2^T's source
table it also prints the table's bytes, its pieces and, from one call
under a profiler, `sum_t.merged_rows` over `sum_t.entries`;
`--piece` times the same calls over tables rebuilt at each listed piece
size.  `--library` checks each result against `torch.sparse.mm(A^T, G)`
over a CSR of the same entries (largest difference over the largest
magnitude) and times that call too.

Put another tree's `src` first on PYTHONPATH to time its backward on
the same cell (the harness comes from this checkout).  Prints one JSON
line with the times, the card's name and its power limit.  Needs a CUDA
card.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
CELL = "gcn-reddit.train"


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--seed", type=int, default=7)
    ap.add_argument("--steps", type=int, default=2)
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--label", default="")
    ap.add_argument("--piece", default="")
    ap.add_argument("--library", action="store_true")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("time_sum_backward: no CUDA card available", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    import repro_torch.kernels.rer_gather_bwd as bwd
    from portbench.lib import program, spec
    from repro_torch import tracing
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

    # the arguments of one step's sum backwards, in the order it calls them
    calls = []
    real = bwd.packed_groups_t

    def spy(groups, g, *, q):
        calls.append((groups, g, q))
        return real(groups, g, q=q)
    bwd.packed_groups_t = spy
    mode.iterate()
    bwd.packed_groups_t = real
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

    def table_row(src) -> dict:
        pieces = src.pieces.cpu()
        return {"table_bytes": sum(a.numel() * a.element_size()
                                   for a in (src.pieces, src.ptr,
                                             src.tiles)),
                "pieces": int(pieces.shape[0]),
                "split_pieces": int(pieces[:, 3].sum()),
                "piece": src.piece, "tiles_max": src.tiles_max,
                "zero": list(src.zero)}

    def merged_share(groups, g, q):
        tracing.reset()
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CPU]):
            ops.packed_groups_t(groups, g, q=q)
        rep = tracing.report()
        tracing.reset()
        if "sum_t.entries" not in rep:
            return None
        merged = rep.get("sum_t.merged_rows", {"calls": 0})["calls"]
        return merged / rep["sum_t.entries"]["calls"]

    pieces = [int(p) for p in args.piece.split(",") if p]
    layers = {}
    for groups, g, q in calls:
        f = g.shape[1]
        row = {"rows": g.shape[0],
               "backward_ms": timed(
                   lambda: ops.packed_groups_t(groups, g, q=q))}
        src = getattr(groups, "source", None)
        if src is not None:
            row.update(table_row(src))
            row["merged_share"] = merged_share(groups, g, q)
            host = [gather_ops.real_counts(gr["rows"], gr["cols"],
                                           gr["vals"]).cpu().numpy()
                    for gr in groups]
            brow = [gr["block_row"].cpu().numpy() for gr in groups]
            bcol = [gr["block_col"].cpu().numpy() for gr in groups]
            for p in pieces:
                groups.source = gather_ops._build_source(
                    host, brow, bcol, src.q, dev, p)
                row[f"piece_{p}"] = {
                    "backward_ms": timed(
                        lambda: ops.packed_groups_t(groups, g, q=q)),
                    "merged_share": merged_share(groups, g, q),
                    **table_row(groups.source)}
            groups.source = src
        if args.library:
            t = g.shape[0] // q
            dst, srcs, val = zip(*(ops.group_entries(gr, t)
                                   for gr in groups))
            keep = torch.cat(val) != 0
            at = torch.sparse_coo_tensor(
                torch.stack([torch.cat(srcs)[keep], torch.cat(dst)[keep]]),
                torch.cat(val)[keep], (g.shape[0], g.shape[0]))
            at = at.coalesce().to_sparse_csr()
            want = torch.sparse.mm(at, g)
            got = ops.packed_groups_t(groups, g, q=q)
            row["rel_err"] = float((got - want).abs().max()
                                   / want.abs().max())
            row["library_ms"] = timed(lambda: torch.sparse.mm(at, g))
            del at, want, got
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
