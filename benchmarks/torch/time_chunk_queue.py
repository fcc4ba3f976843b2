#!/usr/bin/env python3
"""Time the `chunk_queue` kernel of whichever `repro_torch` is on the path.

    PYTHONPATH=<tree>/src python3 benchmarks/torch/time_chunk_queue.py \
        --label new [--vertices 262144] [--width 50] [--reps 5] \
        [--unchecked] [--transpose [--dataset pubmed] [--widths 64,3] \
        [--piece 256,800] [--profile]]

Builds the synthD stand-in (degree-sorted, GCN-normalised) at
`--vertices`, its TileQueue at T=256 on the card, checks
`tile_queue_aggregate` against
`tile_queue_plain` (`allclose(rtol=1e-4, atol=1e-5)`) without and with
its relu epilogue, then times both with CUDA events, `--reps` times
each ("ms": the sum, "relu_ms": with relu).  `--unchecked` skips the
comparison, to time a variant tree whose kernel computes something else
on purpose (one that gathers no X, say).

`--transpose` times B5^T (`tile_queue_t`, dX = A^T G over the forward
queue) instead, one call per width of `--widths` per timed call, beside
`torch.sparse.mm(A^T, G)` on the same G, after checking it against
`tile_queue_t_plain` (within 1e-5 of the plain output's largest
magnitude, rtol 1e-5).  `--dataset pubmed` takes uncut pubmed as
`build_gnn` makes it (GCN-normalised, not degree-sorted: the queue of
`chip_smoke.py`'s streamed run (a), 105,448 entries, widths 64 and 3).
`--piece` rebuilds B5^T's source table (`queue_src_work`) at each of
the listed piece sizes instead of `source_piece`'s, one JSON line each;
`--profile` adds the device time of each operation per timed call under
`torch.profiler`; "host_us" is the host time of one call (its enqueue,
no synchronise), beside the library call's.  On a tree with the source
table, each line also counts, on the host, what the split pieces merge
into scratch over `--widths`: "merge_floats" (each split piece's
distinct source columns times F) and "merge_ops" (those as the kernel's
vector reds: float4 where F is a multiple of 4, else float2 where even).

Prints one JSON line per queue with the times, the card's name and its
power limit.  Put two source trees on the path in turns (old, new, new,
old) within one call to compare kernel versions; each tree builds its
kernels into its own `build/`.  Needs a CUDA card.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import subprocess
import sys
import time
import warnings


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--label", required=True)
    ap.add_argument("--vertices", type=int, default=262144)
    ap.add_argument("--width", type=int, default=50)
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--unchecked", action="store_true")
    ap.add_argument("--transpose", action="store_true")
    ap.add_argument("--dataset", choices=("synthD", "pubmed"),
                    default="synthD")
    ap.add_argument("--widths", default=None,
                    help="B5^T's widths, comma-separated (default "
                         "--width)")
    ap.add_argument("--piece", default="",
                    help="B5^T piece sizes to build the queue with")
    ap.add_argument("--profile", action="store_true")
    args = ap.parse_args()
    import numpy as np
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
    if args.dataset == "pubmed":
        g = make_dataset("pubmed", max_vertices=None,
                         max_edges=None)[0].gcn_normalized()
    else:
        g, _, _ = make_dataset("synthD", seed=0, max_vertices=args.vertices)
        g = apply_vertex_permutation(
            g, degree_sort_permutation(g)).gcn_normalized()
    packed = pack_tile_store(build_tile_store(g, 256))
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    gen = torch.Generator(device=dev).manual_seed(0)

    def events_ms(fn):
        out = []
        for _ in range(args.reps):
            start = torch.cuda.Event(enable_timing=True)
            stop = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(20):
                fn()
            stop.record()
            stop.synchronize()
            out.append(start.elapsed_time(stop) / 20)
        return out

    def host_us(fn, calls):
        """Host time per call of fn's call form (its enqueue: no
        synchronise inside the timed loop)."""
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(100):
            fn()
        dt = time.perf_counter() - t0
        torch.cuda.synchronize()
        return dt / 100 / calls * 1e6

    def device_ms(fn):
        """Device time per call of fn under torch.profiler: the total and
        each device operation's (kernels by name, memsets)."""
        from torch.profiler import ProfilerActivity, profile
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(10):
                fn()
            torch.cuda.synchronize()
        by_name = {}
        for ev in prof.key_averages():
            if str(ev.device_type).endswith("CUDA"):
                key = ev.key[:24] + ev.key[-24:]
                by_name[key] = by_name.get(key, 0.0) + getattr(
                    ev, "self_device_time_total",
                    getattr(ev, "self_cuda_time_total", 0.0)) / 10 / 1e3
        return sum(by_name.values()), by_name

    if not args.transpose:
        tq = ops.build_tile_queue(packed, device=dev)
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
                times[act] = events_ms(
                    lambda act=act: ops.tile_queue_aggregate(
                        tq, x, activation=act))
        print(json.dumps({"label": args.label, "vertices": g.num_vertices,
                          "entries": tq.entries, "width": args.width,
                          "ms": times[None], "relu_ms": times["relu"],
                          "max_abs_err": err, "card": smi}))
        return 0

    widths = [int(w) for w in (args.widths or str(args.width)).split(",")]
    gs = [torch.randn((g.num_vertices, w), generator=gen, device=dev) * 0.1
          for w in widths]
    # A^T: rows are the sources
    idx = torch.from_numpy(np.stack([g.src, g.dst]).astype(np.int64))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)   # "beta" notice
        a_t = torch.sparse_coo_tensor(
            idx, torch.from_numpy(g.weights()),
            (g.num_vertices, g.num_vertices)).coalesce().to_sparse_csr().to(
                dev)
    pieces = [int(p) for p in args.piece.split(",") if p] or [None]

    def with_piece(tq, piece):
        """tq with B5^T's table rebuilt at `piece` entries a piece."""
        built = ops.queue_src_work(tq.tile_ptr.cpu().numpy(),
                                   tq.tile_src.cpu().numpy(),
                                   tq.entry_ptr.cpu().numpy(), piece)
        names = ("tpieces", "tsrc_ptr", "tsrc_tiles", "tile_dst")
        return dataclasses.replace(
            tq, **{k: torch.from_numpy(a).to(dev)
                   for k, a in zip(names, built)},
            t_split=built[4], t_piece=piece)

    def merges(tq):
        """(floats, vector reds) the split pieces merge over `widths`."""
        if not hasattr(tq, "tpieces"):
            return None, None
        tp, st = tq.tpieces.cpu().numpy(), tq.tsrc_tiles.cpu().numpy()
        ep, cols = tq.entry_ptr.cpu().numpy(), tq.cols.cpu().numpy()
        # the forward queue's entries in source order
        order = np.concatenate([np.arange(ep[k], ep[k + 1]) for k in st]
                               + [np.zeros(0, np.int64)])
        merged = sum(np.unique(cols[order[lo:hi]]).size
                     for _, lo, hi, slot, *_ in tp if slot >= 0)
        return merged * sum(widths), sum(
            merged * (w // 4 if w % 4 == 0 else w // 2 if w % 2 == 0
                      else w) for w in widths)
    with torch.inference_mode():
        lib = events_ms(lambda: [torch.sparse.mm(a_t, gg) for gg in gs])
        lib_dev = (device_ms(lambda: [torch.sparse.mm(a_t, gg)
                                      for gg in gs])[0]
                   if args.profile else None)
        lib_host = host_us(lambda: [torch.sparse.mm(a_t, gg) for gg in gs],
                           len(gs))
        for piece in pieces:
            tq = ops.build_tile_queue(packed, device=dev)
            if piece is not None:
                tq = with_piece(tq, piece)
            err = 0.0
            for gg in gs:
                got = ops.tile_queue_t(tq, gg)
                want = ops.tile_queue_t_plain(tq, gg)
                torch.cuda.synchronize()
                err = max(err, float((got - want).abs().max()))
                scale = max(1.0, float(want.abs().max()))
                if not (args.unchecked or torch.allclose(
                        got, want, rtol=1e-5, atol=1e-5 * scale)):
                    raise AssertionError(f"B5^T disagrees at width "
                                         f"{gg.shape[1]} (max abs err {err})")
            fn = (lambda tq=tq: [ops.tile_queue_t(tq, gg) for gg in gs])
            merge_floats, merge_ops = merges(tq)
            out = {"label": args.label, "dataset": args.dataset,
                   "vertices": g.num_vertices, "entries": tq.entries,
                   "tiles": packed.nnzb, "widths": widths,
                   "piece": getattr(tq, "t_piece", None),
                   "pieces": (tq.tpieces.shape[0] if hasattr(tq, "tpieces")
                              else tq.pieces.shape[0]),
                   "split": getattr(tq, "t_split", tq.n_split),
                   "merge_floats": merge_floats, "merge_ops": merge_ops,
                   "ms": events_ms(fn), "library_ms": lib,
                   "host_us": host_us(fn, len(gs)),
                   "library_host_us": lib_host,
                   "max_abs_err": err, "card": smi}
            if args.profile:
                out["device_ms"], out["device_ops_ms"] = device_ms(fn)
                out["library_device_ms"] = lib_dev
            print(json.dumps(out))
            del tq
    return 0


if __name__ == "__main__":
    sys.exit(main())
