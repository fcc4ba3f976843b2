#!/usr/bin/env python3
"""Time the `rer_spmm`, `rer_gather`, `fused_engn`, `rer_spmm_bwd` and
`rer_gather_bwd` kernels of whichever `repro_torch` is on the path, at
the shapes `chip_smoke.py` times them.

    PYTHONPATH=<tree>/src python3 benchmarks/torch/time_rer_kernels.py \
        --label new [--reps 3] [--only ROW,...] [--profile]

Rows (CUDA events, 10 calls per rep after a warm call, `--reps` reps;
both widths together and each alone):

- `rer_spmm_{sum,max}`: degree-sorted pubmed on dense T=256 tiles,
  widths 64 and 3, one call each;
- `rer_spmm_sum_t`: the sum backward dX = A^T G at the training graph's
  dense tiles (uncut pubmed as `build_gnn` makes it), widths 64 and 3;
- `rer_gather_{sum,max}`: the whole aggregate of the packed plan's
  bucket groups (`packed_groups_spmm`), widths 64 and 3;
- `rer_gather_sum_t`: the sum backward of the training plan's bucket
  groups, widths 64 and 3;
- `rer_gather_bwd_count`, `rer_gather_bwd_max`: the packed max
  backward's winner words (`packed_max_words`) and whole backward
  (`packed_max_backward`, against the plain count and scatter) at the
  training plan's groups, widths 64 and 3 (relu features, so maxima
  tie);
- `rer_gather_tile_part_sum`: the tile-part form on the first 32
  column chunks (C=8, F=50) and 64 row tiles (C=1, F=16) of synthD at
  65,536 vertices;
- `fused_engn_sum`: degree-sorted cora on dense T=256 tiles, the
  quickstart's two layers (1433 -> 64, 64 -> 7), one call each;
- `fused_engn_sum_train`: the training graph's dense tiles, widths
  128 -> 64 and 64 -> 3;
- `rer_spmm_bwd_max`: the max backward at the training shapes, widths
  64 and 3 (relu features, so maxima tie).

Each row is checked against its plain version first.  Prints one JSON
line with the times, the card's name and its power limit.  Put two
source trees on the path in turns (old, new, new, old) within one call
to compare kernel versions: each builds its kernels into its own
`build/`.  Trees back to 7d3f40b run every row, except that the two
packed max rows need `packed_max_words` after that commit (`--only`
leaves them out); the four backward rows redesigned after it take that
commit's call forms too (the sums over
the carriers of A^T the plan built, `transposed=` on every
differentiable call, the packed max backward one launch per group, its
gradient over the transposed groups): what an old tree builds for A^T
is built before the timing, as its plan built it once.  Needs a CUDA
card.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys

WIDTHS = (64, 3)              # the aggregate widths of the two layers


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--label", required=True)
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--only", default="",
                    help="comma-separated row names to time (default all)")
    ap.add_argument("--profile", action="store_true",
                    help="also sum each row's kernel time on the device "
                         "under torch.profiler (ms per call of the row)")
    args = ap.parse_args()
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("time_rer_kernels: no CUDA card available", file=sys.stderr)
        return 2
    import repro_torch as rt
    from repro_torch.core import engn as engn_mod
    from repro_torch.graphs.degree import (apply_vertex_permutation,
                                           degree_sort_permutation)
    from repro_torch.graphs.format import COOGraph
    from repro_torch.graphs.generate import make_dataset
    from repro_torch.kernels.fused_engn import ops as fused_ops
    from repro_torch.graphs.partition import (build_tile_store,
                                              chunk_tile_row, merge_by_key,
                                              pack_tile_store)
    from repro_torch.kernels.rer_gather import ops as gather_ops
    from repro_torch.kernels.rer_spmm import ops as spmm_ops
    from repro_torch.kernels.rer_spmm_bwd import ops as bwd_ops

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)

    def feats(rows, width):
        return torch.randn((rows, width), generator=gen, device=dev) * 0.1

    def merged(g):
        n = g.num_vertices
        key, val = merge_by_key(g.dst.astype(np.int64) * n + g.src,
                                g.weights())
        return COOGraph(n, (key % n).astype(np.int32),
                        (key // n).astype(np.int32), val)

    def timed(fn):
        fn()
        torch.cuda.synchronize()
        out = []
        for _ in range(args.reps):
            start = torch.cuda.Event(enable_timing=True)
            stop = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(10):
                fn()
            stop.record()
            stop.synchronize()
            out.append(start.elapsed_time(stop) / 10)
        return out

    def device_ms(fn):
        """Kernel time on the device per call of fn, under
        torch.profiler: the host's share is what CUDA events add."""
        from torch.profiler import ProfilerActivity, profile
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(10):
                fn()
            torch.cuda.synchronize()
        total = 0.0
        for ev in prof.key_averages():
            if str(ev.device_type).endswith("CUDA"):
                total += getattr(ev, "self_device_time_total",
                                 getattr(ev, "self_cuda_time_total", 0.0))
        return total / 10 / 1e3

    only = [r for r in args.only.split(",") if r]

    def checked(name, kern, plain, exact, widths=None):
        """Check each call against its plain version, then time all the
        calls together and, given `widths`, each call alone."""
        if only and name not in only:
            return None
        for k, p in zip(kern, plain):
            a, b = k(), p()
            torch.cuda.synchronize()
            ok = torch.equal(a, b) if exact else torch.allclose(
                a, b, rtol=1e-4, atol=1e-5 * max(1.0, float(b.abs().max())))
            if not ok:
                raise AssertionError(f"{name}: kernel disagrees with plain")
        out = {"all": timed(lambda: [k() for k in kern])}
        for w, k in zip(widths or (), kern):
            out[f"F={w}"] = timed(k)
        if args.profile:
            out["device"] = device_ms(lambda: [k() for k in kern])
        return out

    def cfg(fmt, op="sum"):
        return rt.EnGNConfig(500, 64, backend="blocked", tile=256,
                             tile_format=fmt, aggregate_op=op)

    # the call forms of whichever tree is on the path: before this slice: sum backwards over carriers of A^T, which every
    # differentiable call named (`transposed=`), and a packed max
    # backward of one launch per group
    old_t = hasattr(engn_mod, "transposed_blocks")
    tr_kw = {"transposed": None} if old_t else {}

    def fused_rows(name, c, pairs, q):
        """The fused forward over carrier `c` for each (x, w) pair."""
        table = c.get("fused_columns") or fused_ops.column_table(
            c["block_col"].cpu().numpy(), q, dev)
        rows[name] = checked(
            name,
            [lambda x=x, w=w: fused_ops.fused_engn_layer(
                c["blocks"], c["block_row"], c["block_col"], x, w, q=q,
                columns=table, **tr_kw) for x, w in pairs],
            [lambda x=x, w=w: fused_ops.fused_engn_plain(
                c["blocks"], c["block_row"], c["block_col"], x, w, q=q)
             for x, w in pairs], False, [w.shape[1] for _, w in pairs])

    def gather_bwd_rows(rows, cp, groups, xs, q):
        """The packed backward rows at the training plan's groups, in
        the call forms of the tree on the path."""
        from repro_torch.kernels.rer_gather_bwd import ops as gbwd
        gs = [feats(x.shape[0], x.shape[1]) for x in xs]
        xm = [torch.relu(x) for x in xs]
        ym = [gather_ops.packed_groups_spmm(groups, x, q=q, op="max",
                                            **tr_kw) for x in xm]
        if old_t:
            groups_t = engn_mod.transposed_groups(cp, 8)

            def sum_t(g):
                return gather_ops.packed_spmm_t(groups_t, g, q=q)

            def sum_t_plain(g):
                return gather_ops.packed_groups_plain(groups_t, g, q=q)

            def count(fn, x, y):
                cnt = torch.zeros(x.shape, dtype=torch.int32, device=dev)
                for gr in groups:
                    fn(gr, x, y, cnt, q=q)
                return cnt

            def scatter(fn, x, y, g, c):
                dx = torch.zeros_like(x)
                for gt in groups_t:
                    dx += fn(gt, x, y, g, c, q=q)
                return dx
            fns = [(lambda x, y: count(gbwd.packed_max_count, x, y)),
                   (lambda x, y: count(gbwd.packed_max_count_plain, x, y)),
                   (lambda *a: scatter(gbwd.packed_max_grad, *a)),
                   (lambda *a: scatter(gbwd.packed_max_grad_plain, *a))]
        else:
            def sum_t(g):
                return gbwd.packed_groups_t(groups, g, q=q)

            def sum_t_plain(g):
                return gbwd.packed_groups_t_plain(groups, g, q=q)

            def max_plain(x, y, g, _):
                cnt = gbwd.packed_max_count_plain(groups, x, y, q=q)
                return gbwd.packed_max_scatter_plain(groups, x, y, g, cnt,
                                                     q=q)
            fns = [(lambda x, y: gbwd.packed_max_words(groups, x, y, q=q)),
                   (lambda x, y: gbwd.packed_max_words_plain(groups, x, y,
                                                             q=q)),
                   (lambda x, y, g, _: gbwd.packed_max_backward(
                       groups, x, y, g, q=q)),
                   max_plain]
        rows["rer_gather_sum_t"] = checked(
            "rer_gather_sum_t", [lambda g=g: sum_t(g) for g in gs],
            [lambda g=g: sum_t_plain(g) for g in gs], False, WIDTHS)
        rows["rer_gather_bwd_count"] = checked(
            "rer_gather_bwd_count",
            [lambda x=x, y=y: fns[0](x, y) for x, y in zip(xm, ym)],
            [lambda x=x, y=y: fns[1](x, y) for x, y in zip(xm, ym)], True,
            WIDTHS)
        cnts = [fns[1](x, y) for x, y in zip(xm, ym)]
        args = list(zip(xm, ym, gs, cnts))
        rows["rer_gather_bwd_max"] = checked(
            "rer_gather_bwd_max", [lambda a=a: fns[2](*a) for a in args],
            [lambda a=a: fns[3](*a) for a in args], False, WIDTHS)

    rows = {}
    g, _, _ = make_dataset("pubmed", seed=0)
    g = merged(apply_vertex_permutation(
        g, degree_sort_permutation(g)).gcn_normalized())
    g_tr, _, _ = make_dataset("pubmed")
    g_tr = merged(g_tr.gcn_normalized())
    g_cora, f_cora, c_cora = make_dataset("cora", seed=0)
    g_cora = apply_vertex_permutation(
        g_cora, degree_sort_permutation(g_cora)).gcn_normalized()
    with torch.inference_mode():
        if not only or "fused_engn_sum" in only:
            plan = rt.prepare_graph(g_cora, rt.EnGNConfig(
                f_cora, 64, backend="fused", tile=256))
            c = plan.carrier
            q, npad = c["blocks_meta"]["q"], c["blocks_meta"]["padded"]
            fused_rows("fused_engn_sum", c,
                       [(feats(npad, f_cora), feats(f_cora, 64)),
                        (feats(npad, 64), feats(64, c_cora))], q)
            del plan, c
        for graph, tag in ((g, "inference"), (g_tr, "training")):
            plan = rt.prepare_graph(graph, cfg(
                "dense", "sum" if tag == "inference" else "max"))
            cd = plan.carrier
            q, npad = cd["blocks_meta"]["q"], cd["blocks_meta"]["padded"]
            xs = [feats(npad, w) for w in WIDTHS]
            if tag == "inference":
                for op in ("sum", "max"):
                    rows[f"rer_spmm_{op}"] = checked(
                        f"rer_spmm_{op}",
                        [lambda x=x, op=op: spmm_ops.blocked_spmm(
                            cd["blocks"], cd["block_row"], cd["block_col"],
                            x, q=q, op=op, **tr_kw) for x in xs],
                        [lambda x=x, op=op: spmm_ops.blocked_spmm_plain(
                            cd["blocks"], cd["block_row"], cd["block_col"],
                            x, q=q, op=op) for x in xs], op == "max",
                        WIDTHS)
            else:
                carrier = (cd["blocks"], cd["block_row"], cd["block_col"])
                if old_t:
                    bt = engn_mod.transposed_blocks(cd)
                    t_args = (bt,)
                    t_plain = (lambda x: spmm_ops.blocked_spmm_plain(
                        bt.blocks, bt.block_row, bt.block_col, x, q=q))
                else:
                    bt, t_args = None, carrier
                    t_plain = (lambda x: spmm_ops.blocked_spmm_t_plain(
                        *carrier, x, q=q))
                rows["rer_spmm_sum_t"] = checked(
                    "rer_spmm_sum_t",
                    [lambda x=x: spmm_ops.blocked_spmm_t(*t_args, x, q=q)
                     for x in xs],
                    [lambda x=x: t_plain(x) for x in xs], False, WIDTHS)
                xm = [torch.relu(x) for x in xs]
                ym = [spmm_ops.blocked_spmm(*carrier, x, q=q, op="max",
                                            **tr_kw) for x in xm]
                gm = [feats(npad, w) for w in WIDTHS]
                rows["rer_spmm_bwd_max"] = checked(
                    "rer_spmm_bwd_max",
                    [lambda x=x, y=y, gg=gg: bwd_ops.blocked_spmm_max_bwd(
                        *carrier, x, y, gg, q=q, counts=cd["row_counts"])
                     for x, y, gg in zip(xm, ym, gm)],
                    [lambda x=x, y=y, gg=gg:
                     bwd_ops.blocked_spmm_max_bwd_plain(*carrier, x, y, gg,
                                                        q=q)
                     for x, y, gg in zip(xm, ym, gm)], False, WIDTHS)
                fused_rows("fused_engn_sum_train", cd,
                           [(feats(npad, 128), feats(128, 64)),
                            (feats(npad, 64), feats(64, 3))], q)
                del bt, t_args, xm, ym, gm
            del plan, cd

            plan = rt.prepare_graph(graph, cfg("packed"))
            cp = plan.carrier
            groups = cp["packed_groups"]

            def plain_groups(grs, x, op):
                y = None
                for gr in grs:
                    part = gather_ops.packed_spmm_plain(
                        gr["rows"], gr["cols"], gr["vals"], gr["block_row"],
                        gr["block_col"], x, q=q, op=op, finish=False)
                    y = part if y is None else (
                        y + part if op == "sum" else torch.maximum(y, part))
                return torch.where(torch.isneginf(y), 0.0, y)
            if tag == "inference":
                for op in ("sum", "max"):
                    rows[f"rer_gather_{op}"] = checked(
                        f"rer_gather_{op}",
                        [lambda x=x, op=op: gather_ops.packed_groups_spmm(
                            groups, x, q=q, op=op, **tr_kw)
                         for x in xs],
                        [lambda x=x, op=op: plain_groups(groups, x, op)
                         for x in xs], op == "max", WIDTHS)
            else:
                gather_bwd_rows(rows, cp, groups, xs, q)
            del plan, cp, groups

        g_syn, _, _ = make_dataset("synthD", seed=0, max_vertices=65536)
        g_syn = apply_vertex_permutation(
            g_syn, degree_sort_permutation(g_syn)).gcn_normalized()
        store = build_tile_store(g_syn, 256)
        packed = pack_tile_store(store)
        col_chunks = []
        for i in range(store.q):
            col_chunks += chunk_tile_row(store.row_tiles(i), 8,
                                         snake=i % 2 == 1)
            if len(col_chunks) >= 32:
                break
        sample = ([(idx, 8) for idx in col_chunks[:32]]
                  + [(np.array([k]), 1) for k in store.col_tiles(0)[:64]])
        staged = []
        for idx, width in sample:
            arrs = [torch.from_numpy(a).to(dev) for a in
                    packed.pack(idx, width, packed.bucket_of(idx))]
            staged.append((*arrs, feats(width * 256, 50 if width == 8
                                        else 16).reshape(width, 256, -1)))
        rows["rer_gather_tile_part_sum"] = checked(
            "rer_gather_tile_part_sum",
            [lambda s=s: gather_ops.packed_tile_part(*s, op="sum")
             for s in staged],
            [lambda s=s: gather_ops.packed_tile_part_plain(*s, op="sum")
             for s in staged], False)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    rows = {k: v for k, v in rows.items() if v is not None}
    print(json.dumps({"label": args.label, "ms": rows, "card": smi}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
