#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (`src/repro_torch`) on one NVIDIA card.

    python3 chip_smoke.py

It needs one CUDA card and `nvcc`; without a card it exits nonzero and
prints no result.  Phases, each of which fails the run if it fails:

1. device: the card's name and count, and `nvidia-smi`'s name and power
   limit (every time below stands beside them);
2. build: the seven CUDA kernels, from `src/repro_torch/csrc/`, one
   `nvcc` each, in parallel, into `build/repro_torch/`;
3. kernels: each kernel against its plain PyTorch version on the card,
   on the calls one forward of its main-path run makes (max variants
   `torch.equal`, sum variants `allclose(rtol=1e-4, atol=1e-5)`, since
   their reduction order differs), then timed with CUDA events beside
   its bound and a `torch.sparse.mm` yardstick.  The streamed
   executor's kernels: `chunk_queue` on the synthD stand-in at 262,144
   vertices and layer-1 width (F=50), with and without its relu
   epilogue, and `rer_gather`'s tile-part form on a stated sample of
   one forward's calls on the 65,536-vertex graph;
4. path: the inference path a user runs — `make_gnn_stack` ->
   `prepare_graph` -> `apply_stack` on `cuda` — for the quickstart (cora
   GCN [1433, 64, 7] on "fused", T=256) and pubmed GCN / GS-Pool
   [500, 64, 3] on "blocked" with dense and packed tiles;
5. tiled path: synthD at 65,536 vertices, [50, 64, 16], T=256, through
   the streamed executor: GCN on "tiled" (layer 1 on the chunk queue,
   layer 2 streamed in row order), GCN on "blocked" under a 32 MB budget
   (spills to "tiled"; no queue fits), GS-Pool on "tiled" (streamed
   max);
6. backward and B4 kernels: at the training path's shapes (uncut pubmed
   as `build_gnn` makes it, F capped at 128, hidden 64, T=256), the sum
   backwards over the transposed carriers (`rer_spmm_sum_t`,
   `rer_gather_sum_t`; the fused backward, `rer_spmm_sum_t` plus two
   matrix products, is checked and timed on a line of its own, outside
   the kernels' record) and both max backwards
   (`rer_spmm_bwd_max`, `rer_gather_bwd_count` / `_max`), each against
   its plain version (integer counts `torch.equal`, sums within 1e-5 of
   the output's largest magnitude); B4 (`fused_linear_act`) through its
   entry point at the three stages whose function it computes on uncut
   pubmed (GS-Pool extraction 500 x 64, GS-Pool update 564 x 64, GCN afu
   500 x 64), against the layers' own stage output and its plain
   version, timed beside `torch.addmm` + relu;
7. training path: `build_gnn` on uncut pubmed, 20 steps each, GCN on
   "blocked" dense / packed and "fused", GS-Pool on "blocked" dense /
   packed (multi-edges merged), each trajectory against the same run on
   "segment" (`allclose(rtol=1e-3, atol=1e-4)`) and one step's
   gradients against the plain versions' own autograd; then `run_gnn`
   through `FaultTolerantRunner` and `CheckpointManager`, and again from
   its checkpoint.
Launch counters are zeroed just before each path phase (4, 5, the B4
calls of 6, 7) and read just after; each run must have launched its
kernels, and each inference run must match the "segment" backend on the
card (`allclose(rtol=1e-4, atol=1e-5)`).

The line before the last is the kernels' JSON record; the last line is
`{"ok": true, "device": {...}}`.
"""
from __future__ import annotations

import argparse
import dataclasses
import gc
import json
import shutil
import statistics
import subprocess
import sys
import time
import warnings
from pathlib import Path

RTOL, ATOL = 1e-4, 1e-5           # sum variants and layer outputs
NEW_RTOL = 1e-5                   # the backward and B4 kernels' sums
TRAIN_RTOL, TRAIN_ATOL = 1e-3, 1e-4   # loss trajectories (reference's)
TRAIN_STEPS = 20
HBM_BYTES_PER_S = 3.35e12         # H100 SXM, published
FP32_OPS_PER_S = 67e12            # H100 SXM, CUDA cores, published


def _smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA card available", file=sys.stderr)
        return 2
    sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))
    import numpy as np

    import repro_torch as rt
    from repro_torch import kernels as K
    from repro_torch.graphs.degree import (apply_vertex_permutation,
                                           degree_sort_permutation,
                                           permute_features,
                                           unpermute_features)
    from repro_torch.graphs.format import COOGraph
    from repro_torch.graphs.generate import make_dataset, random_features
    from repro_torch.graphs.partition import (build_tile_store,
                                              chunk_tile_row, merge_by_key,
                                              pack_tile_store)
    from repro_torch.kernels import _build
    from repro_torch.kernels.chunk_queue import ops as queue_ops
    from repro_torch.kernels.fused_engn import ops as fused_ops
    from repro_torch.kernels.rer_gather import ops as gather_ops
    from repro_torch.kernels.rer_spmm import ops as spmm_ops

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    kind = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    smi = _smi()
    print(f"device: {kind} (count {count})")
    print(smi)

    # -- build ------------------------------------------------------------
    t0 = time.perf_counter()
    out_dir = _build.build_all()
    print(f"build: {time.perf_counter() - t0:.1f} s into "
          f"{out_dir.relative_to(Path(__file__).resolve().parent)}")
    for name in _build.KERNELS:
        log = out_dir / f"{name}.log"
        for line in (log.read_text().splitlines() if log.exists() else []):
            if "registers" in line or "spill" in line:
                print(f"  {name}: {line.strip()}")

    # -- graphs (host) ------------------------------------------------------
    def dataset(name, merge_duplicates=False, max_vertices=None):
        g, f, classes = make_dataset(name, seed=0, max_vertices=max_vertices)
        x = random_features(g.num_vertices, f, seed=1)
        perm = degree_sort_permutation(g)
        g = apply_vertex_permutation(g, perm).gcn_normalized()
        if merge_duplicates:
            # tiles merge multi-edges by summation before a max sees them
            # (the reference's convention), the segment backend does not:
            # merged up front, both backends see one graph
            n = g.num_vertices
            key, val = merge_by_key(g.dst.astype(np.int64) * n + g.src,
                                    g.weights())
            g = COOGraph(n, (key % n).astype(np.int32),
                         (key // n).astype(np.int32), val)
        return g, permute_features(x, perm), perm, f, classes

    cora = dataset("cora")
    pubmed = dataset("pubmed", merge_duplicates=True)
    for name, (g, _, _, f, c) in (("cora", cora), ("pubmed", pubmed)):
        print(f"graph {name}: |V|={g.num_vertices} |E|={g.num_edges} "
              f"F={f} classes={c}")

    def stack(model, dims, backend, fmt="auto"):
        layers = rt.make_gnn_stack(model, dims, backend=backend, tile=256)
        for layer in layers:
            layer.cfg.tile_format = fmt
        return layers

    def csr(g):
        idx = torch.from_numpy(np.stack([g.dst, g.src]).astype(np.int64))
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", UserWarning)   # "beta" notice
            a = torch.sparse_coo_tensor(idx, torch.from_numpy(g.weights()),
                                        (g.num_vertices, g.num_vertices),
                                        check_invariants=True)
            return a.coalesce().to_sparse_csr().to(dev)

    gen = torch.Generator(device=dev).manual_seed(0)

    def feats(rows, width):
        return torch.randn((rows, width), generator=gen, device=dev) * 0.1

    def cuda_ms(fn) -> float:
        fn()
        torch.cuda.synchronize()
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        iters = int(min(50, max(3, 0.2 / max(time.perf_counter() - t,
                                             1e-6))))
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        stop.record()
        stop.synchronize()
        return start.elapsed_time(stop) / iters

    records = []

    def kernel_case(name, source, replaces, calls, exact, nbytes, ops,
                    library=None, record=True, rel=None):
        """calls: (kernel thunk, plain thunk) for one forward's calls;
        `record=False` checks and times a variant no path launches,
        printed on its own line and kept out of the record (as is a call
        form whose launches another record counts).  `rel` holds
        a sum to within rel x the plain output's largest magnitude (and
        rtol rel) instead of RTOL/ATOL."""
        err = 0.0
        for kern, plain in calls:
            yk, yp = kern(), plain()
            torch.cuda.synchronize()
            if exact:
                same = torch.equal(yk, yp)
            elif rel is not None:
                scale = max(1.0, float(yp.abs().max()) if yp.numel() else 0)
                same = torch.allclose(yk, yp, rtol=rel, atol=rel * scale)
            else:
                same = torch.allclose(yk, yp, rtol=RTOL, atol=ATOL)
            both_inf = torch.isneginf(yk) & torch.isneginf(yp)
            diff = torch.where(both_inf, 0.0, (yk - yp).abs())
            err = max(err, float(diff.max()) if diff.numel() else 0.0)
            if not same:
                raise AssertionError(f"{name}: kernel disagrees with its "
                                     f"plain version (max abs err {err})")
        ms = cuda_ms(lambda: [k() for k, _ in calls])
        plain_ms = cuda_ms(lambda: [p() for _, p in calls])
        lib_ms = cuda_ms(library) if library is not None else None
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = ops / FP32_OPS_PER_S * 1e3
        rec = {"name": name, "route": "cuda", "source": source,
               "replaces": replaces, "launches": None,
               "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
               "bound_ms": max(t_bytes, t_ops),
               "bound_by": "bytes" if t_bytes >= t_ops else "operations",
               "library_ms": lib_ms, "calls": len(calls),
               "bytes": int(nbytes), "ops": int(ops)}
        if record:
            records.append(rec)
        print(f"kernel {name}: {len(calls)} calls/forward, max_abs_err "
              f"{err:.3g} ({'equal' if exact else 'allclose'}), "
              f"{ms:.4f} ms vs plain {plain_ms:.4f} ms, library "
              f"{lib_ms if lib_ms is None else round(lib_ms, 4)} ms, "
              f"bound {rec['bound_ms']:.4f} ms ({rec['bound_by']})")

    def nb(*ts):
        return sum(t.numel() * t.element_size() for t in ts)

    # -- kernels vs plain versions, at the main path's shapes ---------------
    g_pub, _, _, f_pub, c_pub = pubmed
    g_cora, x_cora, perm_cora, f_cora, c_cora = cora
    widths = [64, c_pub]                      # aggregate widths, 2 layers
    with torch.inference_mode():
        dense = rt.prepare_graph(g_pub, stack("gcn", [f_pub, 64, c_pub],
                                              "blocked", "dense")[0].cfg)
        cd, meta = dense.carrier, dense.meta
        q, npad = meta["q"], meta["padded"]
        xs = [feats(npad, w) for w in widths]
        nnz_tiles = int(torch.count_nonzero(cd["blocks"]))
        a_pub = csr(g_pub)
        for op in ("sum", "max"):
            calls = [(lambda x=x, op=op: spmm_ops.blocked_spmm(
                          cd["blocks"], cd["block_row"], cd["block_col"],
                          x, q=q, op=op, transposed=None),
                      lambda x=x, op=op: spmm_ops.blocked_spmm_plain(
                          cd["blocks"], cd["block_row"], cd["block_col"],
                          x, q=q, op=op)) for x in xs]
            kernel_case(
                f"rer_spmm_{op}", "src/repro_torch/csrc/rer_spmm.cu",
                "src/repro/kernels/rer_spmm/rer_spmm.py:74", calls,
                exact=op == "max",
                nbytes=sum(nb(cd["blocks"], cd["block_row"],
                              cd["block_col"], x, x) for x in xs),
                ops=sum(2 * nnz_tiles * x.shape[1] for x in xs),
                library=(None if op == "max" else
                         lambda: [torch.sparse.mm(a_pub, x[:g_pub.num_vertices])
                                  for x in xs]))
        del dense, cd

        packed = rt.prepare_graph(g_pub, stack("gcn", [f_pub, 64, c_pub],
                                               "blocked", "packed")[0].cfg)
        groups = packed.carrier["packed_groups"]
        q = packed.meta["q"]
        nnz_entries = sum(int(torch.count_nonzero(gr["vals"]))
                          for gr in groups)
        print(f"packed pubmed: {len(groups)} bucket groups, S = "
              f"{[gr['rows'].shape[1] for gr in groups]}")
        for op in ("sum", "max"):
            calls = [(lambda gr=gr, x=x, op=op: gather_ops.packed_spmm(
                          gr["rows"], gr["cols"], gr["vals"],
                          gr["block_row"], gr["block_col"], x, q=q, op=op,
                          finish=False),
                      lambda gr=gr, x=x, op=op: gather_ops.packed_spmm_plain(
                          gr["rows"], gr["cols"], gr["vals"],
                          gr["block_row"], gr["block_col"], x, q=q, op=op,
                          finish=False))
                     for x in xs for gr in groups]
            kernel_case(
                f"rer_gather_{op}", "src/repro_torch/csrc/rer_gather.cu",
                "src/repro/kernels/rer_gather/rer_gather.py:103", calls,
                exact=op == "max",
                nbytes=sum(nb(*gr.values()) for gr in groups) * len(xs)
                + sum(nb(x, x) for x in xs),
                ops=sum(2 * nnz_entries * x.shape[1] for x in xs),
                library=(None if op == "max" else
                         lambda: [torch.sparse.mm(a_pub, x[:g_pub.num_vertices])
                                  for x in xs]))
        del packed, groups

        fused_layers = stack("gcn", [f_cora, 64, c_cora], "fused")
        fused = rt.prepare_graph(g_cora, fused_layers[0].cfg)
        cf, meta = fused.carrier, fused.meta
        q, npad = meta["q"], meta["padded"]
        x1 = torch.zeros((npad, f_cora), device=dev)
        x1[:g_cora.num_vertices] = torch.from_numpy(x_cora).to(dev)
        pairs = [(x1, fused_layers[0].w), (feats(npad, 64),
                                           fused_layers[1].w)]
        nnz_cora = int(torch.count_nonzero(cf["blocks"]))
        a_cora = csr(g_cora)
        n_cora = g_cora.num_vertices
        kernel_case(
            "fused_engn_sum", "src/repro_torch/csrc/fused_engn.cu",
            "src/repro/kernels/fused_engn/fused_engn.py:60",
            [(lambda x=x, w=w: fused_ops.fused_engn_layer(
                  cf["blocks"], cf["block_row"], cf["block_col"], x, w, q=q,
                  transposed=None),
              lambda x=x, w=w: fused_ops.fused_engn_plain(
                  cf["blocks"], cf["block_row"], cf["block_col"], x, w, q=q))
             for x, w in pairs],
            exact=False,
            nbytes=sum(nb(cf["blocks"], cf["block_row"], cf["block_col"], x,
                          w) + npad * w.shape[1] * 4 for x, w in pairs),
            ops=sum(2 * npad * w.shape[0] * w.shape[1]
                    + 2 * nnz_cora * w.shape[1] for _, w in pairs),
            library=lambda: [torch.sparse.mm(a_cora, x[:n_cora] @ w)
                             for x, w in pairs])
        del fused, cf

    # -- the streamed executor's kernels ------------------------------------
    def queue_sizes(label, packed):
        """The ragged queue the walker reads beside the (K, S) layout the
        reference's TileQueue pads every tile to."""
        nnz = packed.tile_nnz()
        k, s_max = packed.nnzb, int(nnz.max())
        bucket = 1 << (max(s_max, 8) - 1).bit_length()
        idx = 4 * (packed.q + 1) + 4 * k
        ragged = idx + 4 * (k + 1) + 12 * packed.nnz
        padded = idx + 12 * k * bucket
        hub = int(np.bincount(packed.block_row, weights=nnz,
                              minlength=packed.q).max())
        print(f"queue {label}: K={k} tiles, {packed.nnz} entries, largest "
              f"tile {s_max}, largest interval {hub}, S={bucket}: padded "
              f"(K, S) {padded / 1e9:.3f} GB, ragged {ragged / 1e6:.3f} MB")
        return {"tiles": k, "entries": packed.nnz, "largest_tile": s_max,
                "largest_interval": hub, "bucket": bucket,
                "padded_bytes": padded, "ragged_bytes": ragged}

    t_graph = time.perf_counter()
    synth_big = dataset("synthD", max_vertices=262144)
    synth = dataset("synthD", max_vertices=65536)
    synth_merged = dataset("synthD", merge_duplicates=True,
                           max_vertices=65536)
    print(f"synthD graphs built in {time.perf_counter() - t_graph:.1f} s")
    for name, (g, _, _, f, c) in (("synthD-262k", synth_big),
                                  ("synthD-65k", synth),
                                  ("synthD-65k merged", synth_merged)):
        print(f"graph {name}: |V|={g.num_vertices} |E|={g.num_edges} "
              f"F={f} classes={c}")
    queue_table = {}
    with torch.inference_mode():
        g_big, _, _, f_syn, _ = synth_big
        packed_big = pack_tile_store(build_tile_store(g_big, 256))
        queue_table["synthD-262k"] = queue_sizes("synthD-262k", packed_big)
        tq = queue_ops.build_tile_queue(packed_big, device=dev)
        x_big = feats(g_big.num_vertices, f_syn)
        a_big = csr(g_big)
        q_bytes = nb(tq.tile_ptr, tq.tile_src, tq.entry_ptr, tq.rows,
                     tq.cols, tq.vals, x_big, x_big)
        for act in (None, "relu"):
            kernel_case(
                "chunk_queue_sum" + ("_relu" if act else ""),
                "src/repro_torch/csrc/chunk_queue.cu",
                "src/repro/kernels/chunk_queue/chunk_queue.py:132",
                [(lambda act=act: queue_ops.tile_queue_aggregate(
                      tq, x_big, activation=act),
                  lambda act=act: queue_ops.tile_queue_plain(tq, x_big,
                                                             act))],
                exact=False, nbytes=q_bytes, ops=2 * tq.entries * f_syn,
                library=(None if act else
                         lambda: torch.sparse.mm(a_big, x_big)),
                record=act is None)
        del tq, x_big, a_big, packed_big

        # rer_gather's tile-part form, on the first 32 column chunks
        # (C=8) and the first 64 row tiles (C=1) of the 65,536-vertex
        # graph's sweeps, at the widths the tiled runs stream
        g_syn = synth[0]
        store = build_tile_store(g_syn, 256)
        packed = pack_tile_store(store)
        queue_table["synthD-65k"] = queue_sizes("synthD-65k", packed)
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
            arrs = packed.pack(idx, width, packed.bucket_of(idx))
            real = int((packed.entry_ptr[idx + 1]
                        - packed.entry_ptr[idx]).sum())
            staged.append(tuple(torch.from_numpy(a).to(dev) for a in arrs)
                          + (width, real))
        print(f"tile-part sample: {len(col_chunks[:32])} column chunks "
              f"(C=8) and {len(sample) - len(col_chunks[:32])} row tiles "
              f"(C=1), {sum(r for *_, r in staged)} entries")

        def part_csr(rows, cols, vals, width):
            c_idx = torch.arange(width, device=dev)[:, None] * 256
            idx = torch.stack([rows.long().reshape(-1),
                               (c_idx + cols.long()).reshape(-1)])
            keep = vals.reshape(-1) != 0
            a = torch.sparse_coo_tensor(idx[:, keep], vals.reshape(-1)[keep],
                                        (256, width * 256))
            with warnings.catch_warnings():
                warnings.simplefilter("ignore", UserWarning)
                return a.coalesce().to_sparse_csr()

        for op, (d_col, d_row) in (("sum", (50, 16)), ("max", (64, 16))):
            xs = [feats(width * 256, d_col if width == 8 else d_row
                        ).reshape(width, 256, -1)
                  for _, _, _, width, _ in staged]
            calls = [(lambda r=r, c=c, v=v, x=x, op=op:
                      gather_ops.packed_tile_part(r, c, v, x, op=op),
                      lambda r=r, c=c, v=v, x=x, op=op:
                      gather_ops.packed_tile_part_plain(r, c, v, x, op=op))
                     for (r, c, v, _, _), x in zip(staged, xs)]
            lib = None
            if op == "sum":
                mats = [part_csr(r, c, v, w) for r, c, v, w, _ in staged]
                lib = (lambda mats=mats, xs=xs: [
                    torch.sparse.mm(a, x.reshape(-1, x.shape[2]))
                    for a, x in zip(mats, xs)])
            kernel_case(
                f"rer_gather_tile_part_{op}",
                "src/repro_torch/csrc/rer_gather.cu",
                "src/repro/kernels/rer_gather/rer_gather.py:103", calls,
                exact=op == "max",
                nbytes=sum(nb(r, c, v, x) + 256 * x.shape[2] * 4
                           for (r, c, v, _, _), x in zip(staged, xs)),
                ops=sum(2 * real * x.shape[2]
                        for (*_, real), x in zip(staged, xs)),
                library=lib)
        del staged, xs, calls, store, packed

    # -- the main path, through the user's entry points ---------------------
    runs = [
        ("quickstart cora gcn fused", cora, "gcn",
         [f_cora, 64, c_cora], "fused", "auto", "fused_engn_sum"),
        ("pubmed gcn blocked dense", pubmed, "gcn",
         [f_pub, 64, c_pub], "blocked", "dense", "rer_spmm_sum"),
        ("pubmed gcn blocked packed", pubmed, "gcn",
         [f_pub, 64, c_pub], "blocked", "packed", "rer_gather_sum"),
        ("pubmed gs_pool blocked dense", pubmed, "gs_pool",
         [f_pub, 64, c_pub], "blocked", "dense", "rer_spmm_max"),
        ("pubmed gs_pool blocked packed", pubmed, "gs_pool",
         [f_pub, 64, c_pub], "blocked", "packed", "rer_gather_max"),
    ]
    built = []
    K.reset_launch_counts()
    with torch.inference_mode():
        for label, data, model, dims, backend, fmt, kern in runs:
            g, x, perm, _, _ = data
            x = torch.from_numpy(x).to(dev)
            layers = stack(model, dims, backend, fmt)
            graph = rt.prepare_graph(g, layers[0].cfg)
            before = K.launch_counts()[kern]
            y = rt.apply_stack(layers, graph, x)
            torch.cuda.synchronize()
            grew = K.launch_counts()[kern] - before
            if grew <= 0:
                raise AssertionError(f"{label}: {kern} was not launched")
            built.append((label, g, x, perm, model, dims, layers, graph, y,
                          grew))
    path_counts = K.launch_counts()
    print(f"main-path launches: {path_counts}")
    with torch.inference_mode():
        for label, g, x, perm, model, dims, layers, graph, y, grew in built:
            if y.shape != (g.num_vertices, dims[-1]):
                raise AssertionError(f"{label}: output shape {tuple(y.shape)}")
            if not bool(torch.isfinite(y).all()):
                raise AssertionError(f"{label}: non-finite output")
            ref_layers = stack(model, dims, "segment")
            for a, b in zip(ref_layers, layers):
                a.load_state_dict(b.state_dict())
            ref_graph = rt.prepare_graph(g, ref_layers[0].cfg)
            y_ref = rt.apply_stack(ref_layers, ref_graph, x)
            err = float((y - y_ref).abs().max())
            if not torch.allclose(y, y_ref, rtol=RTOL, atol=ATOL):
                raise AssertionError(f"{label}: differs from the segment "
                                     f"backend (max abs err {err})")
            times = []
            torch.cuda.reset_peak_memory_stats()
            for _ in range(5):
                t = time.perf_counter()
                rt.apply_stack(layers, graph, x)
                torch.cuda.synchronize()
                times.append((time.perf_counter() - t) * 1e3)
            peak = torch.cuda.max_memory_allocated()
            print(f"path {label}: {grew} launches/forward, max abs err vs "
                  f"segment {err:.3g}, forward {statistics.median(times):.3f}"
                  f" ms (median of 5, host clock), peak "
                  f"{peak / 2**20:.1f} MiB, tile_format {graph.tile_format}")
            if label.startswith("quickstart"):
                pred = unpermute_features(y.cpu().numpy(), perm).argmax(-1)
                print(f"  quickstart predictions of first 10 vertices: "
                      f"{pred[:10].tolist()}")

    # -- the streamed tiled path -----------------------------------------------
    # synthD at 65,536 vertices, full Table-5 width, T=256.  Layer 1
    # (50 -> 64) is afu and streams in column order, layer 2 (64 -> 16)
    # fau in row order.  GS-Pool runs on the graph with its multi-edges
    # merged (the tiles merge them before a max sees them; segment does
    # not).
    dims_syn = [f_syn, 64, 16]
    tiled_runs = [
        ("synthD gcn tiled", synth, "gcn", "tiled", None,
         ("chunk_queue_sum", "rer_gather_tile_part_sum")),
        ("synthD gcn blocked 32 MB budget", synth, "gcn", "blocked",
         32_000_000, ("rer_gather_tile_part_sum",)),
        ("synthD gs_pool tiled", synth_merged, "gs_pool", "tiled", None,
         ("rer_gather_tile_part_max",)),
    ]
    tiled_built = []
    K.reset_launch_counts()
    with torch.inference_mode():
        for label, data, model, backend, budget, kerns in tiled_runs:
            g, x, _, _, _ = data
            x = torch.from_numpy(x).to(dev)
            layers = stack(model, dims_syn, backend)
            for layer in layers:
                layer.cfg.device_budget_bytes = budget
            t = time.perf_counter()
            graph = rt.prepare_graph(g, layers[0].cfg)
            prep_s = time.perf_counter() - t
            if graph.backend != "tiled":
                raise AssertionError(f"{label}: plan landed on "
                                     f"{graph.backend!r}, not 'tiled'")
            if budget and graph.meta["queue_plan"] is not None:
                raise AssertionError(f"{label}: a queue fits the budget")
            ex = graph.carrier["tiled_exec"]
            before = K.launch_counts()
            y = rt.apply_stack(layers, graph, x)
            torch.cuda.synchronize()
            grew = {k: v - before[k] for k, v in K.launch_counts().items()
                    if v > before[k]}
            for kern in kerns:
                if grew.get(kern, 0) <= 0:
                    raise AssertionError(f"{label}: {kern} was not launched")
            if budget and grew.get("chunk_queue_sum"):
                raise AssertionError(f"{label}: the queue ran over budget")
            stats = dataclasses.asdict(ex.stats)
            tiled_built.append((label, g, x, model, layers, graph, y, grew,
                                stats, prep_s))
    tiled_counts = K.launch_counts()
    print(f"tiled-path launches: {tiled_counts}")

    with torch.inference_mode():
        for (label, g, x, model, layers, graph, y, grew, stats,
             prep_s) in tiled_built:
            if y.shape != (g.num_vertices, dims_syn[-1]):
                raise AssertionError(f"{label}: output shape {tuple(y.shape)}")
            if y.device.type != "cpu" or y.dtype != torch.float32:
                raise AssertionError(f"{label}: a tiled layer returns a CPU "
                                     f"float32 tensor, got {y.dtype} on "
                                     f"{y.device}")
            if not bool(torch.isfinite(y).all()):
                raise AssertionError(f"{label}: non-finite output")
            ref_layers = stack(model, dims_syn, "segment")
            for a, b in zip(ref_layers, layers):
                a.load_state_dict(b.state_dict())
            y_ref = rt.apply_stack(ref_layers,
                                   rt.prepare_graph(g, ref_layers[0].cfg),
                                   x).cpu()
            err = float((y - y_ref).abs().max())
            if not torch.allclose(y, y_ref, rtol=RTOL, atol=ATOL):
                raise AssertionError(f"{label}: differs from the segment "
                                     f"backend (max abs err {err})")
            del ref_layers, y_ref
            times = []
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            for _ in range(3):
                t = time.perf_counter()
                rt.apply_stack(layers, graph, x)
                torch.cuda.synchronize()
                times.append((time.perf_counter() - t) * 1e3)
            peak = torch.cuda.max_memory_allocated()
            print(f"path {label}: backend {graph.backend}, streaming "
                  f"{graph.streaming_mode}, tile {graph.meta['tile']}, chunk "
                  f"{graph.meta['chunk']}, queue_plan "
                  f"{graph.meta['queue_plan']}, prepare {prep_s:.2f} s")
            print(f"  launches/forward {grew}, max abs err vs segment "
                  f"{err:.3g}, forward {statistics.median(times):.1f} ms "
                  f"(median of 3, host clock: {[round(v, 1) for v in times]})"
                  f", peak {peak / 2**20:.1f} MiB")
            print(f"  TiledStats/forward {json.dumps(stats)}")

    # -- the backward kernels and B4 ------------------------------------------
    from repro_torch.core import engn as engn_mod
    from repro_torch.kernels.feature_update import ops as update_ops
    from repro_torch.kernels.rer_gather_bwd import ops as gather_bwd_ops
    from repro_torch.kernels.rer_spmm_bwd import ops as spmm_bwd_ops
    from repro_torch.launch import train as train_mod

    def merged(g):
        """Multi-edges merged by summation (GS-Pool's max on tiles)."""
        n = g.num_vertices
        key, val = merge_by_key(g.dst.astype(np.int64) * n + g.src,
                                g.weights())
        return COOGraph(n, (key % n).astype(np.int32),
                        (key // n).astype(np.int32), val)

    # the training path's graph: build_gnn's uncut pubmed, GCN-normalised
    # (the tile carriers of the merged and unmerged graphs are equal)
    g_tr, f_tr, c_tr = make_dataset("pubmed")
    f_tr = min(f_tr, 128)
    g_tr = merged(g_tr.gcn_normalized())
    n_tr = g_tr.num_vertices
    print(f"training graph pubmed: |V|={n_tr} |E|={g_tr.num_edges} (merged) "
          f"F={f_tr} classes={c_tr}")
    widths_tr = [64, c_tr]                # aggregate widths, 2 layers
    a_tr_t = csr(COOGraph(n_tr, g_tr.dst, g_tr.src, g_tr.weights()))
    with torch.inference_mode():
        cfg_tr = rt.EnGNConfig(f_tr, 64, backend="blocked", tile=256,
                               tile_format="dense")
        plan_d = rt.prepare_graph(g_tr, cfg_tr)
        cd = plan_d.carrier
        q, npad = cd["blocks_meta"]["q"], cd["blocks_meta"]["padded"]
        bt = engn_mod.transposed_blocks(cd)
        nnz_tr = int(torch.count_nonzero(cd["blocks"]))
        print(f"training dense carrier: {cd['blocks'].shape[0]} tiles, "
              f"{plan_d.footprint_bytes / 1e9:.3f} GB; transposed "
              f"{bt.nbytes() / 1e9:.3f} GB")

        def rows_n(t):
            t[n_tr:] = 0
            return t
        gs = [rows_n(feats(npad, w)) for w in widths_tr]
        # max inputs like GS-Pool's relu extraction: half zeros, ties
        xs_max = [rows_n(torch.relu(feats(npad, w))) for w in widths_tr]
        ys_max = [spmm_ops.blocked_spmm(cd["blocks"], cd["block_row"],
                                        cd["block_col"], x, q=q, op="max",
                                        transposed=None)
                  for x in xs_max]
        kernel_case(
            "rer_spmm_sum_t", "src/repro_torch/csrc/rer_spmm.cu",
            "src/repro/kernels/rer_spmm/rer_spmm.py:74",
            [(lambda g=g: spmm_ops.blocked_spmm_t(bt, g, q=q),
              lambda g=g: spmm_ops.blocked_spmm_plain(
                  bt.blocks, bt.block_row, bt.block_col, g, q=q))
             for g in gs],
            exact=False, rel=NEW_RTOL,
            nbytes=sum(nb(bt.blocks, bt.block_row, bt.block_col, g, g)
                       for g in gs),
            ops=sum(2 * nnz_tr * g.shape[1] for g in gs),
            library=lambda: [torch.sparse.mm(a_tr_t, g[:n_tr]) for g in gs])
        kernel_case(
            "rer_spmm_bwd_max", "src/repro_torch/csrc/rer_spmm_bwd.cu",
            "src/repro/kernels/rer_spmm/rer_spmm.py:74",
            [(lambda x=x, y=y, g=g: spmm_bwd_ops.blocked_spmm_max_bwd(
                  cd["blocks"], cd["block_row"], cd["block_col"], bt, x, y, g,
                  q=q),
              lambda x=x, y=y, g=g: spmm_bwd_ops.blocked_spmm_max_bwd_plain(
                  cd["blocks"], cd["block_row"], cd["block_col"], bt, x, y, g,
                  q=q))
             for x, y, g in zip(xs_max, ys_max, gs)],
            exact=False, rel=NEW_RTOL,
            nbytes=sum(nb(cd["blocks"], cd["block_row"], cd["block_col"],
                          x, y, g, x)
                       for x, y, g in zip(xs_max, ys_max, gs)),
            ops=sum(4 * nnz_tr * x.shape[1] for x in xs_max))
        # the fused backward at both layers' shapes: [128 -> 64], [64 -> 3]
        fused_in = [(rows_n(feats(npad, f_tr)), feats(f_tr, 64), gs[0]),
                    (rows_n(feats(npad, 64)), feats(64, c_tr), gs[1])]

        def flat_bwd(fn, x, w, g):
            dx, dw = fn(bt, x, w, g, q=q)
            return torch.cat([dx.reshape(-1), dw.reshape(-1)])
        kernel_case(
            "fused_engn_bwd", "src/repro_torch/csrc/rer_spmm.cu",
            "src/repro/kernels/fused_engn/fused_engn.py:60",
            [(lambda x=x, w=w, g=g: flat_bwd(fused_ops.fused_engn_bwd,
                                              x, w, g),
              lambda x=x, w=w, g=g: flat_bwd(fused_ops.fused_engn_bwd_plain,
                                              x, w, g))
             for x, w, g in fused_in],
            exact=False, rel=NEW_RTOL, record=False,
            nbytes=sum(nb(bt.blocks, bt.block_row, bt.block_col, x, w, g, x,
                          w) for x, w, g in fused_in),
            ops=sum(2 * nnz_tr * w.shape[1] + 4 * npad * w.shape[0]
                    * w.shape[1] for x, w, g in fused_in))
        del plan_d, cd, bt, xs_max, ys_max, fused_in

        plan_p = rt.prepare_graph(g_tr, dataclasses.replace(
            cfg_tr, tile_format="packed"))
        cp = plan_p.carrier
        groups = cp["packed_groups"]
        groups_t = engn_mod.transposed_groups(cp, cfg_tr.packed_bucket_floor)
        nnz_p = sum(int(torch.count_nonzero(gr["vals"])) for gr in groups)
        print(f"training packed carrier: {len(groups)} groups, "
              f"{plan_p.footprint_bytes / 1e6:.3f} MB; transposed "
              f"{len(groups_t)} groups, "
              f"{engn_mod.transposed_bytes(plan_p) / 1e6:.3f} MB")
        kernel_case(
            "rer_gather_sum_t", "src/repro_torch/csrc/rer_gather.cu",
            "src/repro/kernels/rer_gather/rer_gather.py:103",
            [(lambda gt=gt, g=g: gather_ops.packed_spmm_t(gt, g, q=q),
              lambda gt=gt, g=g: gather_ops.packed_spmm_plain(
                  gt["rows"], gt["cols"], gt["vals"], gt["block_row"],
                  gt["block_col"], g, q=q))
             for g in gs for gt in groups_t],
            exact=False, rel=NEW_RTOL,
            nbytes=sum(nb(*gt.values()) for gt in groups_t) * len(gs)
            + sum(nb(g, g) for g in gs),
            ops=sum(2 * nnz_p * g.shape[1] for g in gs),
            library=lambda: [torch.sparse.mm(a_tr_t, g[:n_tr]) for g in gs])
        xs_max = [rows_n(torch.relu(feats(npad, w))) for w in widths_tr]
        ys_max = [gather_ops.packed_groups_spmm(groups, x, q=q, op="max",
                                                transposed=None)
                  for x in xs_max]

        def counted(fn, x, y):
            cnt = torch.zeros(x.shape, dtype=torch.int32, device=dev)
            for gr in groups:
                fn(gr, x, y, cnt, q=q)
            return cnt
        kernel_case(
            "rer_gather_bwd_count", "src/repro_torch/csrc/rer_gather_bwd.cu",
            "src/repro/kernels/rer_gather/rer_gather.py:103",
            [(lambda x=x, y=y: counted(gather_bwd_ops.packed_max_count, x, y),
              lambda x=x, y=y: counted(gather_bwd_ops.packed_max_count_plain,
                                       x, y))
             for x, y in zip(xs_max, ys_max)],
            exact=True,
            nbytes=sum(nb(*gr.values()) for gr in groups) * len(xs_max)
            + sum(nb(x, y, x) for x, y in zip(xs_max, ys_max)),
            ops=sum(2 * nnz_p * x.shape[1] for x in xs_max))
        cnts = [counted(gather_bwd_ops.packed_max_count_plain, x, y)
                for x, y in zip(xs_max, ys_max)]
        kernel_case(
            "rer_gather_bwd_max", "src/repro_torch/csrc/rer_gather_bwd.cu",
            "src/repro/kernels/rer_gather/rer_gather.py:103",
            [(lambda gt=gt, x=x, y=y, g=g, c=c: gather_bwd_ops.packed_max_grad(
                  gt, x, y, g, c, q=q),
              lambda gt=gt, x=x, y=y, g=g, c=c:
              gather_bwd_ops.packed_max_grad_plain(gt, x, y, g, c, q=q))
             for x, y, g, c in zip(xs_max, ys_max, gs, cnts)
             for gt in groups_t],
            exact=False, rel=NEW_RTOL,
            nbytes=sum(nb(*gt.values()) for gt in groups_t) * len(xs_max)
            + sum(nb(x, y, g, c, x) for x, y, g, c in
                  zip(xs_max, ys_max, gs, cnts)),
            ops=sum(4 * nnz_p * x.shape[1] for x in xs_max))
        del plan_p, cp, groups, groups_t, xs_max, ys_max, cnts, gs

    # B4 through its entry point, at the stages whose function it computes
    # on uncut pubmed: the layers' own weights, the layers' own stage
    # outputs to agree with
    g_pub, x_pub_np, _, f_pub, c_pub = pubmed
    with torch.inference_mode():
        x_pub = torch.from_numpy(x_pub_np).to(dev)
        pool = stack("gs_pool", [f_pub, 64, c_pub], "segment")[0]
        gcn_afu = rt.make_gnn("gcn", f_pub, 64, stage_order="afu")
        plan_seg = rt.prepare_graph(g_pub, pool.cfg)
        agg = pool._aggregate(plan_seg, pool.feature_extraction(x_pub))
        ax = gcn_afu._aggregate(rt.prepare_graph(g_pub, gcn_afu.cfg), x_pub)
        stages = [
            ("feature_update_relu_gs_pool_extract", x_pub, pool.w_pool,
             pool.b_pool, pool.feature_extraction(x_pub)),
            ("feature_update_relu_gs_pool_update",
             torch.cat([agg, x_pub], dim=-1), pool.w, None,
             pool.update(x_pub, agg)),
            ("feature_update_relu_gcn_afu", ax, gcn_afu.w, None,
             gcn_afu.update(x_pub, gcn_afu.feature_extraction(ax)))]
        K.reset_launch_counts()
        b4_launches = {}
        for name, xin, w, b, want in stages:
            before = K.launch_counts()["feature_update_relu"]
            y = update_ops.fused_linear_act(xin, w, b, act="relu")
            torch.cuda.synchronize()
            b4_launches[name] = K.launch_counts()["feature_update_relu"] \
                - before
            err = float((y - want).abs().max())
            scale = max(1.0, float(want.abs().max()))
            if not torch.allclose(y, want, rtol=NEW_RTOL,
                                  atol=NEW_RTOL * scale):
                raise AssertionError(f"{name}: differs from the layer's own "
                                     f"stage (max abs err {err})")
            print(f"path {name}: {tuple(xin.shape)} @ {tuple(w.shape)}, "
                  f"{b4_launches[name]} launch, max abs err vs the layer "
                  f"{err:.3g}")
        b4_counts = K.launch_counts()
        for name, xin, w, b, _ in stages:
            bias = b if b is not None else torch.zeros(w.shape[1],
                                                       device=dev)
            kernel_case(
                name, "src/repro_torch/csrc/feature_update.cu",
                "src/repro/kernels/feature_update/feature_update.py:48",
                [(lambda xin=xin, w=w, b=bias: update_ops.fused_linear_act(
                      xin, w, b, act="relu"),
                  lambda xin=xin, w=w, b=bias:
                  update_ops.fused_linear_act_plain(xin, w, b, act="relu"))],
                exact=False, rel=NEW_RTOL,
                nbytes=nb(xin, w, bias) + xin.shape[0] * w.shape[1] * 4,
                ops=2 * xin.shape[0] * w.shape[0] * w.shape[1],
                library=lambda xin=xin, w=w, b=bias: torch.relu(
                    torch.addmm(b, xin, w)))
        del stages, agg, ax, x_pub, plan_seg

    gc.collect()
    torch.cuda.empty_cache()

    # -- the training path ----------------------------------------------------
    def build_run(model, backend, fmt):
        step, state, data, _, aux = train_mod.build_gnn(
            model=model, dataset="pubmed", backend=backend,
            steps=TRAIN_STEPS, hidden=64, batch=256, max_vertices=None,
            max_edges=None)
        tr = aux["trainer"]
        if model == "gs_pool":
            tr.graph = merged(tr.graph)
        for layer in tr.layers:
            layer.cfg.tile_format = fmt
        tr.rebuild()
        return tr, state, data

    def grads_of(tr, params, batch, plan=None):
        leaves = [{k: v.detach().clone().requires_grad_(True)
                   for k, v in p.items()} for p in params]
        tr.loss(leaves, batch, plan=plan).backward()
        return [leaf.grad for p in leaves for _, leaf in sorted(p.items())]

    def plain_twin(tr):
        """The trainer's plan as flat entries on the card: `_aggregate`
        takes `packed_flat_plain` for it, whose own autograd is the
        reference's flat convention (a tie at a relu zero passes no
        gradient, so it agrees with the tiles' two-level split)."""
        store = build_tile_store(tr.graph, 256)
        flat = gather_ops.flat_entries(pack_tile_store(store))
        meta = tr.plan.meta
        return rt.PreparedPlan(
            backend="blocked", n=tr.plan.n,
            carrier={"n": tr.plan.n, "backend": "blocked", "device": dev,
                     "packed_flat": tuple(torch.from_numpy(a).to(dev)
                                          for a in flat),
                     "blocks_meta": {"q": meta["q"],
                                     "padded": meta["padded"]}})

    bwd_keys = ("rer_spmm_sum_t", "rer_gather_sum_t", "rer_spmm_bwd_max",
                "rer_gather_bwd_count", "rer_gather_bwd_max")
    train_runs = [
        ("pubmed gcn segment", "gcn", "segment", "auto", None),
        ("pubmed gcn blocked dense", "gcn", "blocked", "dense",
         ("rer_spmm_sum", "rer_spmm_sum_t")),
        ("pubmed gcn blocked packed", "gcn", "blocked", "packed",
         ("rer_gather_sum", "rer_gather_sum_t")),
        ("pubmed gcn fused", "gcn", "fused", "auto",
         ("fused_engn_sum", "rer_spmm_sum_t")),
        ("pubmed gs_pool segment", "gs_pool", "segment", "auto", None),
        ("pubmed gs_pool blocked dense", "gs_pool", "blocked", "dense",
         ("rer_spmm_max", "rer_spmm_bwd_max")),
        ("pubmed gs_pool blocked packed", "gs_pool", "blocked", "packed",
         ("rer_gather_max", "rer_gather_bwd_count", "rer_gather_bwd_max")),
    ]
    seg_losses, train_table = {}, []
    K.reset_launch_counts()
    for label, model, backend, fmt, kerns in train_runs:
        mem0 = torch.cuda.memory_allocated()
        tr, state, data = build_run(model, backend, fmt)
        if backend != "segment":
            batch0 = next(data)
            data.seek(0)
            got = grads_of(tr, state["params"], batch0)
            want = grads_of(tr, state["params"], batch0, plan=plain_twin(tr))
            gerr = max(float((a - b).abs().max()) for a, b in zip(got, want))
            for a, b in zip(got, want):
                scale = max(1e-30, float(b.abs().max()))
                if not torch.allclose(a, b, rtol=RTOL, atol=RTOL * scale):
                    raise AssertionError(f"{label}: one step's gradients "
                                         f"differ from the plain versions' "
                                         f"autograd (max abs err {gerr})")
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        before = K.launch_counts()
        ps, opt, losses, times = state["params"], state["opt"], [], []
        for _ in range(TRAIN_STEPS):
            t = time.perf_counter()
            ps, opt, m = tr.step(ps, opt, next(data))
            losses.append(float(m["loss"]))      # waits for the step
            times.append((time.perf_counter() - t) * 1e3)
        peak = torch.cuda.max_memory_allocated() - mem0
        grew = {k: v - before[k] for k, v in K.launch_counts().items()
                if v > before[k]}
        if not all(np.isfinite(losses)):
            raise AssertionError(f"{label}: non-finite loss {losses}")
        for kern in kerns or ():
            if grew.get(kern, 0) <= 0:
                raise AssertionError(f"{label}: {kern} was not launched")
        if backend == "segment":
            seg_losses[model] = losses
            lerr = 0.0
        else:
            ref = np.asarray(seg_losses[model])
            lerr = float(np.abs(np.asarray(losses) - ref).max())
            if not np.allclose(losses, ref, rtol=TRAIN_RTOL,
                               atol=TRAIN_ATOL):
                raise AssertionError(f"{label}: loss trajectory {losses} "
                                     f"differs from segment {ref.tolist()}")
        per_step = {k: v / TRAIN_STEPS for k, v in grew.items()}
        bwd = sum(v for k, v in per_step.items() if k in bwd_keys)
        row = {"run": label, "plan": f"{tr.plan.backend}/"
               f"{tr.plan.tile_format}",
               "ms_per_step": statistics.median(times[1:]),
               "first_step_ms": times[0], "launches_per_step": per_step,
               "bwd_launches_per_step": bwd,
               "plan_and_state_mib": (base - mem0) / 2**20,
               "peak_mib": peak / 2**20,
               "footprint_bytes": tr.plan.footprint_bytes,
               "transposed_bytes": engn_mod.transposed_bytes(tr.plan),
               "loss_first": losses[0], "loss_last": losses[-1],
               "max_loss_err_vs_segment": lerr}
        if backend != "segment":
            row["max_grad_err_vs_plain"] = gerr
        train_table.append(row)
        print(f"train {label}: plan {row['plan']}, median "
              f"{row['ms_per_step']:.3f} ms/step (host clock, steps 2-"
              f"{TRAIN_STEPS}; first {times[0]:.1f} ms), "
              f"{bwd:g} backward launches/step, launches/step {per_step}, "
              f"plan + state {row['plan_and_state_mib']:.1f} MiB, peak "
              f"{row['peak_mib']:.1f} MiB (both over what the run found "
              f"allocated), footprint "
              f"{row['footprint_bytes']} B + transposed "
              f"{row['transposed_bytes']} B, loss {losses[0]:.4f} -> "
              f"{losses[-1]:.4f}, max loss err vs segment {lerr:.3g}"
              + (f", max grad err vs plain {gerr:.3g}"
                 if backend != "segment" else ""))
        del tr, state, data, ps, opt
        gc.collect()                  # the trainer and its step form a cycle
        torch.cuda.empty_cache()
    train_counts = K.launch_counts()
    print(f"training-path launches: {train_counts}")
    print(f"training runs: {json.dumps(train_table)}")

    # run_gnn: FaultTolerantRunner + CheckpointManager, then a restore
    ckpt_dir = Path(__file__).resolve().parent / "build" / "smoke_ckpt"
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    gnn_args = dict(gnn="gcn", gnn_backend="blocked", gnn_shards=None,
                    gnn_hidden=64, dataset="pubmed", device_budget=0,
                    batch=256, ckpt_dir=str(ckpt_dir), ckpt_every=2,
                    chaos_seed=None, device=None)
    first = train_mod.run_gnn(argparse.Namespace(**gnn_args, steps=2))
    second = train_mod.run_gnn(argparse.Namespace(**gnn_args, steps=4))
    if (first["start"], first["steps"], first["saves"]) != (0, 2, 1) or (
            second["start"], second["steps"]) != (2, 4):
        raise AssertionError(f"run_gnn did not checkpoint and resume: "
                             f"{first} / {second}")
    print(f"run_gnn: 2 steps, saved; resumed at step {second['start']} to "
          f"{second['steps']}, losses {first['losses']} + "
          f"{second['losses']}")
    shutil.rmtree(ckpt_dir, ignore_errors=True)

    phases = (path_counts, tiled_counts, b4_counts, train_counts)
    for rec in records:
        # a B4 record's launches are its own stage's; every other record
        # is named by its launch counter
        rec["launches"] = (b4_launches[rec["name"]]
                           if rec["name"] in b4_launches
                           else sum(c[rec["name"]] for c in phases))
        if rec["launches"] <= 0:
            raise AssertionError(f"{rec['name']} never ran on a path")
    print(f"queue layouts: {json.dumps(queue_table)}")
    print(json.dumps({"kernels": records}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": kind,
                                             "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
