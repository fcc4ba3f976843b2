#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (`src/repro_torch`) on one NVIDIA card.

    python3 chip_smoke.py

It needs one CUDA card and `nvcc`; without a card it exits nonzero and
prints no result.  Phases, each of which fails the run if it fails:

1. device: the card's name and count, and `nvidia-smi`'s name and power
   limit (every time below stands beside them);
2. build: the four CUDA kernels, from `src/repro_torch/csrc/`, one
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
   max).
Launch counters are zeroed just before each of the two path phases and
read just after; each run must have launched its kernels and must match
the "segment" backend on the card (`allclose(rtol=1e-4, atol=1e-5)`).

The line before the last is the kernels' JSON record; the last line is
`{"ok": true, "device": {...}}`.
"""
from __future__ import annotations

import dataclasses
import json
import statistics
import subprocess
import sys
import time
import warnings
from pathlib import Path

RTOL, ATOL = 1e-4, 1e-5           # sum variants and layer outputs
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
                    library=None, record=True):
        """calls: (kernel thunk, plain thunk) for one forward's calls;
        `record=False` checks and times a variant no path launches,
        printed on its own line and kept out of the record."""
        err = 0.0
        for kern, plain in calls:
            yk, yp = kern(), plain()
            torch.cuda.synchronize()
            same = (torch.equal(yk, yp) if exact else
                    torch.allclose(yk, yp, rtol=RTOL, atol=ATOL))
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
                          x, q=q, op=op),
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
                nbytes=sum(nb(gr["rows"], gr["cols"], gr["vals"],
                              gr["block_row"], gr["block_col"], x, x)
                           for x in xs for gr in groups),
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
                  cf["blocks"], cf["block_row"], cf["block_col"], x, w, q=q),
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

    for rec in records:
        rec["launches"] = path_counts[rec["name"]] + tiled_counts[rec["name"]]
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
