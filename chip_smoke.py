#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (`src/repro_torch`) on one NVIDIA card.

    python3 chip_smoke.py

It needs one CUDA card and `nvcc`; without a card it exits nonzero and
prints no result.  Phases, each of which fails the run if it fails:

1. device: the card's name and count, and `nvidia-smi`'s name and power
   limit (every time below stands beside them);
2. build: the three CUDA kernels, from `src/repro_torch/csrc/`, one
   `nvcc` each, in parallel, into `build/repro_torch/`;
3. kernels: each kernel against its plain PyTorch version on the card,
   on the calls one forward of its main-path run makes (max variants
   `torch.equal`, sum variants `allclose(rtol=1e-4, atol=1e-5)`, since
   their reduction order differs), then timed with CUDA events beside
   its bound and a `torch.sparse.mm` yardstick;
4. path: the inference path a user runs — `make_gnn_stack` ->
   `prepare_graph` -> `apply_stack` on `cuda` — for the quickstart (cora
   GCN [1433, 64, 7] on "fused", T=256) and pubmed GCN / GS-Pool
   [500, 64, 3] on "blocked" with dense and packed tiles.  Launch
   counters are zeroed just before these runs and read just after; each
   run must have launched its kernel and must match the "segment"
   backend on the card (`allclose(rtol=1e-4, atol=1e-5)`).

The line before the last is the kernels' JSON record; the last line is
`{"ok": true, "device": {...}}`.
"""
from __future__ import annotations

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
    from repro_torch.graphs.partition import merge_by_key
    from repro_torch.kernels import _build
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
    def dataset(name, merge_duplicates=False):
        g, f, classes = make_dataset(name, seed=0)
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
                    library=None):
        """calls: (kernel thunk, plain thunk) for one forward's calls."""
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
    for rec in records:
        rec["launches"] = path_counts[rec["name"]]
        if rec["launches"] <= 0:
            raise AssertionError(f"{rec['name']} never ran on the main path")

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

    print(json.dumps({"kernels": records}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": kind,
                                             "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
