#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (`src/repro_torch`) on one NVIDIA card.

    python3 chip_smoke.py

It needs one CUDA card and `nvcc`; without a card it exits nonzero and
prints no result.  Phases, each of which fails the run if it fails:

1. device: the card's name and count, and `nvidia-smi`'s name and power
   limit (every time below stands beside them);
2. build: the eight CUDA kernel sources, from `src/repro_torch/csrc/`, one
   `nvcc` each, in parallel, into `build/repro_torch/`;
3. kernels: each kernel against its plain PyTorch version on the card,
   on the calls one forward of its main-path run makes (max variants
   `torch.equal`, sum variants `allclose(rtol=1e-4, atol=1e-5)`, since
   their reduction order differs), then timed with CUDA events beside
   its bound and a `torch.sparse.mm` yardstick.  A `rer_gather` row
   times the whole aggregate of a plan's bucket groups per width (one
   launch), the function `torch.sparse.mm` computes; its bound counts
   12 B per real entry and X and Y once.  The streamed
   executor's kernels: `chunk_queue` on the synthD stand-in at 262,144
   vertices and layer-1 width (F=50), with and without its relu
   epilogue (both recorded; relu is a launch argument of the same
   kernel, which no path asks for, so the relu record reads the
   kernel's launches on the tiled path), its bound printed beside what
   the gathers would move if every X row came from HBM, its adjoint
   B5^T on the same queue at F=50 (`chunk_queue_sum_t_synthd`, beside
   `torch.sparse.mm(A^T, G)`; its launches are phase 11's), and
   `rer_gather`'s tile-part form on a stated sample of one forward's
   calls on the 65,536-vertex graph;
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
   as `build_gnn` makes it, F capped at 128, hidden 64, T=256), the
   fused forward (`fused_engn_sum_train`, widths 128 -> 64 and 64 -> 3,
   beside `torch.sparse.mm(A, X @ W)`), and every backward, each over
   the FORWARD carrier (no carrier of A^T is built): the sums' A^T G
   (`rer_spmm_sum_t` over the dense tiles, `rer_gather_sum_t` over the
   bucket groups' work table, beside `torch.sparse.mm(A^T, G)`; the
   fused backward, `rer_spmm_sum_t` plus two matrix products, is checked
   and timed on a line of its own, outside the kernels' record) and
   both max backwards (`rer_spmm_bwd_max` over the tiles, and the packed
   one, `packed_max_backward`, on three plans of the training graph's
   edges: its GCN-normalised weights, every weight 1 at widths 256 and
   41 as GS-Pool's benchmark plan has, and the normalised weights
   halved so that none is 1; a quarter of each cotangent's rows 0):
   its winner words (`rer_gather_bwd_count`, `_count_unit`), its
   resolve pass on the unit plan (`rer_gather_bwd_resolve`) and the
   whole backward (`rer_gather_bwd_max`, `_max_unit`, and the halved
   plan's on a line of its own), each against its plain
   version (integer words `torch.equal`, sums within 1e-5 of the
   output's largest magnitude);
   B4 (`fused_linear_act`) through its entry point at the three stages
   whose function it computes on uncut pubmed (GS-Pool extraction 500 x
   64, GS-Pool update 564 x 64, GCN afu 500 x 64), against the layers'
   own stage output and its plain version, timed beside `torch.addmm` +
   relu;
7. training path: `build_gnn` on uncut pubmed, 10 steps each, GCN on
   "blocked" dense / packed and "fused", GS-Pool on "blocked" dense /
   packed (multi-edges merged), each trajectory against the same run on
   "segment" (`allclose(rtol=1e-3, atol=1e-4)`) and one step's
   gradients against the plain versions' own autograd; every run's plan
   must hold after its 10 steps exactly the bytes it held before them
   (`PreparedPlan.held_bytes`: no backward built a carrier of A^T), and
   each prints its plan + state and peak memory; GS-Pool packed must
   make one count and one scatter launch per layer a step, GCN packed
   one sum-backward launch per layer; then `run_gnn` through
   `FaultTolerantRunner` and `CheckpointManager`, and again from its
   checkpoint;
8. staged models (R-GCN, Gated-GCN): first B1 once per relation
   (`rer_spmm_sum_typed_aifb` / `_pubmed`: every relation's calls of one
   forward against the plain version, in the record; each relation's
   time, bound and `torch.sparse.mm` on its A, printed); then the typed
   pair projection at the BGS packed plan's pairs, both layers' widths
   (`typed_pairs_project_bgs`, `_grad_w_bgs`, `_grad_x_bgs`: each pass
   against its plain version, beside the (N, R*H) einsum payload route
   it replaced); then inference
   through the entry points: the AIFB stand-in (8,285 V, 29,043 E, 45
   relations) R-GCN [91, 16, 4] on "segment", "blocked" dense (B1 once
   per relation a layer) and packed; the BGS stand-in (333,845 V,
   2,166,243 E, 103 relations) R-GCN [207, 16, 2] on "segment" and
   "blocked" packed (the packed R-GCN runs on the pair kernels); merged
   pubmed Gated-GCN [500, 64, 3] on "segment"
   and "blocked" packed, each against "segment" (`allclose(rtol=1e-4,
   atol=1e-5)`), each with its plan bytes beside what the budget gate
   priced; the gated dense plan at pubmed refused before it allocates;
9. staged tiled: R-GCN at AIFB under a 4 MB budget and Gated-GCN at
   pubmed under 32 MB, each spilled to "tiled" and held against its
   resident result, with its `TiledStats`;
10. staged training: `build_gnn` on uncut pubmed, 10 steps, R-GCN (3-type
   colouring) on "segment" and "blocked" dense (6 B1 and 6 B1^T launches
   a step) and packed (the pair kernels' forward, dW and dX), Gated-GCN
   on "segment" and "blocked" packed:
   losses against "segment" (rtol=1e-3, atol=1e-4), one step's gradients
   against "segment"'s, the plan's bytes unchanged by training;
11. streamed training: `build_gnn` on uncut pubmed [128, 64, 3], batch
   256, AdamW, T=256, 6 steps each: (a) GCN spilled from "blocked" by a
   30 MB budget the chunk queue fits (B5 forward, B5^T backward over the
   forward queue), (b) the same with streaming_mode="callback" (B2's tile
   part forward and backward over the transposed stores), (c) GS-Pool on
   "tiled" (max, multi-edges merged: the callback route), (d) R-GCN on
   "tiled" (the typed VJP), (e) Gated-GCN on "tiled" (the gated VJP), and
   (f) GCN on synthD at 65,536 V [50, 64, 16] under phase 5's 32 MB
   budget, one step: losses against the same run on "segment" (rtol=1e-3,
   atol=1e-4), one step's gradients against "segment"'s, the route
   asserted (queue launches and B5^T on (a), backward tiles on the
   others), each with its ms/step, peak memory beside its budget and
   its `TiledStats`; then B5^T (`chunk_queue_sum_t`) at (a)'s queue and
   widths against its plain version, beside `torch.sparse.mm(A^T, G)`;
12. int8 tile values, the measured tile format and T = 2048: (a) pubmed
   GCN [500, 64, 3] on "tiled", packed, `tile_value_dtype="int8"`, on the
   callback route (inference) and the queue route (the differentiable
   forward; the int8 queue is the slab sweep on the card, the
   reference's route), each against the fp32 run on its route and
   "segment" within the reference's int8 envelope (mean relative error
   < 0.015, max < 0.15, relative to max(|ref|, 1)), its value bytes under
   0.3 of fp32's and its quantised arrays (the error-feedback residuals,
   the queue's slabs and scales) equal to the same calls' on the CPU;
   (b) phase 11's runs (a) and (b) with int8 values, 6 steps, the losses
   finite and within `INT8_LOSS_RTOL` / `INT8_LOSS_ATOL` of the fp32
   runs'; (c) blocked packed GCN and GS-Pool plans with int8 values keep
   fp32 bucket groups (`blocks_meta["value_dtype"] == "fp32"`, the groups
   equal the fp32 plan's, GS-Pool's output `torch.equal`, GCN's within
   the atomics' rounding); (d) `TiledExecutor(autotune_measure=True)` on
   pubmed and synthD (65,536 V, d = 64): the format picked, the dense
   and packed step times (B2's tile part) and the cache hit of a second
   executor; (e) fault C3: pubmed GCN [128, 64, 3] on "tiled" at T =
   2048, no budget: one forward, one step's gradients and two steps on
   the queue route (B5 at the feature chunk `feature_chunk` gives, B5^T)
   against "segment" (phase 11's tolerances); then B5 and B5^T at that
   queue (`chunk_queue_sum_t2048`, `chunk_queue_sum_t_t2048`, widths 64
   and 3) against their plain versions, beside `torch.sparse.mm`;
13. serving and dynamic graphs, on uncut pubmed (phase 4's graph) with
   GCN [500, 64, 3] on "segment" on the card and zipf requests as
   `examples/serve_gnn.py` makes them: (a) 64 requests with exact 2-hop
   extraction, each response against the full-graph forward
   (`allclose(rtol=1e-4, atol=1e-5)`); (b) the example's configuration
   (fanout 16, a 2,048-row cache, half of it pinned), 200 requests: req/s,
   vertices/s, latency p50 / p99, the hit rate, buckets seen and the mean
   subgraph, then one batch's time split by stage (extraction, upload +
   stack, read back; host clock around `torch.cuda.synchronize`); (c) the
   async pipeline on the example's flash crowd, ok + shed = 200; (d) GCN
   (fanout 16) and GS-Pool (exact extraction) with a budget under every
   batch's price: every batch streamed through the tiled executor (B2's
   tile part, sum and max), held against the unbudgeted engine; (e) two
   replicas against (a); (f) 1,000 inserts and 1,000 deletes in one epoch:
   (f1) an exact cached engine through (b)'s traffic and
   `ServingPipeline.apply_updates` against a cold engine on the epoch
   graph, (f2) a 30 MB spill of GCN blocked packed through `update_plan`
   (one merge, one store build) against a fresh plan, and a queue
   executor through `apply_updates`, whose next sum runs B5 on the merged
   store, against a fresh executor;
14. the sharded ring (`backend="ring"`, its P shards co-located on the
   card, feature shards rotating by copies; no kernel of its own, as the
   reference's ring is XLA): (a) `examples/multipod_ring.py`'s
   configuration (R-MAT 2,048 V / 40,000 E, GCN 64 -> 32, P = 8) against
   "segment" (1e-4), with its shards, format, MB a shard, hops and MB
   rotated an aggregate, and fill factor; (b) uncut pubmed GCN and GS-Pool
   [500, 64, 3] at P = 4, T = 256, dense and packed, GCN within 1e-4 /
   1e-5 of "segment", GS-Pool `torch.equal` to phase 4's blocked run of
   the same format, each forward timed beside that blocked forward; (c)
   AIFB R-GCN on both formats and pubmed Gated-GCN packed against their
   "segment" runs, and the gated dense ring refused (B6); (d)
   `build_gnn` on the ring, GCN and GS-Pool [128, 64, 3], dense and
   packed, 10 steps, losses against "segment" (rtol 1e-3, atol 1e-4),
   hops a step, the plan's bytes unchanged; `run_gnn --gnn-backend ring
   --gnn-shards 4` and its resume; (e) `ElasticGNNTrainer` on GCN: a
   shard loss (4 -> 3), three straggler strikes (-> 2), a 30 MB per-shard
   budget and a shard loss (-> `tiled`), the losses on "segment"'s and
   each re-mesh's seconds; (f) serving pubmed GCN with `ring_shards=4`
   under a budget every batch's own plan exceeds and its ring plan fits:
   every batch on the ring, within 1e-5 of the unbudgeted engine;
15. seeded chaos, elastic restore and the LM stack: (a) the reference's
   chaos acceptance scenario (a transient at step-call 3, a torn "leaf"
   save at 5, the loss of 2 shards at 7, a 50 s straggler at 10) against
   GCN on an 8-shard co-located ring, 12 steps, pubmed as `build_gnn`
   makes it (4,000 V, hidden 32, batch 256): each fault fired once, 12
   steps, one re-mesh to 6 shards, 2 failures, a restore, MTTR > 0 on
   the virtual clock, the last loss within rtol 5e-3 of the fault-free
   "segment" run's; (b) `run_gnn --gnn gcn --gnn-backend blocked
   --chaos-seed 3 --steps 20 --ckpt-every 4` with dense and with packed
   tiles: the plan `FaultPlan.sample(3, 20)`, every event fired, the
   last loss finite and below the first, B1 / B2 and their backwards
   launched; (c) `elastic_restore` of (b)'s newest good checkpoint onto
   `make_elastic_mesh()`: parameters and moments on the card, count and
   cursor kept, the resumed step's loss within rtol 1e-5 of an
   uninterrupted run's; (d) `launch/train.py --arch granite_3_2b` at its
   full config (40 layers, d_model 2048, batch 1, seq 512, 4 steps):
   finite losses that change each step, the median step time of steps
   2-4, tokens/s, peak memory, model FLOPs (6 x params x tokens) and
   their rate; (e) one config of each other family at full width and
   seq 512, two steps: moonshot and falcon-mamba at 2 layers,
   llama-3.2-vision at one period (5 layers), seamless whole, jamba at
   SMOKE (one full-width period is 45 B parameters).  The LM runs
   launch no kernel (the reference's LM stack is XLA);
16. prefill, decode, the all-to-all MoE and the dry run: (a)
   granite_3_2b whole (40 layers, d_model 2048) serving a 512-token
   prompt from `SyntheticTokenStream` (seed 0) at batch 8, then 64 greedy
   `decode_step`s: prefill ms, decode ms a token (median of steps 2-64),
   tokens/s, peak GiB, KV-cache MiB and the step's byte bound ((bf16
   weights + the live KV) / 3.35 TB/s), on a bf16 compute copy made once
   (`cast_params_for_compute`, timed), beside 8 decode steps on the fp32
   weights (the reference's cast at every use); weights drawn at std 0.02
   (ROADMAP §C note 4); (b) at granite's full width, prefill(511) plus
   `decode_step` of token 512 against prefill(512)'s last logits (rtol =
   atol = 3e-2, `tests/test_arch_smoke.py::test_smoke_decode_matches_
   prefill_suffix`), held in fp32, with the bf16 difference printed
   beside bf16 prefill's own distance from fp32 prefill; (c) falcon-mamba, llama-3.2-vision, seamless and
   moonshot whole, jamba SMOKE, bf16, the same prompt length, 16 decode
   steps each; (d) `moe_ffn_a2a` on a co-located (2, 4) mesh: moonshot at
   full width cut to 2 layers in fp32, a training step's loss and
   gradients and a prefill + 8 decode steps against the dense dispatch
   on no mesh (output rtol = atol = 2e-4, gradients rtol 5e-3 / atol
   5e-4, `tests/test_moe_a2a.py`'s) at capacity factor ceil(E / k) = 11,
   where no block drops a token (counted: none may), every MoE call of
   the mesh runs through the a2a; the same at 8.0 (the reference test's
   no-drop setting for its 8 experts top-2) with its drops and
   differences printed; then one training step at 1.25 timed beside the
   dense one; (e) the dry run
   (`launch/dryrun.py::run_cell`) of granite_3_2b's train_4k,
   prefill_32k and decode_32k cells on the single (16, 16) mesh, on
   `meta`: status and roofline terms.  No kernel of its own.
Launch counters are zeroed just before each path phase (4, 5, the B4
calls of 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16; in 8 and 9 the first
forward of each run)
and read just after (a record's launches are its
kernel's over every phase; `fused_engn_sum` counts the inference
phase's, `fused_engn_sum_train` the training phase's); each run must
have launched its
kernels (a blocked packed forward and sum backward `rer_gather` once per
layer), and each inference run must match the "segment" backend on the
card (`allclose(rtol=1e-4, atol=1e-5)`).

The line before the last is the kernels' JSON record; the last line is
`{"ok": true, "device": {...}}`.
"""
from __future__ import annotations

import argparse
import dataclasses
import gc
import json
import math
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
TRAIN_STEPS = 10                  # phases 7 and 10
STREAM_STEPS = 6                  # phase 11's streamed training runs
# int8 tile values: the reference's documented envelope on an aggregate or
# layer output (relative to max(|fp32|, 1); tests/test_compression.py),
# and the loss tolerance against the fp32 run (phase 12 (b)): the loss
# is a smooth function of outputs held to that envelope, so a loss off by
# more than its mean share (plus an absolute floor for losses near 0)
# means the int8 path diverged, not that it rounded
INT8_MEAN_REL, INT8_MAX_REL = 0.015, 0.15
INT8_LOSS_RTOL, INT8_LOSS_ATOL = 0.015, 1e-3
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
    counted_by = {}     # record -> (launch counter, phase labels or None)

    def kernel_case(name, source, replaces, calls, exact, nbytes, ops,
                    library=None, record=True, rel=None, counter=None,
                    phases=None):
        """calls: (kernel thunk, plain thunk) for one forward's calls;
        `record=False` checks and times a variant no path launches,
        printed on its own line and kept out of the record (as is a call
        form whose launches another record counts).  `rel` holds
        a sum to within rel x the plain output's largest magnitude (and
        rtol rel) instead of RTOL/ATOL.  `counter`, `phases`: the launch
        counter a record reads (default its name) and the path phases
        counted (default all)."""
        counted_by[name] = (counter or name, phases)
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

    def b5t_bytes(tq, gs):
        """What B5^T reads once and writes once: per width, the entries
        (12 B each), its source table, G, and dX."""
        return sum(nb(tq.rows, tq.cols, tq.vals, tq.tpieces, tq.tsrc_ptr,
                      tq.tsrc_tiles, tq.tile_dst, g, g) for g in gs)

    def real_entries(groups):
        """Real entries of a plan's bucket groups (pads excluded)."""
        return sum(int(gather_ops.real_counts(gr["rows"], gr["cols"],
                                              gr["vals"]).sum())
                   for gr in groups)

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
        nnz_entries = real_entries(groups)
        print(f"packed pubmed: {len(groups)} bucket groups, S = "
              f"{[gr['rows'].shape[1] for gr in groups]}, {nnz_entries} "
              f"real entries")
        for op in ("sum", "max"):
            calls = [(lambda x=x, op=op: gather_ops.packed_groups_spmm(
                          groups, x, q=q, op=op),
                      lambda x=x, op=op: gather_ops.packed_groups_plain(
                          groups, x, q=q, op=op)) for x in xs]
            kernel_case(
                f"rer_gather_{op}", "src/repro_torch/csrc/rer_gather.cu",
                "src/repro/kernels/rer_gather/rer_gather.py:103", calls,
                exact=op == "max",
                nbytes=sum(12 * nnz_entries + nb(x, x) for x in xs),
                ops=sum(2 * nnz_entries * x.shape[1] for x in xs),
                library=(None if op == "max" else
                         lambda: [torch.sparse.mm(a_pub, x[:g_pub.num_vertices])
                                  for x in xs]))
            # the single-group raw form (finish=False keeps -inf), which
            # no path launches: checked and timed, out of the record; it
            # builds its work table at each call, and its time holds that
            kernel_case(
                f"rer_gather_{op}_raw_groups",
                "src/repro_torch/csrc/rer_gather.cu",
                "src/repro/kernels/rer_gather/rer_gather.py:103",
                [(lambda gr=gr, x=x, op=op: gather_ops.packed_spmm(
                      gr["rows"], gr["cols"], gr["vals"], gr["block_row"],
                      gr["block_col"], x, q=q, op=op, finish=False),
                  lambda gr=gr, x=x, op=op: gather_ops.packed_spmm_plain(
                      gr["rows"], gr["cols"], gr["vals"], gr["block_row"],
                      gr["block_col"], x, q=q, op=op, finish=False))
                 for x in xs for gr in groups],
                exact=op == "max",
                nbytes=sum(12 * nnz_entries + len(groups) * nb(x, x)
                           for x in xs),
                ops=sum(2 * nnz_entries * x.shape[1] for x in xs),
                record=False)
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
        cols = cf["fused_columns"]
        kernel_case(
            "fused_engn_sum", "src/repro_torch/csrc/fused_engn.cu",
            "src/repro/kernels/fused_engn/fused_engn.py:60",
            [(lambda x=x, w=w: fused_ops.fused_engn_layer(
                  cf["blocks"], cf["block_row"], cf["block_col"], x, w, q=q,
                  columns=cols),
              lambda x=x, w=w: fused_ops.fused_engn_plain(
                  cf["blocks"], cf["block_row"], cf["block_col"], x, w, q=q))
             for x, w in pairs],
            exact=False, phases=("inference",),
            nbytes=sum(nb(cf["blocks"], cf["block_row"], cf["block_col"],
                          *cols, x, w) + npad * w.shape[1] * 4
                       for x, w in pairs),
            ops=sum(2 * npad * w.shape[0] * w.shape[1]
                    + 2 * nnz_cora * w.shape[1] for _, w in pairs),
            library=lambda: [torch.sparse.mm(a_cora, x[:n_cora] @ w)
                             for x, w in pairs])
        del fused, cf, cols

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
        # what the kernel reads once: the entries, its work table, X; and
        # Y written once
        q_bytes = nb(tq.wrows, tq.wsrc, tq.wvals, tq.pieces, x_big, x_big)
        gathered = tq.entries * f_syn * 4
        print(f"chunk_queue: {tq.pieces.shape[0]} pieces, {tq.n_split} "
              f"split intervals; the gathers move {gathered / 1e6:.1f} MB "
              f"({gathered / HBM_BYTES_PER_S * 1e3:.4f} ms at HBM rate) if "
              f"no X row is reused from L2 (not a bound)")
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
                counter="chunk_queue_sum")
        del a_big
        # B5^T on the same queue and width, beside torch.sparse.mm(A^T, G):
        # its launches are the streamed-training phase's
        print(f"chunk_queue_t: piece {tq.t_piece}, {tq.tpieces.shape[0]} "
              f"pieces, {tq.t_split} split source intervals")
        at_big = csr(COOGraph(g_big.num_vertices, g_big.dst, g_big.src,
                              g_big.weights()))
        kernel_case(
            "chunk_queue_sum_t_synthd", "src/repro_torch/csrc/chunk_queue.cu",
            "src/repro/kernels/chunk_queue/chunk_queue.py:132",
            [(lambda: queue_ops.tile_queue_t(tq, x_big),
              lambda: queue_ops.tile_queue_t_plain(tq, x_big))],
            exact=False, rel=NEW_RTOL, nbytes=b5t_bytes(tq, [x_big]),
            ops=2 * tq.entries * f_syn,
            library=lambda: torch.sparse.mm(at_big, x_big),
            counter="chunk_queue_sum_t", phases=("streamed_training",))
        del tq, x_big, at_big, packed_big

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
                nbytes=sum(12 * real + nb(x) + 256 * x.shape[2] * 4
                           for (*_, real), x in zip(staged, xs)),
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
            if fmt == "packed" and grew != len(dims) - 1:
                raise AssertionError(f"{label}: {kern} launched {grew} "
                                     f"times, not once per layer")
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
            once = " (once per layer)" if graph.tile_format == "packed" else ""
            print(f"path {label}: {grew} launches/forward{once}, max abs err vs "
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
    a_tr = csr(g_tr)
    a_tr_t = csr(COOGraph(n_tr, g_tr.dst, g_tr.src, g_tr.weights()))
    with torch.inference_mode():
        # a max config: the dense plan carries the max backward's
        # row counts, as GS-Pool's does
        cfg_tr = rt.EnGNConfig(f_tr, 64, backend="blocked", tile=256,
                               tile_format="dense", aggregate_op="max")
        plan_d = rt.prepare_graph(g_tr, cfg_tr)
        cd = plan_d.carrier
        q, npad = cd["blocks_meta"]["q"], cd["blocks_meta"]["padded"]
        carrier = (cd["blocks"], cd["block_row"], cd["block_col"])
        nnz_tr = int(torch.count_nonzero(cd["blocks"]))
        print(f"training dense carrier: {cd['blocks'].shape[0]} tiles, "
              f"{plan_d.footprint_bytes / 1e9:.3f} GB (every backward walks "
              f"it; no A^T)")

        def rows_n(t):
            t[n_tr:] = 0
            return t
        gs = [rows_n(feats(npad, w)) for w in widths_tr]
        # max inputs like GS-Pool's relu extraction: half zeros, ties
        xs_max = [rows_n(torch.relu(feats(npad, w))) for w in widths_tr]
        ys_max = [spmm_ops.blocked_spmm(*carrier, x, q=q, op="max")
                  for x in xs_max]
        kernel_case(
            "rer_spmm_sum_t", "src/repro_torch/csrc/rer_spmm.cu",
            "src/repro/kernels/rer_spmm/rer_spmm.py:74",
            [(lambda g=g: spmm_ops.blocked_spmm_t(*carrier, g, q=q),
              lambda g=g: spmm_ops.blocked_spmm_t_plain(*carrier, g, q=q))
             for g in gs],
            exact=False, rel=NEW_RTOL,
            nbytes=sum(nb(*carrier, g, g) for g in gs),
            ops=sum(2 * nnz_tr * g.shape[1] for g in gs),
            library=lambda: [torch.sparse.mm(a_tr_t, g[:n_tr]) for g in gs])
        counts = cd["row_counts"]
        print(f"max backward slabs: R = {counts.rows} rows, fullest slab "
              f"{spmm_bwd_ops.slab_max(counts.dev.cpu().numpy(), 256, 16)} "
              f"nonzeros at R = 16 (list {spmm_bwd_ops.LIST_CAP})")
        kernel_case(
            "rer_spmm_bwd_max", "src/repro_torch/csrc/rer_spmm_bwd.cu",
            "src/repro/kernels/rer_spmm/rer_spmm.py:74",
            [(lambda x=x, y=y, g=g: spmm_bwd_ops.blocked_spmm_max_bwd(
                  cd["blocks"], cd["block_row"], cd["block_col"], x, y, g,
                  q=q, counts=counts),
              lambda x=x, y=y, g=g: spmm_bwd_ops.blocked_spmm_max_bwd_plain(
                  cd["blocks"], cd["block_row"], cd["block_col"], x, y, g,
                  q=q))
             for x, y, g in zip(xs_max, ys_max, gs)],
            exact=False, rel=NEW_RTOL,
            nbytes=sum(nb(cd["blocks"], cd["block_row"], cd["block_col"],
                          counts.dev, x, y, g, x)
                       for x, y, g in zip(xs_max, ys_max, gs)),
            ops=sum(4 * nnz_tr * x.shape[1] for x in xs_max))
        # the fused forward at the training path's shapes, on the same
        # tiles with the column table a fused plan builds
        cols = fused_ops.column_table(cd["block_col"].cpu().numpy(), q, dev)
        pairs = [(rows_n(feats(npad, f_tr)), feats(f_tr, 64)),
                 (rows_n(feats(npad, 64)), feats(64, c_tr))]
        kernel_case(
            "fused_engn_sum_train", "src/repro_torch/csrc/fused_engn.cu",
            "src/repro/kernels/fused_engn/fused_engn.py:60",
            [(lambda x=x, w=w: fused_ops.fused_engn_layer(
                  cd["blocks"], cd["block_row"], cd["block_col"], x, w, q=q,
                  columns=cols),
              lambda x=x, w=w: fused_ops.fused_engn_plain(
                  cd["blocks"], cd["block_row"], cd["block_col"], x, w, q=q))
             for x, w in pairs],
            exact=False, rel=NEW_RTOL, counter="fused_engn_sum",
            phases=("training",),
            nbytes=sum(nb(cd["blocks"], cd["block_row"], cd["block_col"],
                          *cols, x, w) + npad * w.shape[1] * 4
                       for x, w in pairs),
            ops=sum(2 * npad * w.shape[0] * w.shape[1]
                    + 2 * nnz_tr * w.shape[1] for _, w in pairs),
            library=lambda: [torch.sparse.mm(a_tr, x[:n_tr] @ w)
                             for x, w in pairs])
        del cols, pairs
        # the fused backward at both layers' shapes: [128 -> 64], [64 -> 3]
        fused_in = [(rows_n(feats(npad, f_tr)), feats(f_tr, 64), gs[0]),
                    (rows_n(feats(npad, 64)), feats(64, c_tr), gs[1])]

        def flat_bwd(fn, x, w, g):
            dx, dw = fn(*carrier, x, w, g, q=q)
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
            nbytes=sum(nb(*carrier, x, w, g, x, w) for x, w, g in fused_in),
            ops=sum(2 * nnz_tr * w.shape[1] + 4 * npad * w.shape[0]
                    * w.shape[1] for x, w, g in fused_in))
        del plan_d, cd, carrier, xs_max, ys_max, fused_in, counts

        plan_p = rt.prepare_graph(g_tr, dataclasses.replace(
            cfg_tr, tile_format="packed"))
        cp = plan_p.carrier
        groups = cp["packed_groups"]
        nnz_p = real_entries(groups)
        group_bytes = sum(nb(*gr.values()) for gr in groups)
        print(f"training packed carrier: {len(groups)} groups, "
              f"{plan_p.footprint_bytes / 1e6:.3f} MB, {nnz_p} real entries, "
              f"{groups.work.n_seg} segments (every backward walks it; no "
              f"A^T)")
        kernel_case(
            "rer_gather_sum_t", "src/repro_torch/csrc/rer_gather_bwd.cu",
            "src/repro/kernels/rer_gather/rer_gather.py:103",
            [(lambda g=g: gather_bwd_ops.packed_groups_t(groups, g, q=q),
              lambda g=g: gather_bwd_ops.packed_groups_t_plain(groups, g,
                                                               q=q))
             for g in gs],
            exact=False, rel=NEW_RTOL,
            nbytes=sum(12 * nnz_p + nb(g, g) for g in gs),
            ops=sum(2 * nnz_p * g.shape[1] for g in gs),
            library=lambda: [torch.sparse.mm(a_tr_t, g[:n_tr]) for g in gs])
        # the max backward on three plans of the training graph's edges:
        # "norm", its GCN-normalised weights at the training widths (a
        # share of them 1); "unit", every weight 1 as GS-Pool's benchmark
        # plan has, at that plan's widths 256 and 41 (lone winners of
        # weight 1, ties at the ReLU's 0); "half", the
        # normalised weights halved, none 1 (every word a count, every
        # row with a winner and a nonzero g walked); a quarter of the
        # rows of each g are 0
        def max_plan(w):
            pl = rt.prepare_graph(COOGraph(n_tr, g_tr.src, g_tr.dst, w),
                                  dataclasses.replace(cfg_tr,
                                                      tile_format="packed"))
            if pl.carrier["blocks_meta"]["q"] != q:
                raise AssertionError("a max plan of the training graph has "
                                     "another interval count")
            return pl.carrier["packed_groups"]

        def g_rows0(g):
            g[::4] = 0
            return g
        w_tr = g_tr.weights()
        mplans = {"norm": (groups, widths_tr),
                  "unit": (max_plan(np.ones_like(w_tr)), [256, 41]),
                  "half": (max_plan(w_tr * 0.5), widths_tr)}
        mx = {}
        for key, (grs, ws) in mplans.items():
            xs = [rows_n(torch.relu(feats(npad, w))) for w in ws]
            ys = [gather_ops.packed_groups_spmm(grs, x, q=q, op="max")
                  for x in xs]
            gz = [g_rows0(rows_n(feats(npad, w))) for w in ws]
            words = [gather_bwd_ops.packed_max_words_plain(grs, x, y, q=q)
                     for x, y in zip(xs, ys)]
            mx[key] = (grs, real_entries(grs), list(zip(xs, ys, gz, words)))
        lone = sum(int((w < 0).sum()) for *_, w in mx["unit"][2])
        won = sum(int((w != 0).sum()) for *_, w in mx["unit"][2])
        print(f"max backward plans: real entries "
              f"{ {k: v[1] for k, v in mx.items()} }; unit plan: "
              f"{lone / max(won, 1):.4f} of the (row, feature) pairs with a "
              f"winner have one of weight 1")
        for key, counter in (("norm", None), ("unit", "rer_gather_bwd_count")):
            grs, nnz, ins = mx[key]
            kernel_case(
                "rer_gather_bwd_count" + ("" if counter is None
                                          else "_" + key),
                "src/repro_torch/csrc/rer_gather_bwd.cu",
                "src/repro/kernels/rer_gather/rer_gather.py:103",
                [(lambda x=x, y=y, grs=grs: gather_bwd_ops.packed_max_words(
                      grs, x, y, q=q),
                  lambda x=x, y=y, grs=grs:
                  gather_bwd_ops.packed_max_words_plain(grs, x, y, q=q))
                 for x, y, _, _ in ins],
                exact=True, counter=counter,
                nbytes=sum(12 * nnz + nb(x, y, w) for x, y, _, w in ins),
                ops=sum(2 * nnz * x.shape[1] for x, *_ in ins))

        def resolved(fn, w, g):
            dx, flag = fn(w, g)
            return torch.cat([dx.reshape(-1), flag.float()])
        grs, nnz, ins = mx["unit"]
        kernel_case(
            "rer_gather_bwd_resolve", "src/repro_torch/csrc/rer_gather_bwd.cu",
            "src/repro/kernels/rer_gather/rer_gather.py:103",
            [(lambda w=w, g=g: resolved(gather_bwd_ops.packed_max_resolve,
                                        w, g),
              lambda w=w, g=g: resolved(
                  gather_bwd_ops.packed_max_resolve_plain, w, g))
             for _, _, g, w in ins],
            exact=False, rel=NEW_RTOL,
            nbytes=sum(nb(w, g, g) + 4 * g.shape[0] for _, _, g, w in ins),
            ops=sum(g.numel() for _, _, g, _ in ins))
        for key, counter in (("norm", None), ("unit", "rer_gather_bwd_max"),
                             ("half", "rer_gather_bwd_max")):
            grs, nnz, ins = mx[key]
            kernel_case(
                "rer_gather_bwd_max" + ("" if counter is None
                                        else "_" + key),
                "src/repro_torch/csrc/rer_gather_bwd.cu",
                "src/repro/kernels/rer_gather/rer_gather.py:103",
                [(lambda x=x, y=y, g=g, grs=grs:
                  gather_bwd_ops.packed_max_backward(grs, x, y, g, q=q),
                  lambda x=x, y=y, g=g, grs=grs:
                  gather_bwd_ops.packed_max_backward_plain(grs, x, y, g,
                                                           q=q)[0])
                 for x, y, g, _ in ins],
                exact=False, rel=NEW_RTOL, counter=counter,
                record=key != "half",
                nbytes=sum(24 * nnz + nb(x, y, g, w, w, x)
                           for x, y, g, w in ins),
                ops=sum(4 * nnz * x.shape[1] for x, *_ in ins))
        del plan_p, cp, groups, mplans, mx, gs

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
                "rer_gather_bwd_count", "rer_gather_bwd_resolve",
                "rer_gather_bwd_max")
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
         ("rer_gather_max", "rer_gather_bwd_count", "rer_gather_bwd_resolve",
          "rer_gather_bwd_max")),
    ]
    seg_losses, train_table = {}, []
    K.reset_launch_counts()
    for label, model, backend, fmt, kerns in train_runs:
        mem0 = torch.cuda.memory_allocated()
        tr, state, data = build_run(model, backend, fmt)
        held = tr.plan.held_bytes()           # as prepare_graph built it
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
        if tr.plan.held_bytes() != held:
            raise AssertionError(f"{label}: the plan held {held} B before "
                                 f"training and {tr.plan.held_bytes()} B "
                                 f"after: a backward built a carrier")
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
        if fmt == "packed":
            # one launch per layer forward, and per layer backward pass:
            # the sum's A^T G, or the max's count, resolve and tie walk
            once = ({"rer_gather_max": 2, "rer_gather_bwd_count": 2,
                     "rer_gather_bwd_resolve": 2,
                     "rer_gather_bwd_max": 2} if model == "gs_pool"
                    else {"rer_gather_sum": 2, "rer_gather_sum_t": 2})
            for k, v in once.items():
                if per_step.get(k) != v:
                    raise AssertionError(f"{label}: {k} {per_step.get(k)} "
                                         f"launches/step, not one per layer")
            print(f"train {label}: one launch per layer per pass a step "
                  f"{once}")
        bwd = sum(v for k, v in per_step.items() if k in bwd_keys)
        row = {"run": label, "plan": f"{tr.plan.backend}/"
               f"{tr.plan.tile_format}",
               "ms_per_step": statistics.median(times[1:]),
               "first_step_ms": times[0], "launches_per_step": per_step,
               "bwd_launches_per_step": bwd,
               "plan_and_state_mib": (base - mem0) / 2**20,
               "peak_mib": peak / 2**20,
               "footprint_bytes": tr.plan.footprint_bytes,
               "held_bytes": held,
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
              f"{row['footprint_bytes']} B, plan holds {held} B before and "
              f"after training (no A^T), loss {losses[0]:.4f} -> "
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

    # -- the staged models: R-GCN and Gated-GCN --------------------------------
    # AIFB and BGS stand-ins at full size (Table 5: 8,285 V / 29,043 E / 45
    # relations; 333,845 V / 2,166,243 E / 103 relations), R-GCN at
    # Schlichtkrull et al.'s entity-classification width (hidden 16);
    # Gated-GCN on the merged pubmed graph [500, 64, 3].  Every inference
    # run is held against "segment" on the card; the tiled runs against
    # the resident result; the training runs' losses against "segment".
    gc.collect()
    torch.cuda.empty_cache()
    from repro_torch.core.engn import fold_rel_norm, gate_bytes
    from repro_torch.core.tiled import DeviceBudgetExceeded

    def typed_dataset(name):
        g, f, c = make_dataset(name, seed=0)
        return g, random_features(g.num_vertices, f, seed=1), f, c

    aifb, bgs = typed_dataset("aifb"), typed_dataset("bgs")
    for name, (g, _, f, c) in (("aifb", aifb), ("bgs", bgs)):
        print(f"graph {name}: |V|={g.num_vertices} |E|={g.num_edges} "
              f"relations={g.num_relations} F={f} classes={c}")

    def staged_stack(model, dims, backend, fmt="auto", rels=1, budget=None):
        layers = rt.make_gnn_stack(model, dims, backend=backend,
                                   num_relations=rels, tile=256)
        for layer in layers:
            layer.cfg.tile_format = fmt
            layer.cfg.device_budget_bytes = budget
        return layers

    def gate_price(g, cfg, h):
        """What the budget gate prices for the plan (`engn.gate_bytes`: a
        typed dense plan at its typed keys and pads, any other at the
        reference's closed form)."""
        return gate_bytes(g, cfg, h)

    def typed_b1_rows(label, plan, g, widths, phase):
        """B1 once per relation at one typed dense plan's shapes (the
        payload widths of both layers): one record over every relation
        (one forward's calls), then each relation's own time, bound and
        `torch.sparse.mm` on that relation's A, printed."""
        gf = fold_rel_norm(g)
        n = g.num_vertices
        blks = plan.carrier["typed_blocks"]
        pad = plan.carrier["blocks_meta"]["padded"]
        calls, libs, per_rel = [], [], []
        nbytes = ops = 0
        for blk in blks:
            m = gf.rel == blk["rel"]
            a = csr(COOGraph(n, gf.src[m], gf.dst[m], gf.weights()[m]))
            nnz = int(torch.count_nonzero(blk["blocks"]))
            xs_r = [feats(pad, w) for w in widths]
            rc = [(lambda b=blk, x=x: spmm_ops.blocked_spmm(
                       b["blocks"], b["block_row"], b["block_col"], x,
                       q=b["q"], op="sum"),
                   lambda b=blk, x=x: spmm_ops.blocked_spmm_plain(
                       b["blocks"], b["block_row"], b["block_col"], x,
                       q=b["q"], op="sum")) for x in xs_r]
            rb = sum(nb(blk["blocks"], blk["block_row"], blk["block_col"],
                        x, x) for x in xs_r)
            ro = sum(2 * nnz * x.shape[1] for x in xs_r)
            rl = (lambda a=a, xs_r=xs_r: [torch.sparse.mm(a, x[:n])
                                          for x in xs_r])
            calls += rc
            libs.append(rl)
            nbytes += rb
            ops += ro
            per_rel.append((blk["rel"], int(blk["blocks"].shape[0]), nnz,
                            rc, rb, ro, rl))
        kernel_case(
            f"rer_spmm_sum_typed_{label}", "src/repro_torch/csrc/rer_spmm.cu",
            "src/repro/kernels/rer_spmm/rer_spmm.py:74", calls, exact=False,
            nbytes=nbytes, ops=ops, library=lambda: [f() for f in libs],
            counter="rer_spmm_sum", phases=(phase,))
        table = []
        for rel, tiles, nnz, rc, rb, ro, rl in per_rel:
            t_b, t_o = rb / HBM_BYTES_PER_S * 1e3, ro / FP32_OPS_PER_S * 1e3
            table.append({"rel": rel, "tiles": tiles, "nnz": nnz,
                          "ms": cuda_ms(lambda rc=rc: [k() for k, _ in rc]),
                          "bound_ms": max(t_b, t_o),
                          "bound_by": "bytes" if t_b >= t_o else "operations",
                          "library_ms": cuda_ms(rl)})
        tot = {k: sum(r[k] for r in table)
               for k in ("tiles", "ms", "bound_ms", "library_ms")}
        print(f"typed B1 {label} [{smi}]: {len(table)} relations, "
              f"{tot['tiles']} tiles, widths {widths}; summed over the "
              f"relations {tot['ms']:.4f} ms, bound {tot['bound_ms']:.4f} "
              f"ms, torch.sparse.mm {tot['library_ms']:.4f} ms")
        print(f"typed B1 {label} per relation: {json.dumps(table)}")

    with torch.inference_mode():
        layers = staged_stack("rgcn", [aifb[2], 16, aifb[3]], "blocked",
                              "dense", rels=aifb[0].num_relations)
        plan = rt.prepare_graph(aifb[0], layers[0].cfg)
        typed_b1_rows("aifb", plan, aifb[0], [16, aifb[3]], "staged")
        del layers, plan
    tr, _, _ = build_run("rgcn", "blocked", "dense")
    with torch.inference_mode():
        typed_b1_rows("pubmed", tr.plan, tr.graph, [64, c_tr],
                      "staged_training")
    del tr
    gc.collect()
    torch.cuda.empty_cache()

    from repro_torch.kernels.typed_pairs import ops as pair_ops

    def typed_pair_rows(label, g, dims):
        """The typed pair projection at one packed plan's pairs, both
        layers' widths: the forward, dW and dX kernels, each against its
        plain version, beside the route it replaced (the (N, R*H) einsum
        payload and the gather of the pairs' rows; the gradients through
        that payload)."""
        layers = staged_stack("rgcn", dims, "blocked", "packed",
                              rels=g.num_relations)
        pairs = rt.prepare_graph(g, layers[0].cfg).carrier["typed_pairs"]
        n, r, p = g.num_vertices, pairs.num_relations, pairs.num_pairs
        rel = torch.repeat_interleave(
            torch.arange(r, device=dev),
            torch.from_numpy(np.diff(pairs.pair_ptr)).to(dev))
        key = pairs.pair_src.long() * r + rel
        shapes = list(zip(dims[:-1], dims[1:]))
        xs = [feats(n, f) for f, _ in shapes]
        ws = [feats(r * f, h).view(r, f, h) for f, h in shapes]
        dys = [feats(p, h) for _, h in shapes]

        def payload_grad(dy):
            return torch.zeros((n * r, dy.shape[1]), device=dev).index_add_(
                0, key, dy).view(n, r, -1)
        ops = sum(2 * p * f * h for f, h in shapes)
        cases = {
            "project": (
                [(lambda x=x, w=w: pair_ops._project(x, w, pairs),
                  lambda x=x, w=w: pair_ops.typed_pair_project_plain(
                      x, w, pairs)) for x, w in zip(xs, ws)],
                lambda: [torch.einsum("nf,rfh->nrh", x, w).reshape(
                    n * r, -1)[key] for x, w in zip(xs, ws)],
                sum(4 * (p * f + p * h + r * f * h + p) for f, h in shapes)),
            "grad_w": (
                [(lambda x=x, w=w, d=d: pair_ops._grad_w(x, d, pairs,
                                                         w.shape),
                  lambda x=x, w=w, d=d: pair_ops.typed_pair_grad_w_plain(
                      x, d, pairs, w.shape))
                 for x, w, d in zip(xs, ws, dys)],
                lambda: [torch.einsum("nf,nrh->rfh", x, payload_grad(d))
                         for x, d in zip(xs, dys)],
                sum(4 * (p * f + p * h + r * f * h + p) for f, h in shapes)),
            "grad_x": (
                [(lambda x=x, w=w, d=d: pair_ops._grad_x(d, w, pairs,
                                                         x.shape),
                  lambda x=x, w=w, d=d: pair_ops.typed_pair_grad_x_plain(
                      d, w, pairs, x.shape))
                 for x, w, d in zip(xs, ws, dys)],
                lambda: [torch.einsum("nrh,rfh->nf", payload_grad(d), w)
                         for w, d in zip(ws, dys)],
                sum(4 * (p * h + p + n * f + r * f * h) for f, h in shapes))}
        print(f"typed pairs {label}: N {n}, R {r}, P {p} pairs "
              f"({100 * p / (n * r):.2f}% of N R), "
              f"{pairs.blocks.shape[0]} blocks, widths {shapes}")
        for name, (calls, library, nbytes) in cases.items():
            kernel_case(
                f"typed_pairs_{name}_{label}",
                "src/repro_torch/csrc/typed_pairs.cu",
                "none: the reference's XLA einsum "
                "(src/repro/core/models.py::RGCNLayer.src_payload)",
                calls, exact=False, rel=NEW_RTOL, nbytes=nbytes, ops=ops,
                library=library, counter=f"typed_pairs_{name}",
                phases=("staged", "staged_training"))

    with torch.inference_mode():
        typed_pair_rows("bgs", bgs[0], [bgs[2], 16, bgs[3]])
    gc.collect()
    torch.cuda.empty_cache()

    # inference: each graph's "segment" run first, its twins with the
    # same weights
    g_pub, x_pub_np = pubmed[0], pubmed[1]
    aifb_dims = [aifb[2], 16, aifb[3]]
    bgs_dims = [bgs[2], 16, bgs[3]]
    gated_dims = [f_pub, 64, c_pub]
    staged_runs = [
        ("aifb rgcn segment", aifb[0], aifb[1], "rgcn", aifb_dims,
         "segment", "auto", ()),
        ("aifb rgcn blocked dense", aifb[0], aifb[1], "rgcn", aifb_dims,
         "blocked", "dense", ("rer_spmm_sum",)),
        ("aifb rgcn blocked packed", aifb[0], aifb[1], "rgcn", aifb_dims,
         "blocked", "packed", ("typed_pairs_project",)),
        ("bgs rgcn segment", bgs[0], bgs[1], "rgcn", bgs_dims, "segment",
         "auto", ()),
        ("bgs rgcn blocked packed", bgs[0], bgs[1], "rgcn", bgs_dims,
         "blocked", "packed", ("typed_pairs_project",)),
        ("pubmed gated_gcn segment", g_pub, x_pub_np, "gated_gcn",
         gated_dims, "segment", "auto", ()),
        ("pubmed gated_gcn blocked packed", g_pub, x_pub_np, "gated_gcn",
         gated_dims, "blocked", "packed", ()),
    ]
    staged_counts = {k: 0 for k in K.launch_counts()}
    staged_table, resident = [], {}
    for label, g, x_np, model, dims, backend, fmt, kerns in staged_runs:
        with torch.inference_mode():
            x = torch.from_numpy(x_np).to(dev)
            layers = staged_stack(model, dims, backend, fmt,
                                  rels=g.num_relations)
            key = (label.split()[0], model)
            if backend == "segment":
                resident[key] = {"state": [ly.state_dict() for ly in layers]}
            for ly, st in zip(layers, resident[key]["state"]):
                ly.load_state_dict(st)
            torch.cuda.synchronize()
            mem0 = torch.cuda.memory_allocated()
            t = time.perf_counter()
            plan = rt.prepare_graph(g, layers[0].cfg)
            torch.cuda.synchronize()
            prep_s = time.perf_counter() - t
            plan_b = torch.cuda.memory_allocated() - mem0
            held = plan.held_bytes()
            K.reset_launch_counts()
            y = rt.apply_stack(layers, plan, x)
            torch.cuda.synchronize()
            grew = {k: v for k, v in K.launch_counts().items() if v}
            for k, v in grew.items():
                staged_counts[k] += v
            for kern in kerns:
                if grew.get(kern, 0) <= 0:
                    raise AssertionError(f"{label}: {kern} was not launched")
            if model == "rgcn" and fmt == "dense":
                want = 2 * len(plan.carrier["typed_blocks"])
                if grew.get("rer_spmm_sum") != want:
                    raise AssertionError(f"{label}: {grew} launches, not one "
                                         f"B1 per relation a layer ({want})")
            if y.shape != (g.num_vertices, dims[-1]) or not bool(
                    torch.isfinite(y).all()):
                raise AssertionError(f"{label}: output {tuple(y.shape)}, "
                                     f"finite {bool(torch.isfinite(y).all())}")
            if backend == "segment":
                resident[key]["y"] = y.cpu()
                err = 0.0
            else:
                y_ref = resident[key]["y"].to(dev)
                err = float((y - y_ref).abs().max())
                if not torch.allclose(y, y_ref, rtol=RTOL, atol=ATOL):
                    raise AssertionError(f"{label}: differs from the segment "
                                         f"backend (max abs err {err})")
            times = []
            torch.cuda.reset_peak_memory_stats()
            for _ in range(5):
                t = time.perf_counter()
                rt.apply_stack(layers, plan, x)
                torch.cuda.synchronize()
                times.append((time.perf_counter() - t) * 1e3)
            peak = torch.cuda.max_memory_allocated() - mem0
            row = {"run": label, "plan": f"{plan.backend}/{plan.tile_format}",
                   "forward_ms": statistics.median(times),
                   "launches_per_forward": grew, "prepare_s": prep_s,
                   "plan_mib": plan_b / 2**20, "held_bytes": held,
                   "gate_price_bytes": gate_price(g, layers[0].cfg, dims[1]),
                   "peak_mib": peak / 2**20, "max_abs_err_vs_segment": err}
            staged_table.append(row)
            print(f"path {label} [{smi}]: plan {row['plan']}, forward "
                  f"{row['forward_ms']:.3f} ms (median of 5, host clock), "
                  f"launches/forward {grew}, prepare {prep_s:.2f} s, plan "
                  f"{row['plan_mib']:.1f} MiB (held {held} B; the gate "
                  f"prices {row['gate_price_bytes']} B), peak "
                  f"{row['peak_mib']:.1f} MiB over the run's start, max abs "
                  f"err vs segment {err:.3g}")
            del layers, plan, y, x
        gc.collect()
        torch.cuda.empty_cache()

    # the gated dense formulation at pubmed: refused before allocating
    with torch.inference_mode():
        layers = staged_stack("gated_gcn", gated_dims, "blocked", "dense")
        torch.cuda.synchronize()
        mem0 = torch.cuda.memory_allocated()
        try:
            rt.prepare_graph(g_pub, layers[0].cfg)
            raise AssertionError("the gated dense plan at pubmed was not "
                                 "refused")
        except DeviceBudgetExceeded as exc:
            if torch.cuda.memory_allocated() != mem0:
                raise AssertionError("the gated dense refusal allocated "
                                     f"{torch.cuda.memory_allocated() - mem0}"
                                     " B first")
            print(f"path pubmed gated_gcn blocked dense: refused before "
                  f"allocating ({exc})")
        del layers
    print(f"staged-path launches: {staged_counts}")
    print(f"staged runs: {json.dumps(staged_table)}")

    # tiled: each spilled to "tiled" by a budget, held against its
    # resident ("segment") result
    staged_tiled = [
        ("aifb rgcn blocked 4 MB budget", aifb[0], aifb[1], "rgcn",
         aifb_dims, 4_000_000, ("aifb", "rgcn"),
         ("rer_gather_tile_part_sum",)),
        ("pubmed gated_gcn blocked 32 MB budget", g_pub, x_pub_np,
         "gated_gcn", gated_dims, 32_000_000, ("pubmed", "gated_gcn"), ()),
    ]
    staged_tiled_counts = {k: 0 for k in K.launch_counts()}
    for label, g, x_np, model, dims, budget, key, kerns in staged_tiled:
        with torch.inference_mode():
            x = torch.from_numpy(x_np).to(dev)
            layers = staged_stack(model, dims, "blocked", "auto",
                                  rels=g.num_relations, budget=budget)
            for ly, st in zip(layers, resident[key]["state"]):
                ly.load_state_dict(st)
            t = time.perf_counter()
            plan = rt.prepare_graph(g, layers[0].cfg)
            prep_s = time.perf_counter() - t
            if plan.backend != "tiled":
                raise AssertionError(f"{label}: plan landed on "
                                     f"{plan.backend!r}, not 'tiled'")
            ex = plan.carrier["tiled_exec"]
            K.reset_launch_counts()
            t = time.perf_counter()
            y = rt.apply_stack(layers, plan, x)
            first_ms = (time.perf_counter() - t) * 1e3
            grew = {k: v for k, v in K.launch_counts().items() if v}
            for k, v in grew.items():
                staged_tiled_counts[k] += v
            for kern in kerns:
                if grew.get(kern, 0) <= 0:
                    raise AssertionError(f"{label}: {kern} was not launched")
            stats = dataclasses.asdict(ex.stats)
            y_ref = resident[key]["y"]
            err = float((y - y_ref).abs().max())
            if not torch.allclose(y, y_ref, rtol=RTOL, atol=ATOL):
                raise AssertionError(f"{label}: differs from the resident "
                                     f"result (max abs err {err})")
            times = []
            for _ in range(2):
                t = time.perf_counter()
                rt.apply_stack(layers, plan, x)
                times.append((time.perf_counter() - t) * 1e3)
            times.append(first_ms)
            print(f"path {label} [{smi}]: backend {plan.backend}, format "
                  f"{plan.tile_format}, tile {plan.meta['tile']}, chunk "
                  f"{plan.meta['chunk']}, prepare {prep_s:.2f} s, forward "
                  f"{statistics.median(times):.1f} ms (median of 3, host "
                  f"clock: {[round(v, 1) for v in times]}), launches/forward "
                  f"{grew}, max abs err vs resident {err:.3g}")
            print(f"  TiledStats/forward {json.dumps(stats)}")
            del layers, plan, ex, y, x
    print(f"staged-tiled launches: {staged_tiled_counts}")
    del resident
    gc.collect()
    torch.cuda.empty_cache()

    # training: build_gnn on uncut pubmed, 10 steps; R-GCN on the 3-type
    # colouring (rel = (src + dst) % 3)
    staged_train = [
        ("pubmed rgcn segment", "rgcn", "segment", "auto", ()),
        ("pubmed rgcn blocked dense", "rgcn", "blocked", "dense",
         ("rer_spmm_sum", "rer_spmm_sum_t")),
        ("pubmed rgcn blocked packed", "rgcn", "blocked", "packed",
         ("typed_pairs_project", "typed_pairs_grad_w", "typed_pairs_grad_x")),
        ("pubmed gated_gcn segment", "gated_gcn", "segment", "auto", ()),
        ("pubmed gated_gcn blocked packed", "gated_gcn", "blocked",
         "packed", ()),
    ]
    K.reset_launch_counts()
    staged_train_table = []
    for label, model, backend, fmt, kerns in staged_train:
        mem0 = torch.cuda.memory_allocated()
        tr, state, data = build_run(model, backend, fmt)
        held = tr.plan.held_bytes()
        price = gate_price(tr.graph, tr.layers[0].cfg, tr.hidden)
        gerr = None
        if backend != "segment":
            batch0 = next(data)
            data.seek(0)
            twin = rt.prepare_graph(tr.graph, dataclasses.replace(
                tr.layers[0].cfg, backend="segment"), out_dim=tr.hidden)
            got = grads_of(tr, state["params"], batch0)
            want = grads_of(tr, state["params"], batch0, plan=twin)
            del twin
            gerr = max(float((a - b).abs().max()) for a, b in zip(got, want))
            for a, b in zip(got, want):
                scale = max(1e-30, float(b.abs().max()))
                if not torch.allclose(a, b, rtol=RTOL, atol=RTOL * scale):
                    raise AssertionError(f"{label}: one step's gradients "
                                         f"differ from segment's (max abs "
                                         f"err {gerr})")
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        before = K.launch_counts()
        ps, opt, losses, times = state["params"], state["opt"], [], []
        for _ in range(TRAIN_STEPS):
            t = time.perf_counter()
            ps, opt, m = tr.step(ps, opt, next(data))
            losses.append(float(m["loss"]))
            times.append((time.perf_counter() - t) * 1e3)
        peak = torch.cuda.max_memory_allocated() - mem0
        grew = {k: v - before[k] for k, v in K.launch_counts().items()
                if v > before[k]}
        per_step = {k: v / TRAIN_STEPS for k, v in grew.items()}
        if not all(np.isfinite(losses)):
            raise AssertionError(f"{label}: non-finite loss {losses}")
        for kern in kerns:
            if grew.get(kern, 0) <= 0:
                raise AssertionError(f"{label}: {kern} was not launched")
        if model == "rgcn" and fmt == "dense":
            want = 2 * len(tr.plan.carrier["typed_blocks"])
            if (per_step.get("rer_spmm_sum"), per_step.get(
                    "rer_spmm_sum_t")) != (want, want):
                raise AssertionError(f"{label}: {per_step} launches/step, "
                                     f"not {want} B1 and {want} B1^T")
        after = tr.plan.held_bytes()
        if after != held:
            raise AssertionError(f"{label}: the plan held {held} B before "
                                 f"training and {after} B after")
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
        row = {"run": label,
               "plan": f"{tr.plan.backend}/{tr.plan.tile_format}",
               "ms_per_step": statistics.median(times[1:]),
               "first_step_ms": times[0], "launches_per_step": per_step,
               "plan_and_state_mib": (base - mem0) / 2**20,
               "peak_mib": peak / 2**20, "held_bytes_before": held,
               "held_bytes_after": after, "gate_price_bytes": price,
               "loss_first": losses[0], "loss_last": losses[-1],
               "max_loss_err_vs_segment": lerr,
               "max_grad_err_vs_segment": gerr}
        staged_train_table.append(row)
        print(f"train {label} [{smi}]: plan {row['plan']}, median "
              f"{row['ms_per_step']:.3f} ms/step (host clock, steps 2-"
              f"{TRAIN_STEPS}; first {times[0]:.1f} ms), launches/step "
              f"{per_step}, plan + state {row['plan_and_state_mib']:.1f} "
              f"MiB, peak {row['peak_mib']:.1f} MiB, held_bytes {held} B "
              f"before and {after} B after training (the gate prices "
              f"{price} B), loss {losses[0]:.4f} -> {losses[-1]:.4f}, max "
              f"loss err vs segment {lerr:.3g}"
              + (f", max grad err vs segment {gerr:.3g}" if gerr is not None
                 else ""))
        del tr, state, data, ps, opt
        gc.collect()
        torch.cuda.empty_cache()
    staged_train_counts = K.launch_counts()
    print(f"staged-training launches: {staged_train_counts}")
    print(f"staged training runs: {json.dumps(staged_train_table)}")

    # -- streamed training ------------------------------------------------------
    # build_gnn on uncut pubmed at the training path's width [128, 64, 3],
    # batch 256, AdamW, T=256: (a) GCN spilled from "blocked" under a 30 MB
    # budget that the queue fits (B5 forward, B5^T backward), (b) the same
    # with streaming_mode="callback" (B2's tile part forward and backward
    # over the transposed stores), (c) GS-Pool on "tiled" (max, multi-edges
    # merged: the callback route on the card), (d) R-GCN (the typed VJP),
    # (e) Gated-GCN (the gated VJP); then (f) GCN on synthD at 65,536 V
    # [50, 64, 16] under phase 5's 32 MB budget, one step.  Each run's
    # losses and one step's gradients are held against "segment"'s.
    gc.collect()
    torch.cuda.empty_cache()
    budget_a = 30_000_000

    def stream_run(model, backend, budget, mode, data_name, vertices, steps,
                   value_dtype="fp32", tile=256):
        step, state, data, _, aux = train_mod.build_gnn(
            model=model, dataset=data_name, backend=backend, steps=steps,
            hidden=64, batch=256, max_vertices=vertices, max_edges=None,
            device_budget_bytes=budget)
        tr = aux["trainer"]
        if model == "gs_pool":
            tr.graph = merged(tr.graph)
        for layer in tr.layers:
            layer.cfg.streaming_mode = mode
            layer.cfg.tile_value_dtype = value_dtype
            layer.cfg.tile = tile
        tr.rebuild()
        return tr, state, data

    def train_steps(tr, state, data, steps):
        ps, opt, losses, times = state["params"], state["opt"], [], []
        for _ in range(steps):
            t = time.perf_counter()
            ps, opt, m = tr.step(ps, opt, next(data))
            losses.append(float(m["loss"]))      # waits for the step
            times.append((time.perf_counter() - t) * 1e3)
        return losses, times

    stream_runs = [
        ("a", "pubmed gcn blocked 30 MB budget (queue)", "gcn", "blocked",
         budget_a, "auto", "pubmed", None, STREAM_STEPS,
         ("chunk_queue_sum", "chunk_queue_sum_t")),
        ("b", "pubmed gcn blocked 30 MB budget (callback)", "gcn",
         "blocked", budget_a, "callback", "pubmed", None, STREAM_STEPS,
         ("rer_gather_tile_part_sum",)),
        ("c", "pubmed gs_pool tiled", "gs_pool", "tiled", None, "auto",
         "pubmed", None, STREAM_STEPS, ()),
        ("d", "pubmed rgcn tiled", "rgcn", "tiled", None, "auto", "pubmed",
         None, STREAM_STEPS, ("rer_gather_tile_part_sum",)),
        ("e", "pubmed gated_gcn tiled", "gated_gcn", "tiled", None, "auto",
         "pubmed", None, STREAM_STEPS, ()),
        ("f", "synthD gcn blocked 32 MB budget", "gcn", "blocked",
         32_000_000, "auto", "synthD", 65536, 1,
         ("rer_gather_tile_part_sum",)),
    ]
    seg_stream, stream_table, stream_losses = {}, [], {}
    queue_a = None
    K.reset_launch_counts()
    for (tag, label, model, backend, budget, mode, data_name, vertices,
         steps, kerns) in stream_runs:
        key = (model, data_name, steps)
        if key not in seg_stream:
            tr, state, data = stream_run(model, "segment", None, "auto",
                                         data_name, vertices, steps)
            seg_stream[key] = train_steps(tr, state, data, steps)[0]
            del tr, state, data
        torch.cuda.synchronize()
        mem0 = torch.cuda.memory_allocated()
        tr, state, data = stream_run(model, backend, budget, mode, data_name,
                                     vertices, steps)
        if tr.plan.backend != "tiled" or not tr.plan.meta["trainable"]:
            raise AssertionError(f"({tag}) {label}: plan landed on "
                                 f"{tr.plan.backend!r}, not a trainable "
                                 f"'tiled'")
        ex = tr.plan.carrier["tiled_exec"]
        batch0 = next(data)
        data.seek(0)
        twin = rt.prepare_graph(tr.graph, dataclasses.replace(
            tr.layers[0].cfg, backend="segment", device_budget_bytes=None),
            out_dim=tr.hidden)
        want = grads_of(tr, state["params"], batch0, plan=twin)
        got = grads_of(tr, state["params"], batch0)
        del twin
        gerr = max(float((a - b).abs().max()) for a, b in zip(got, want))
        for a, b in zip(got, want):
            scale = max(1e-30, float(b.abs().max()))
            if not torch.allclose(a, b, rtol=RTOL, atol=RTOL * scale):
                raise AssertionError(f"({tag}) {label}: one step's gradients "
                                     f"differ from segment's (max abs err "
                                     f"{gerr})")
        ex.reset_stats()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        before = K.launch_counts()
        losses, times = train_steps(tr, state, data, steps)
        peak = torch.cuda.max_memory_allocated() - mem0
        grew = {k: v - before[k] for k, v in K.launch_counts().items()
                if v > before[k]}
        st = ex.stats
        ref = np.asarray(seg_stream[key])
        lerr = float(np.abs(np.asarray(losses) - ref).max())
        if not all(np.isfinite(losses)) or not np.allclose(
                losses, ref, rtol=TRAIN_RTOL, atol=TRAIN_ATOL):
            raise AssertionError(f"({tag}) {label}: loss trajectory {losses} "
                                 f"differs from segment {ref.tolist()}")
        for kern in kerns:
            if grew.get(kern, 0) <= 0:
                raise AssertionError(f"({tag}) {label}: {kern} was not "
                                     f"launched")
        if tag == "a":
            if st.queue_launches <= 0 or st.bwd_tiles != 0:
                raise AssertionError(f"(a) {label}: not the queue route "
                                     f"({dataclasses.asdict(st)})")
            queue_a = (ex._tq, tr.graph)
        elif st.bwd_tiles <= 0 or st.queue_launches != 0:
            raise AssertionError(f"({tag}) {label}: the backward did not "
                                 f"stream ({dataclasses.asdict(st)})")
        per_step = {k: v / steps for k, v in grew.items()}
        stream_losses[tag] = (losses, statistics.median(times[1:] or times))
        row = {"run": tag, "label": label,
               "ms_per_step": statistics.median(times[1:] or times),
               "step_ms": times, "launches_per_step": per_step,
               "peak_mib": peak / 2**20,
               "budget_mib": budget / 2**20 if budget else None,
               "tile": tr.plan.meta["tile"], "chunk": tr.plan.meta["chunk"],
               "tile_format": tr.plan.tile_format,
               "loss_first": losses[0], "loss_last": losses[-1],
               "max_loss_err_vs_segment": lerr,
               "max_grad_err_vs_segment": gerr,
               "stats_per_run": dataclasses.asdict(st)}
        stream_table.append(row)
        over = ("" if budget is None else
                f" against the {budget / 2**20:.1f} MiB budget")
        print(f"stream ({tag}) {label} [{smi}]: {tr.plan.tile_format}, tile "
              f"{row['tile']}, chunk {row['chunk']}, median "
              f"{row['ms_per_step']:.1f} ms/step (host clock, steps 2-"
              f"{steps}; all {[round(v, 1) for v in times]}), peak "
              f"{row['peak_mib']:.1f} MiB over the run's start{over}, "
              f"launches/step {per_step}, loss {losses[0]:.4f} -> "
              f"{losses[-1]:.4f}, max loss err vs segment {lerr:.3g}, max "
              f"grad err vs segment {gerr:.3g}")
        print(f"  TiledStats over {steps} steps {json.dumps(row['stats_per_run'])}")
        del tr, state, data, ex
        gc.collect()
        torch.cuda.empty_cache()
    stream_counts = K.launch_counts()
    print(f"streamed-training launches: {stream_counts}")
    print(f"streamed training runs: {json.dumps(stream_table)}")

    # B5^T at (a)'s shapes: its queue, the cotangents of both layers'
    # aggregates (widths 64 and 3), beside torch.sparse.mm(A^T, G)
    tq_a, g_a = queue_a
    a_t = csr(COOGraph(g_a.num_vertices, g_a.dst, g_a.src, g_a.weights()))
    print(f"chunk_queue_t (a): {tq_a.entries} entries, {tq_a.tile_dst.numel()}"
          f" tiles, piece {tq_a.t_piece}, {tq_a.tpieces.shape[0]} pieces, "
          f"{tq_a.t_split} split source intervals")
    with torch.inference_mode():
        gs_a = [feats(tq_a.n, w) for w in (64, c_tr)]
        kernel_case(
            "chunk_queue_sum_t", "src/repro_torch/csrc/chunk_queue.cu",
            "src/repro/kernels/chunk_queue/chunk_queue.py:132",
            [(lambda g=g: queue_ops.tile_queue_t(tq_a, g),
              lambda g=g: queue_ops.tile_queue_t_plain(tq_a, g))
             for g in gs_a],
            exact=False, rel=NEW_RTOL, nbytes=b5t_bytes(tq_a, gs_a),
            ops=sum(2 * tq_a.entries * g.shape[1] for g in gs_a),
            library=lambda: [torch.sparse.mm(a_t, g) for g in gs_a],
            phases=("streamed_training",))
    del queue_a, tq_a, a_t, gs_a

    # -- int8 tile values, the measured tile format, T = 2048 (phase 12) --------
    # (a) pubmed GCN [500, 64, 3] on "tiled", packed, int8 values: the host
    # callback route (inference) and the queue route (the differentiable
    # forward, as training runs it), each against the fp32 run on the same
    # route and "segment" within the reference's int8 envelope, its value
    # bytes under 0.3 of fp32's and its quantised arrays equal to the same
    # calls' on the CPU; (b) phase 11's runs (a) and (b) with int8 values;
    # (c) blocked packed plans with int8 values keep fp32 bucket groups;
    # (d) the measured tile-format choice on pubmed and synthD; (e) fault
    # C3: pubmed GCN streamed at T = 2048 on the queue route, B5 at a
    # narrower feature chunk and B5^T, then B5's and B5^T's rows at T = 2048.
    gc.collect()
    torch.cuda.empty_cache()
    K.reset_launch_counts()
    from repro_torch.core.tiled import TiledExecutor
    from repro_torch.kernels import autotune

    def int8_envelope(label, got, want):
        rel = (got - want).abs() / torch.clamp_min(want.abs(), 1.0)
        mean, worst = float(rel.mean()), float(rel.max())
        if not (mean < INT8_MEAN_REL and worst < INT8_MAX_REL):
            raise AssertionError(f"{label}: int8 outside the envelope (mean "
                                 f"rel {mean:.4g}, max rel {worst:.4g})")
        return mean, worst

    def tiled_stack(dims, vd, mode, device=None, like=None):
        layers = rt.make_gnn_stack("gcn", dims, backend="tiled", tile=256,
                                   device=device)
        for layer in layers:
            layer.cfg.tile_format = "packed"
            layer.cfg.tile_value_dtype = vd
            layer.cfg.streaming_mode = mode
        if like is not None:
            for a, b in zip(layers, like):
                a.load_state_dict(b.state_dict())
        return layers

    g_pub, x_pub_np, _, f_pub, c_pub = pubmed
    dims_pub = [f_pub, 64, c_pub]
    x_pub = torch.from_numpy(x_pub_np).to(dev)
    base = stack("gcn", dims_pub, "segment")
    with torch.inference_mode():
        y_seg = rt.apply_stack(base, rt.prepare_graph(g_pub, base[0].cfg),
                               x_pub).cpu()
    int8_table = []
    for route, mode in (("callback", "callback"), ("queue", "auto")):
        ys, row = {}, {"route": route}
        for vd in ("fp32", "int8"):
            layers = tiled_stack(dims_pub, vd, mode, like=base)
            plan = rt.prepare_graph(g_pub, layers[0].cfg)
            ex = plan.carrier["tiled_exec"]

            def fwd(layers=layers, plan=plan):
                if route == "callback":
                    with torch.inference_mode():
                        return rt.apply_stack(layers, plan, x_pub)
                with torch.enable_grad():
                    return rt.apply_stack(layers, plan, x_pub).detach().cpu()
            ys[vd] = fwd()
            stats = dataclasses.asdict(ex.stats)
            # the residuals after one forward (each timed forward below
            # feeds them again on the callback route)
            err_once = (ex.quantizer.err.copy() if ex.quantizer is not None
                        else None)
            times = []
            for _ in range(3):
                t = time.perf_counter()
                fwd()
                torch.cuda.synchronize()
                times.append((time.perf_counter() - t) * 1e3)
            # the queue route stages a queue and streams no tile
            queued = stats["queue_builds"] > 0 and stats["steps"] == 0
            if queued != (route == "queue"):
                raise AssertionError(f"int8 (a) {route} {vd}: took the "
                                     f"wrong route ({stats})")
            row[vd] = {"forward_ms": statistics.median(times),
                       "all_ms": times, "stats": stats}
            if vd == "int8":
                if ex.stats.value_compression() >= 0.3:
                    raise AssertionError(f"int8 (a) {route}: value bytes "
                                         f"{ex.stats.value_compression()} of "
                                         f"fp32's")
                if ex._tq is not None:
                    raise AssertionError("an int8 queue built a TileQueue")
                # the same calls on the CPU: the quantisation is host numpy
                cpu_layers = tiled_stack(dims_pub, vd, mode, device="cpu",
                                         like=layers)
                cpu_plan = rt.prepare_graph(g_pub, cpu_layers[0].cfg,
                                            device="cpu")
                if route == "callback":
                    with torch.inference_mode():
                        rt.apply_stack(cpu_layers, cpu_plan, x_pub.cpu())
                else:
                    rt.apply_stack(cpu_layers, cpu_plan, x_pub.cpu())
                cex = cpu_plan.carrier["tiled_exec"]
                same = np.array_equal(err_once, cex.quantizer.err)
                for slab, q in ex._queue_cache.items():
                    cq = cex._queue_cache[slab]
                    same &= all(torch.equal(getattr(q, a).cpu(),
                                            getattr(cq, a))
                                for a in ("gsrc", "gdst", "vals", "scales"))
                if not same:
                    raise AssertionError(f"int8 (a) {route}: quantised "
                                         f"arrays differ from the CPU's")
                del cpu_layers, cpu_plan, cex
        for vd in ("fp32", "int8"):
            if ys[vd].shape != (g_pub.num_vertices, c_pub) or not bool(
                    torch.isfinite(ys[vd]).all()):
                raise AssertionError(f"int8 (a) {route} {vd}: bad output")
        if not torch.allclose(ys["fp32"], y_seg, rtol=RTOL, atol=ATOL):
            raise AssertionError(f"int8 (a) {route}: fp32 differs from "
                                 f"segment")
        row["vs_fp32"] = int8_envelope(f"int8 (a) {route} vs fp32",
                                       ys["int8"], ys["fp32"])
        row["vs_segment"] = int8_envelope(f"int8 (a) {route} vs segment",
                                          ys["int8"], y_seg)
        st8 = row["int8"]["stats"]
        print(f"int8 (a) pubmed gcn tiled {route} [{smi}]: forward int8 "
              f"{row['int8']['forward_ms']:.1f} ms vs fp32 "
              f"{row['fp32']['forward_ms']:.1f} ms (median of 3, host clock);"
              f" value bytes {st8['quant_val_bytes']} of "
              f"{st8['raw_val_bytes']} f32 "
              f"({st8['quant_val_bytes'] / st8['raw_val_bytes']:.4f}); mean /"
              f" max rel err vs fp32 {row['vs_fp32'][0]:.3g} / "
              f"{row['vs_fp32'][1]:.3g}, vs segment {row['vs_segment'][0]:.3g}"
              f" / {row['vs_segment'][1]:.3g}; quantised arrays equal the "
              f"CPU's")
        int8_table.append(row)
    del base, x_pub

    # (b) streamed training with int8 values: phase 11's runs (a) and (b)
    for tag, mode in (("a", "auto"), ("b", "callback")):
        tr, state, data = stream_run("gcn", "blocked", budget_a, mode,
                                     "pubmed", None, STREAM_STEPS, "int8")
        ex = tr.plan.carrier["tiled_exec"]
        if tr.plan.backend != "tiled" or ex.value_dtype != "int8":
            raise AssertionError(f"int8 (b{tag}): not an int8 tiled plan")
        ex.reset_stats()
        before = K.launch_counts()
        losses, times = train_steps(tr, state, data, STREAM_STEPS)
        grew = {k: v - before[k] for k, v in K.launch_counts().items()
                if v > before[k]}
        st = ex.stats
        queued = st.queue_builds > 0 and st.steps == 0 and st.bwd_tiles == 0
        if queued != (mode == "auto"):
            raise AssertionError(f"int8 (b{tag}): wrong route "
                                 f"({dataclasses.asdict(st)})")
        if mode == "callback" and grew.get("rer_gather_tile_part_sum", 0) <= 0:
            raise AssertionError(f"int8 (b{tag}): B2's tile part was not "
                                 f"launched")
        ref, fp32_ms = stream_losses[tag]
        lerr = float(np.abs(np.asarray(losses) - np.asarray(ref)).max())
        if not all(np.isfinite(losses)) or not np.allclose(
                losses, ref, rtol=INT8_LOSS_RTOL, atol=INT8_LOSS_ATOL):
            raise AssertionError(f"int8 (b{tag}): losses {losses} differ from"
                                 f" the fp32 run's {ref}")
        ms = statistics.median(times[1:] or times)
        print(f"int8 (b{tag}) pubmed gcn blocked 30 MB budget ({mode}) "
              f"[{smi}]: {ms:.1f} ms/step vs fp32 {fp32_ms:.1f} (median of "
              f"steps 2-{STREAM_STEPS}, host clock; all "
              f"{[round(v, 1) for v in times]}), launches/step "
              f"{ {k: v / STREAM_STEPS for k, v in grew.items()} }, loss "
              f"{losses[0]:.4f} -> {losses[-1]:.4f}, max loss err vs fp32 "
              f"{lerr:.3g}, value bytes {st.quant_val_bytes} of "
              f"{st.raw_val_bytes} f32 (bwd tiles {st.bwd_tiles})")
        int8_table.append({"run": f"b{tag}", "ms_per_step": ms,
                           "fp32_ms_per_step": fp32_ms, "losses": losses,
                           "max_loss_err_vs_fp32": lerr,
                           "stats": dataclasses.asdict(st)})
        del tr, state, data, ex
        gc.collect()
        torch.cuda.empty_cache()

    # (c) blocked packed plans with int8 values on the card: the bucket
    # groups stay fp32, as the reference's TPU groups do
    with torch.inference_mode():
        for model, data_c in (("gcn", pubmed), ("gs_pool", pubmed)):
            g_c, x_c, _, _, _ = data_c
            x_c = torch.from_numpy(x_c).to(dev)
            outs, plans = [], []
            for vd in ("fp32", "int8"):
                layers = stack(model, dims_pub, "blocked", "packed")
                if outs:
                    for a, b in zip(layers, first):
                        a.load_state_dict(b.state_dict())
                else:
                    first = layers
                for layer in layers:
                    layer.cfg.tile_value_dtype = vd
                plan = rt.prepare_graph(g_c, layers[0].cfg)
                if plan.carrier["blocks_meta"]["value_dtype"] != "fp32":
                    raise AssertionError(f"int8 (c) {model} {vd}: groups "
                                         f"are not fp32")
                plans.append(plan)
                outs.append(rt.apply_stack(layers, plan, x_c))
            torch.cuda.synchronize()
            same_groups = all(
                torch.equal(a[k], b[k]) for a, b in zip(
                    plans[0].carrier["packed_groups"],
                    plans[1].carrier["packed_groups"])
                for k in ("rows", "cols", "vals", "block_row", "block_col"))
            # B2's max is exact in any order; its sum adds with atomics
            equal = torch.equal(outs[0], outs[1])
            if not same_groups or (model == "gs_pool" and not equal) or (
                    not torch.allclose(outs[0], outs[1], rtol=RTOL,
                                       atol=ATOL)):
                raise AssertionError(f"int8 (c) {model}: the int8 plan "
                                     f"differs from the fp32 plan")
            print(f"int8 (c) pubmed {model} blocked packed: value_dtype "
                  f"fp32 groups, groups equal, output "
                  f"{'torch.equal' if equal else 'allclose'} to the fp32 "
                  f"plan's")
            del outs, plans, first, x_c

    # (d) the measured tile-format choice, through the executor
    measured_table = []
    for label, g_m in (("pubmed", pubmed[0]), ("synthD-65k", synth[0])):
        before = K.launch_counts()["rer_gather_tile_part_sum"]
        t = time.perf_counter()
        ex = TiledExecutor(g_m, tile=256, dim_hint=64, autotune_measure=True)
        build_s = time.perf_counter() - t
        took = K.launch_counts()["rer_gather_tile_part_sum"] - before
        key = autotune._fingerprint(ex.packed, "tiled", 64)
        timed = autotune.MEASURED_TIMES[key]
        again = TiledExecutor(g_m, tile=256, dim_hint=64,
                              autotune_measure=True)
        hit = (K.launch_counts()["rer_gather_tile_part_sum"] - before
               == took and again.format_choice == ex.format_choice)
        if ex.format_choice.reason != "measured" or took <= 0 or not hit:
            raise AssertionError(f"measured choice {label}: "
                                 f"{ex.format_choice}, {took} launches, "
                                 f"cache hit {hit}")
        row = {"graph": label, "choice": ex.format_choice.as_dict(),
               "dense_ms": timed["dense"] * 1e3,
               "packed_ms": {f: v * 1e3 for f, v in timed["packed"].items()},
               "tile_part_launches": took, "cache_hit": hit,
               "executor_s": build_s}
        measured_table.append(row)
        print(f"measured choice {label} [{smi}]: {ex.format_choice.fmt} "
              f"(floor {ex.format_choice.bucket_floor}), dense step "
              f"{row['dense_ms']:.4f} ms, packed step "
              f"{ {f: round(v, 4) for f, v in row['packed_ms'].items()} } "
              f"ms (median of 3, host clock around a synchronise), "
              f"{took} tile-part launches, cache hit on a second executor "
              f"{hit}")
        del ex, again

    # (e) fault C3: pubmed GCN streamed at T = 2048, no budget, on the
    # queue route: one forward, one step's gradients and two steps against
    # "segment" (phase 11's tolerances)
    tr, state, data = stream_run("gcn", "tiled", None, "auto", "pubmed",
                                 None, 2, tile=2048)
    ex = tr.plan.carrier["tiled_exec"]
    if ex.store.tile != 2048:
        raise AssertionError(f"C3: the store's tile is {ex.store.tile}")
    seg_tr, seg_state, seg_data = stream_run("gcn", "segment", None, "auto",
                                             "pubmed", None, 2)
    seg_losses = train_steps(seg_tr, seg_state, seg_data, 2)[0]
    twin = rt.prepare_graph(tr.graph, dataclasses.replace(
        tr.layers[0].cfg, backend="segment", device_budget_bytes=None),
        out_dim=tr.hidden)
    before = K.launch_counts()
    leaves = [{k: v.detach().clone().requires_grad_(True)
               for k, v in p.items()} for p in state["params"]]
    y_q = rt.apply_stack(tr.layers, tr.plan, tr.x, params=leaves)
    y_s = rt.apply_stack(tr.layers, twin, tr.x, params=leaves)
    ferr = float((y_q - y_s).detach().abs().max())
    if not torch.allclose(y_q, y_s, rtol=RTOL, atol=ATOL):
        raise AssertionError(f"C3: the T = 2048 forward differs from "
                             f"segment's ({ferr})")
    del y_q, y_s, leaves
    batch0 = next(data)
    data.seek(0)
    got = grads_of(tr, state["params"], batch0)
    want = grads_of(tr, state["params"], batch0, plan=twin)
    gerr = max(float((a - b).abs().max()) for a, b in zip(got, want))
    for a, b in zip(got, want):
        scale = max(1e-30, float(b.abs().max()))
        if not torch.allclose(a, b, rtol=RTOL, atol=RTOL * scale):
            raise AssertionError(f"C3: one step's gradients differ from "
                                 f"segment's ({gerr})")
    losses, times = train_steps(tr, state, data, 2)
    grew = {k: v - before[k] for k, v in K.launch_counts().items()
            if v > before[k]}
    lerr = float(np.abs(np.asarray(losses) - np.asarray(seg_losses)).max())
    if not np.allclose(losses, seg_losses, rtol=TRAIN_RTOL, atol=TRAIN_ATOL):
        raise AssertionError(f"C3: losses {losses} differ from segment "
                             f"{seg_losses}")
    if (grew.get("chunk_queue_sum", 0) <= 0 or grew.get("chunk_queue_sum_t",
                                                          0) <= 0
            or ex.stats.bwd_tiles != 0):
        raise AssertionError(f"C3: not the queue route ({grew}, "
                             f"{dataclasses.asdict(ex.stats)})")
    chunks = {w: queue_ops.feature_chunk(2048, w) for w in (64, c_tr)}
    print(f"C3 pubmed gcn tiled T=2048 [{smi}]: queue route, B5 feature "
          f"chunk {chunks} (width: features a pass), launches {grew}, "
          f"forward max abs err vs segment {ferr:.3g}, grads {gerr:.3g}, "
          f"losses {losses} vs segment {seg_losses} (max err {lerr:.3g}), "
          f"{[round(v, 1) for v in times]} ms/step")
    p12_counts = K.launch_counts()
    print(f"phase-12 launches: {p12_counts}")
    print(f"int8 runs: {json.dumps(int8_table)}")
    print(f"measured choices: {json.dumps(measured_table)}")

    # B5 and B5^T at T = 2048 (the C3 run's queue, widths 64 and 3)
    tq_c3, g_c3 = ex._tq, tr.graph
    with torch.inference_mode():
        xs_c3 = [feats(tq_c3.n, w) for w in (64, c_tr)]
        a_c3 = csr(g_c3)
        at_c3 = csr(COOGraph(g_c3.num_vertices, g_c3.dst, g_c3.src,
                             g_c3.weights()))
        kernel_case(
            "chunk_queue_sum_t2048", "src/repro_torch/csrc/chunk_queue.cu",
            "src/repro/kernels/chunk_queue/chunk_queue.py:132",
            [(lambda x=x: queue_ops.tile_queue_aggregate(tq_c3, x),
              lambda x=x: queue_ops.tile_queue_plain(tq_c3, x))
             for x in xs_c3],
            exact=False,
            nbytes=sum(nb(tq_c3.wrows, tq_c3.wsrc, tq_c3.wvals,
                          tq_c3.pieces, x, x) for x in xs_c3),
            ops=sum(2 * tq_c3.entries * x.shape[1] for x in xs_c3),
            library=lambda: [torch.sparse.mm(a_c3, x) for x in xs_c3],
            counter="chunk_queue_sum", phases=("phase12",))
        kernel_case(
            "chunk_queue_sum_t_t2048", "src/repro_torch/csrc/chunk_queue.cu",
            "src/repro/kernels/chunk_queue/chunk_queue.py:132",
            [(lambda x=x: queue_ops.tile_queue_t(tq_c3, x),
              lambda x=x: queue_ops.tile_queue_t_plain(tq_c3, x))
             for x in xs_c3],
            exact=False, rel=NEW_RTOL, nbytes=b5t_bytes(tq_c3, xs_c3),
            ops=sum(2 * tq_c3.entries * x.shape[1] for x in xs_c3),
            library=lambda: [torch.sparse.mm(at_c3, x) for x in xs_c3],
            counter="chunk_queue_sum_t", phases=("phase12",))
    del tr, state, data, ex, seg_tr, seg_state, seg_data, twin, tq_c3
    del xs_c3, a_c3, at_c3

    # -- serving and dynamic graphs (phase 13) ---------------------------------
    # Uncut pubmed (merged, degree-sorted, GCN-normalised: phase 4's graph),
    # GCN [500, 64, 3] on "segment" on the card, zipf requests as
    # examples/serve_gnn.py makes them: (a) exact serving against the
    # full-graph forward; (b) the example's configuration, its throughput,
    # latency and one batch's time split by stage; (c) the async pipeline on
    # a flash crowd; (d) over the budget: every batch streamed through the
    # tiled executor (B2's tile part), held against the unbudgeted engine;
    # (e) two replicas against (a); (f) 1,000 inserts and 1,000 deletes:
    # (f1) the engine after `apply_updates` against a cold one on the epoch
    # graph, (f2) a spilled tiled plan through `update_plan` and a queue
    # executor through `apply_updates` (B5 on the merged store).
    gc.collect()
    torch.cuda.empty_cache()
    K.reset_launch_counts()
    from repro_torch.graphs.generate import zipf_traffic
    from repro_torch.graphs.updates import UpdateLog
    from repro_torch.serving import (GNNServingEngine, ReplicatedServer,
                                     ServingConfig, ServingPipeline,
                                     WorkloadSpec, make_trace, replay_closed)
    t13 = time.perf_counter()
    g13, x13 = pubmed[0], pubmed[1]
    dims13 = [f_pub, 64, c_pub]
    gcn13 = stack("gcn", dims13, "segment")
    deg13 = g13.degrees()

    def serve_requests(n):
        """The example's traffic: sizes from default_rng(0), zipf ids."""
        rng = np.random.default_rng(0)
        sample = zipf_traffic(deg13, seed=0)
        return [(rid, sample(int(rng.integers(1, 20)))) for rid in range(n)]

    def serve(server, reqs):
        for rid, ids in reqs:
            server.submit(rid, ids)
        out = {r.rid: r for r in server.drain()}
        if sorted(out) != [rid for rid, _ in reqs]:
            raise AssertionError(f"served {len(out)} of {len(reqs)}")
        return {rid: r.outputs for rid, r in out.items()}

    def hold(label, got, want, rtol=RTOL, atol=ATOL):
        err = 0.0
        for rid in want:
            a, b = got[rid], want[rid]
            if a.shape != b.shape or not np.isfinite(a).all():
                raise AssertionError(f"{label}: request {rid} shape "
                                     f"{a.shape} vs {b.shape}")
            err = max(err, float(np.abs(a - b).max()))
            if not np.allclose(a, b, rtol=rtol, atol=atol):
                raise AssertionError(f"{label}: request {rid} differs (max "
                                     f"abs err {err})")
        return err

    def exact_cfg(**kw):
        return ServingConfig(**{"batch_size": 128, "num_hops": 2,
                                "fanout": None, "cache_capacity": 0, **kw})

    def telemetry_line(eng, dt, n_vertices):
        tel = eng.telemetry()
        lat, st13 = tel["latency"], tel["engine"]
        hit = tel["cache"]["hit_rate"] if "cache" in tel else 0.0
        return (f"{lat['count']} requests / "
                f"{n_vertices} vertices in {dt * 1e3:.1f} ms "
                f"({lat['count'] / dt:.1f} req/s, {n_vertices / dt:.1f} "
                f"vertices/s), latency p50 {lat['p50_s'] * 1e3:.2f} ms p99 "
                f"{lat['p99_s'] * 1e3:.2f} ms, cache hit rate {hit:.4f}, "
                f"{tel['batcher']['batches']} batches, {st13['compiles']} "
                f"buckets seen, mean subgraph "
                f"{st13['subgraph_vertices'] / max(st13['subgraphs'], 1):.1f} "
                f"V / {st13['subgraph_edges'] / max(st13['subgraphs'], 1):.1f}"
                f" E")

    with torch.inference_mode():
        full13 = rt.apply_stack(gcn13, rt.prepare_graph(g13, gcn13[0].cfg),
                                torch.from_numpy(x13).to(dev)).cpu().numpy()

    # (a) exact serving against the full-graph forward
    reqs_a = serve_requests(64)
    eng_a = GNNServingEngine(g13, x13, gcn13, None, exact_cfg())
    t = time.perf_counter()
    out_a = serve(eng_a, reqs_a)
    dt = time.perf_counter() - t
    err_a = hold("serving (a)", out_a, {rid: full13[ids]
                                        for rid, ids in reqs_a})
    print(f"serving (a) exact [{smi}]: "
          f"{telemetry_line(eng_a, dt, sum(i.size for _, i in reqs_a))}; "
          f"max abs err vs the full-graph forward {err_a:.3g}")

    # (b) the example's configuration, then one batch split by stage
    cfg_b = ServingConfig(batch_size=128, num_hops=2, fanout=16,
                          cache_capacity=2048, cache_reserved_frac=0.5)
    reqs_b = serve_requests(200)
    eng_b = GNNServingEngine(g13, x13, gcn13, None, cfg_b)
    t = time.perf_counter()
    out_b = serve(eng_b, reqs_b)
    dt = time.perf_counter() - t
    for rid, ids in reqs_b:
        if out_b[rid].shape != (ids.size, c_pub):
            raise AssertionError(f"serving (b): request {rid} shape "
                                 f"{out_b[rid].shape}")
    print(f"serving (b) fanout 16, cache 2048 [{smi}]: "
          f"{telemetry_line(eng_b, dt, sum(i.size for _, i in reqs_b))}")
    split_eng = GNNServingEngine(g13, x13, gcn13, None, cfg_b)
    split_ids = np.unique(np.concatenate([i for _, i in reqs_b]))[:128]
    split = {"extract": [], "upload_stack": [], "readback": [],
             "infer_batch": []}
    for _ in range(6):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ids, mask, out, miss = split_eng._probe_batch(split_ids)
        sub, xs = split_eng._extract_batch(miss)
        t1 = time.perf_counter()
        y = split_eng._run_batch(sub, xs)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        y = y[:sub.num_seeds].cpu().numpy()
        t3 = time.perf_counter()
        split_eng._infer_batch(sub, xs)
        t4 = time.perf_counter()
        for k, v in zip(split, (t1 - t0, t2 - t1, t3 - t2, t4 - t3)):
            split[k].append(v * 1e3)
    print(f"serving (b) one batch of {split_ids.size} seeds "
          f"({sub.graph.num_vertices} V, {sub.graph.num_edges} E) "
          f"[{smi}]: median of 5 after a warm call, host clock around "
          f"synchronize, ms: " + ", ".join(
              f"{k} {statistics.median(v[1:]):.3f}" for k, v in split.items()))
    # what upload + stack holds besides the stack: the features padded to
    # the bucket on the host, and their pageable copy to the card
    (n_pad, _), = split_eng._buckets
    pad_ms, h2d_ms = [], []
    for _ in range(6):
        t0 = time.perf_counter()
        xf = np.zeros((n_pad, xs.shape[1]), np.float32)
        xf[:xs.shape[0]] = xs
        t1 = time.perf_counter()
        torch.from_numpy(xf).to(dev)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        pad_ms.append((t1 - t0) * 1e3)
        h2d_ms.append((t2 - t1) * 1e3)
    print(f"  of upload + stack: padding {n_pad} x {xs.shape[1]} features "
          f"on the host {statistics.median(pad_ms[1:]):.3f} ms, their "
          f"pageable copy to the card {statistics.median(h2d_ms[1:]):.3f} "
          f"ms ({xf.nbytes} B)")

    # (c) the async pipeline on the example's flash crowd
    pl_c = ServingPipeline(GNNServingEngine(
        g13, x13, gcn13, None, ServingConfig(
            batch_size=128, num_hops=2, fanout=16, cache_capacity=2048,
            warm_cache=True, warm_cache_max=128, adaptive_batching=True)))
    trace_c = make_trace(WorkloadSpec(n_requests=200, duration_s=0.5,
                                      mean_size=8, shape="flash_crowd",
                                      slo_s=5.0, seed=1), deg13)
    t = time.perf_counter()
    res_c = replay_closed(pl_c, trace_c, pump_every=0)
    dt = time.perf_counter() - t
    ok_c = sum(r.status == "ok" for r in res_c)
    shed_c = sum(r.status == "expired" for r in res_c)
    pst = pl_c.telemetry()["pipeline"]
    pl_c.close()
    if ok_c + shed_c != len(trace_c):
        raise AssertionError(f"serving (c): {ok_c} ok + {shed_c} shed of "
                             f"{len(trace_c)}")
    print(f"serving (c) pipeline, flash crowd [{smi}]: {ok_c} ok / {shed_c} "
          f"shed in {dt * 1e3:.1f} ms ({ok_c / dt:.1f} req/s), "
          f"{pst['adaptive_merges']} merged admissions, "
          f"{pl_c.engine.stats['warm_filled']} warm-filled hubs, in-flight "
          f"high-water mark {pst['inflight_hwm']}")

    # (d) over the budget: every batch through the tiled executor.  GS-Pool
    # runs exact extraction: sampling draws with replacement, and the
    # tiles merge the repeated edges by summation before a max sees them
    # (ROADMAP §C, note 3), so only exact subgraphs hold a streamed max
    # against the resident one
    reqs_d = serve_requests(16)
    for model, fanout, kern in (("gcn", 16, "rer_gather_tile_part_sum"),
                                ("gs_pool", None,
                                 "rer_gather_tile_part_max")):
        layers_d = stack(model, dims13, "segment")
        kw = dict(batch_size=128, num_hops=2, fanout=fanout,
                  tiled_tile=128)
        roomy = GNNServingEngine(g13, x13, layers_d, None,
                                 ServingConfig(**kw))
        prices = []

        def priced(sub, xs, run=roomy._run_batch, eng=roomy):
            prices.append(eng._subgraph_footprint(sub.graph))
            return run(sub, xs)
        roomy._run_batch = priced
        want_d = serve(roomy, reqs_d)
        budget = min(prices) // 2
        eng_d = GNNServingEngine(g13, x13, layers_d, None, ServingConfig(
            engn=rt.EnGNConfig(in_dim=0, out_dim=0,
                               device_budget_bytes=budget), **kw))
        before = K.launch_counts()[kern]
        t = time.perf_counter()
        got_d = serve(eng_d, reqs_d)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t
        grew = K.launch_counts()[kern] - before
        batches = eng_d.batcher.stats["batches"]
        if eng_d.stats["tiled_batches"] != batches or batches == 0:
            raise AssertionError(f"serving (d) {model}: "
                                 f"{eng_d.stats['tiled_batches']} of "
                                 f"{batches} batches streamed")
        if grew <= 0:
            raise AssertionError(f"serving (d) {model}: {kern} was not "
                                 f"launched")
        err = hold(f"serving (d) {model}", got_d, want_d)
        print(f"serving (d) {model} over budget [{smi}]: first batch priced "
              f"{prices[0]} B, budget {budget} B, {batches} of {batches} "
              f"batches tiled, {grew} {kern} launches, max abs err vs the "
              f"unbudgeted engine {err:.3g}, {dt * 1e3:.1f} ms for "
              f"{len(reqs_d)} requests")

    # (e) two replicas against (a)'s engine
    srv = ReplicatedServer(g13, x13, gcn13, None, replicas=2,
                           config=exact_cfg(), balancer="least_outstanding")
    out_e = serve(srv, reqs_a)
    routed = srv.routed.tolist()
    srv.close()
    err_e = hold("serving (e)", out_e, out_a)
    print(f"serving (e) 2 replicas, least_outstanding: routed {routed}, max "
          f"abs err vs (a) {err_e:.3g}")

    # (f) one epoch of 1,000 inserts and 1,000 deletes
    rng13 = np.random.default_rng(13)
    log13 = UpdateLog(g13)
    pick = rng13.choice(g13.num_edges, 1000, replace=False)
    log13.delete(g13.src[pick], g13.dst[pick])
    log13.insert(rng13.integers(0, g13.num_vertices, 1000),
                 rng13.integers(0, g13.num_vertices, 1000),
                 rng13.choice(g13.weights(), 1000))
    snap = log13.snapshot()
    g_new = snap.graph
    # (f1) an exact engine with a cache through (b)'s traffic, then the
    # update, then against a cold engine on the epoch graph
    pl_f = ServingPipeline(GNNServingEngine(
        g13, x13, gcn13, None, exact_cfg(cache_capacity=2048,
                                         cache_reserved_frac=0.5)))
    serve(pl_f, reqs_b)
    t = time.perf_counter()
    info = pl_f.apply_updates(snap)
    upd_ms = (time.perf_counter() - t) * 1e3
    reqs_f = reqs_a + [(1000 + rid, ids) for rid, ids in reqs_b[:64]]
    out_f = serve(pl_f, reqs_f)
    pl_f.close()
    cold = GNNServingEngine(g_new, x13, gcn13, None, exact_cfg())
    err_f = hold("serving (f1)", out_f, serve(cold, reqs_f))
    print(f"updates (f1) engine [{smi}]: {snap.batch.num_deleted} deleted, "
          f"{snap.batch.num_inserted} inserted, apply_updates {upd_ms:.1f} "
          f"ms: affected {info['affected']}, invalidated "
          f"{info['invalidated']}, pin_drift {info['pin_drift']:.4f}, "
          f"repinned {info['repinned']}; max abs err vs a cold engine "
          f"{err_f:.3g}")

    # (f2) a spilled tiled plan through update_plan
    layers_f = stack("gcn", dims13, "blocked", "packed")
    cfg_f = dataclasses.replace(layers_f[0].cfg,
                                device_budget_bytes=30_000_000)
    plan = rt.prepare_graph(g13, cfg_f)
    if plan.backend != "tiled":
        raise AssertionError(f"updates (f2): plan on {plan.backend!r}")
    t = time.perf_counter()
    plan = rt.update_plan(plan, snap, cfg_f)
    merge_s = time.perf_counter() - t
    t = time.perf_counter()
    fresh = rt.prepare_graph(g_new, cfg_f)
    fresh_s = time.perf_counter() - t
    pst = plan.carrier["tiled_exec"].stats
    refit = pst.store_builds > 1
    if pst.delta_merges != 1 or (pst.store_builds != 1 and not refit):
        raise AssertionError(f"updates (f2): {dataclasses.asdict(pst)}")
    with torch.inference_mode():
        xd = torch.from_numpy(x13).to(dev)
        y_m = rt.apply_stack(layers_f, plan, xd)
        y_f = rt.apply_stack(layers_f, fresh, xd)
    err_p = float((y_m - y_f).abs().max())
    if not torch.allclose(y_m, y_f, rtol=RTOL, atol=ATOL):
        raise AssertionError(f"updates (f2): the merged plan's forward "
                             f"differs from a fresh plan's ({err_p})")
    print(f"updates (f2) tiled plan [{smi}]: update_plan {merge_s * 1e3:.1f}"
          f" ms (host) vs a fresh prepare_graph {fresh_s * 1e3:.1f} ms, "
          f"delta_merges {pst.delta_merges}, store_builds "
          f"{pst.store_builds}"
          + (" (the re-fit fell back to a full prepare_tiled)" if refit
             else "")
          + f", forward max abs err vs the fresh plan {err_p:.3g}")
    # a queue executor whose TileQueue was built before the merge
    ex13 = TiledExecutor(g13, tile=256, tile_format="packed")
    xq = feats(g13.num_vertices, 64).cpu()
    ex13.aggregate(xq, "sum")
    tq_old = ex13._tq
    t = time.perf_counter()
    ex13.apply_updates(snap)
    apply_s = time.perf_counter() - t
    t = time.perf_counter()
    ex_fresh = TiledExecutor(g_new, tile=256, tile_format="packed")
    build_s = time.perf_counter() - t
    before = K.launch_counts()["chunk_queue_sum"]
    y_q = ex13.aggregate(xq, "sum")
    torch.cuda.synchronize()
    grew = K.launch_counts()["chunk_queue_sum"] - before
    if grew <= 0 or ex13.stats.queue_launches <= 0 or ex13._tq is tq_old:
        raise AssertionError(f"updates (f2): B5 did not run on the merged "
                             f"store ({grew} launches)")
    y_q_fresh = ex_fresh.aggregate(xq, "sum")
    err_q = float((y_q - y_q_fresh).abs().max())
    if not torch.allclose(y_q, y_q_fresh, rtol=RTOL, atol=ATOL):
        raise AssertionError(f"updates (f2): the merged queue sum differs "
                             f"from a fresh executor's ({err_q})")
    print(f"updates (f2) queue executor: apply_updates "
          f"{apply_s * 1e3:.1f} ms (host) vs a fresh TiledExecutor "
          f"{build_s * 1e3:.1f} ms, then {grew} B5 launch(es) on the merged "
          f"store, max abs err vs the fresh executor {err_q:.3g}")
    p13_counts = K.launch_counts()
    print(f"phase-13 launches: {p13_counts}")
    print(f"phase 13: {time.perf_counter() - t13:.1f} s")
    del eng_a, eng_b, split_eng, pl_c, eng_d, roomy, cold, plan, fresh
    del ex13, ex_fresh, full13

    # -- the sharded ring (phase 14) --------------------------------------------
    # P shards co-located on the card, source-feature shards rotating
    # (`core/dataflow.py`): (a) examples/multipod_ring.py's configuration;
    # (b) uncut pubmed GCN / GS-Pool [500, 64, 3] inference, P = 4, T = 256,
    # dense and packed, beside the blocked forward of the same format; (c)
    # AIFB R-GCN on both formats, pubmed Gated-GCN packed, gated dense
    # refused (B6); (d) `build_gnn` training on the ring, then `run_gnn
    # --gnn-backend ring --gnn-shards 4` and its resume; (e) the elastic
    # re-mesh 4 -> 3 -> 2 -> tiled; (f) serving's ring gate.
    gc.collect()
    torch.cuda.empty_cache()
    K.reset_launch_counts()
    from repro_torch.core import dataflow as ring_df
    from repro_torch.distributed.chaos import ShardLossError
    from repro_torch.graphs.generate import rmat_graph
    t14 = time.perf_counter()
    ring_p = 4

    def median_fwd_ms(layers, plan, x):
        times = []
        for _ in range(5):
            t = time.perf_counter()
            rt.apply_stack(layers, plan, x)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t) * 1e3)
        return statistics.median(times)

    def counted_forward(layers, plan, x):
        """One forward and the hops and bytes it rotated."""
        ring_df.reset_hop_counts()
        y = rt.apply_stack(layers, plan, x)
        torch.cuda.synchronize()
        return y, dict(ring_df.hop_counts)

    def ring_desc(plan, hops, n_layers):
        meta = plan.meta
        st = meta["stats"].as_dict()
        if hops["hops"] != n_layers * meta["shards"]:
            raise AssertionError(f"{hops['hops']} hops over {n_layers} "
                                 f"aggregates of a {meta['shards']}-shard "
                                 f"ring")
        return (f"{meta['shards']} shards, {meta['tile_format']}, "
                f"{meta['device_bytes'] / 1e6:.2f} MB/shard, "
                f"{hops['hops'] // n_layers} hops and "
                f"{hops['bytes'] / n_layers / 1e6:.3f} MB rotated per "
                f"aggregate (RingStats at in_dim: {st['ring_steps']} hops, "
                f"{st['ppermute_bytes'] / 1e6:.3f} MB), fill factor "
                f"{st['fill_factor']:.4f}")

    with torch.inference_mode():
        # (a) the reference example: R-MAT 2,048 V / 40,000 E, GCN 64 -> 32
        g_a = rmat_graph(2048, 40000, seed=0).gcn_normalized()
        x_a = torch.from_numpy(random_features(2048, 64, seed=1)).to(dev)
        ring_a = rt.make_gnn("gcn", 64, 32, backend="ring")
        ring_a.cfg.ring_shards = 8
        plan_a = rt.prepare_graph(g_a, ring_a.cfg)
        y_a, hops_a = counted_forward([ring_a], plan_a, x_a)
        seg_a = rt.make_gnn("gcn", 64, 32)
        seg_a.load_state_dict(ring_a.state_dict())
        y_a_ref = seg_a(rt.prepare_graph(g_a, seg_a.cfg), x_a)
        err = float((y_a - y_a_ref).abs().max())
        if plan_a.backend != "ring" or not torch.allclose(
                y_a, y_a_ref, rtol=1e-4, atol=1e-4):
            raise AssertionError(f"ring (a): {plan_a.backend}, max abs err "
                                 f"{err} vs segment")
        print(f"ring (a) multipod_ring.py, R-MAT 2048 V / 40000 E, GCN "
              f"64 -> 32 [{smi}]: {ring_desc(plan_a, hops_a, 1)}; "
              f"{plan_a.meta['nnzb']} "
              f"{'entries' if plan_a.tile_format == 'packed' else 'tiles'}"
              f" vs {4 * 2048 ** 2 / 1e6:.0f} MB dense A; forward "
              f"{median_fwd_ms([ring_a], plan_a, x_a):.3f} ms (median of 5, "
              f"host clock), max abs err vs segment {err:.3g}")
        del plan_a, ring_a, seg_a

        # (b) uncut pubmed on 4 shards beside phase 4's blocked runs
        seg_y = {}
        for label, g, x, perm, model, dims, layers, graph, y, grew in built:
            if not label.startswith("pubmed"):
                continue
            fmt = graph.tile_format
            ring_layers = stack(model, dims, "ring", fmt)
            for a, b in zip(ring_layers, layers):
                a.load_state_dict(b.state_dict())
                a.cfg.ring_shards = ring_p
            t = time.perf_counter()
            plan = rt.prepare_graph(g, ring_layers[0].cfg)
            torch.cuda.synchronize()
            prep_s = time.perf_counter() - t
            torch.cuda.reset_peak_memory_stats()
            y_r, hops = counted_forward(ring_layers, plan, x)
            peak = torch.cuda.max_memory_allocated()
            if (plan.backend, plan.tile_format) != ("ring", fmt):
                raise AssertionError(f"ring (b) {label}: plan "
                                     f"{plan.backend}/{plan.tile_format}")
            if model == "gs_pool":
                err = float((y_r - y).abs().max())
                if not torch.equal(y_r, y):
                    raise AssertionError(f"ring (b) {label}: the ring max "
                                         f"differs from blocked ({err})")
                held_to = "blocked, equal"
            else:
                if model not in seg_y:
                    ref_layers = stack(model, dims, "segment")
                    for a, b in zip(ref_layers, layers):
                        a.load_state_dict(b.state_dict())
                    seg_y[model] = rt.apply_stack(
                        ref_layers, rt.prepare_graph(g, ref_layers[0].cfg), x)
                err = float((y_r - seg_y[model]).abs().max())
                if not torch.allclose(y_r, seg_y[model], rtol=RTOL,
                                      atol=ATOL):
                    raise AssertionError(f"ring (b) {label}: differs from "
                                         f"segment ({err})")
                held_to = "segment"
            ring_ms = median_fwd_ms(ring_layers, plan, x)
            blocked_ms = median_fwd_ms(layers, graph, x)
            print(f"ring (b) {label.replace('blocked ', '')} [{smi}]: "
                  f"{ring_desc(plan, hops, len(dims) - 1)}; forward "
                  f"{ring_ms:.3f} ms vs blocked {fmt} {blocked_ms:.3f} ms "
                  f"(median of 5 each, host clock), prepare {prep_s:.2f} s, "
                  f"peak {peak / 2**20:.1f} MiB, max abs err vs {held_to} "
                  f"{err:.3g}")
            del plan, ring_layers, y_r
            gc.collect()
            torch.cuda.empty_cache()
        del seg_y

        # (c) the staged contracts: AIFB R-GCN (typed), pubmed Gated-GCN,
        # each against its "segment" run with the same weights
        for label, data, model, dims, fmts in (
                ("aifb rgcn", aifb, "rgcn", aifb_dims, ("dense", "packed")),
                ("pubmed gated_gcn", (g_pub, x_pub_np), "gated_gcn",
                 gated_dims, ("packed",))):
            g, x_np = data[0], data[1]
            x = torch.from_numpy(x_np).to(dev)
            seg_layers = staged_stack(model, dims, "segment",
                                      rels=g.num_relations)
            y_ref = rt.apply_stack(
                seg_layers, rt.prepare_graph(g, seg_layers[0].cfg), x)
            for fmt in fmts:
                layers = staged_stack(model, dims, "ring", fmt,
                                      rels=g.num_relations)
                for ly, ref_ly in zip(layers, seg_layers):
                    ly.load_state_dict(ref_ly.state_dict())
                    ly.cfg.ring_shards = ring_p
                t = time.perf_counter()
                plan = rt.prepare_graph(g, layers[0].cfg)
                torch.cuda.synchronize()
                prep_s = time.perf_counter() - t
                y_r, hops = counted_forward(layers, plan, x)
                err = float((y_r - y_ref).abs().max())
                if (plan.tile_format != fmt or not torch.allclose(
                        y_r, y_ref, rtol=RTOL, atol=ATOL)):
                    raise AssertionError(f"ring (c) {label} {fmt}: "
                                         f"{plan.tile_format}, max abs err "
                                         f"{err} vs segment")
                print(f"ring (c) {label} {fmt} [{smi}]: "
                      f"{ring_desc(plan, hops, len(dims) - 1)}; forward "
                      f"{median_fwd_ms(layers, plan, x):.3f} ms (median of "
                      f"5, host clock), prepare {prep_s:.2f} s, max abs err "
                      f"vs segment {err:.3g}")
                del plan, layers, y_r
                gc.collect()
                torch.cuda.empty_cache()
            del seg_layers, y_ref
        layers = staged_stack("gated_gcn", gated_dims, "ring", "dense")
        layers[0].cfg.ring_shards = ring_p
        torch.cuda.synchronize()
        mem0 = torch.cuda.memory_allocated()
        try:
            rt.prepare_graph(g_pub, layers[0].cfg)
            raise AssertionError("ring (c): the gated dense ring at pubmed "
                                 "was not refused")
        except DeviceBudgetExceeded as exc:
            if "B6" not in str(exc) or (torch.cuda.memory_allocated()
                                        != mem0):
                raise AssertionError(f"ring (c): refusal {exc!s} with "
                                     f"{torch.cuda.memory_allocated() - mem0}"
                                     f" B allocated")
            print(f"ring (c) pubmed gated_gcn dense: refused before "
                  f"allocating: {exc}")
        del layers

    # (d) training on the ring: uncut pubmed as build_gnn makes it,
    # against the same runs on "segment"
    def ring_run(model, fmt, budget=None):
        step, state, data, _, aux = train_mod.build_gnn(
            model=model, dataset="pubmed", backend="ring", steps=TRAIN_STEPS,
            hidden=64, batch=256, max_vertices=None, max_edges=None,
            ring_shards=ring_p, device_budget_bytes=budget)
        tr = aux["trainer"]
        if model == "gs_pool":
            tr.graph = merged(tr.graph)
        for layer in tr.layers:
            layer.cfg.tile_format = fmt
        tr.rebuild()
        return tr, state, data

    ring_seg, seg_ms = {}, {}
    for model in ("gcn", "gs_pool"):
        tr, state, data = build_run(model, "segment", "auto")
        ps, opt = state["params"], state["opt"]
        ring_seg[model], times = [], []
        for _ in range(TRAIN_STEPS):
            t = time.perf_counter()
            ps, opt, m = tr.step(ps, opt, next(data))
            ring_seg[model].append(float(m["loss"]))
            times.append((time.perf_counter() - t) * 1e3)
        seg_ms[model] = statistics.median(times[1:])
        del tr, state, data, ps, opt
    ring_train = []
    for model, fmt in (("gcn", "dense"), ("gcn", "packed"),
                       ("gs_pool", "dense"), ("gs_pool", "packed")):
        label = f"pubmed {model} ring {fmt}"
        tr, state, data = ring_run(model, fmt)
        if (tr.plan.backend, tr.plan.tile_format) != ("ring", fmt):
            raise AssertionError(f"ring (d) {label}: plan "
                                 f"{tr.plan.backend}/{tr.plan.tile_format}")
        held = tr.plan.held_bytes()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        ring_df.reset_hop_counts()
        ps, opt, losses, times = state["params"], state["opt"], [], []
        for _ in range(TRAIN_STEPS):
            t = time.perf_counter()
            ps, opt, m = tr.step(ps, opt, next(data))
            losses.append(float(m["loss"]))
            times.append((time.perf_counter() - t) * 1e3)
        hops = dict(ring_df.hop_counts)
        ref = np.asarray(ring_seg[model])
        lerr = float(np.abs(np.asarray(losses) - ref).max())
        if not np.allclose(losses, ref, rtol=TRAIN_RTOL, atol=TRAIN_ATOL):
            raise AssertionError(f"ring (d) {label}: losses {losses} vs "
                                 f"segment {ref.tolist()}")
        if tr.plan.held_bytes() != held:
            raise AssertionError(f"ring (d) {label}: the plan held {held} B "
                                 f"before training, {tr.plan.held_bytes()} "
                                 f"after")
        row = {"run": label, "ms_per_step": statistics.median(times[1:]),
               "first_step_ms": times[0],
               "hops_per_step": hops["hops"] / TRAIN_STEPS,
               "bwd_hops_per_step": hops["bwd_hops"] / TRAIN_STEPS,
               "mb_rotated_per_step": (hops["bytes"] + hops["bwd_bytes"])
               / TRAIN_STEPS / 1e6,
               "device_bytes_per_shard": tr.plan.meta["device_bytes"],
               "held_bytes": held,
               "peak_mib": torch.cuda.max_memory_allocated() / 2**20,
               "loss_first": losses[0], "loss_last": losses[-1],
               "max_loss_err_vs_segment": lerr}
        ring_train.append(row)
        print(f"ring (d) train {label} [{smi}]: median "
              f"{row['ms_per_step']:.3f} ms/step (host clock, steps 2-"
              f"{TRAIN_STEPS}; first {times[0]:.1f} ms) vs segment "
              f"{seg_ms[model]:.3f}; {row['hops_per_step']:g} forward + "
              f"{row['bwd_hops_per_step']:g} backward hops a step, "
              f"{row['mb_rotated_per_step']:.2f} MB rotated a step; plan "
              f"holds {held} B before and after; peak "
              f"{row['peak_mib']:.1f} MiB; loss {losses[0]:.4f} -> "
              f"{losses[-1]:.4f}, max loss err vs segment {lerr:.3g}")
        del tr, state, data, ps, opt
        gc.collect()
        torch.cuda.empty_cache()
    print(f"ring training runs: {json.dumps(ring_train)}")
    ckpt_dir = Path(__file__).resolve().parent / "build" / "smoke_ckpt_ring"
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    ring_args = dict(gnn_args, gnn_backend="ring", gnn_shards=ring_p,
                     ckpt_dir=str(ckpt_dir))
    first = train_mod.run_gnn(argparse.Namespace(**ring_args, steps=2))
    second = train_mod.run_gnn(argparse.Namespace(**ring_args, steps=4))
    if (first["start"], first["steps"], first["saves"]) != (0, 2, 1) or (
            second["start"], second["steps"]) != (2, 4):
        raise AssertionError(f"run_gnn on the ring did not checkpoint and "
                             f"resume: {first} / {second}")
    print(f"run_gnn --gnn-backend ring --gnn-shards {ring_p}: 2 steps, "
          f"saved; resumed at step {second['start']} to {second['steps']}, "
          f"losses {first['losses']} + {second['losses']}")
    shutil.rmtree(ckpt_dir, ignore_errors=True)

    # (e) the elastic re-mesh: shard loss 4 -> 3, three straggler strikes
    # -> 2, then a per-shard budget the survivor cannot hold -> tiled
    tr, state, data = ring_run("gcn", "auto")
    ps, opt, losses, events = state["params"], state["opt"], [], []

    def steps(k, ps, opt):
        for _ in range(k):
            ps, opt, m = tr.step(ps, opt, next(data))
            losses.append(float(m["loss"]))
        return ps, opt

    ps, opt = steps(2, ps, opt)
    spent = tr.stats["remesh_s"]
    tr.on_failure(ShardLossError(lost_shards=1))
    events.append(("shard loss", tr.backend, tr.shards,
                   tr.stats["remesh_s"] - spent))
    ps, opt = steps(2, ps, opt)
    spent = tr.stats["remesh_s"]
    for k in range(3):
        tr.on_straggler(k, 99.0)
    events.append(("3 straggler strikes", tr.backend, tr.shards,
                   tr.stats["remesh_s"] - spent))
    ps, opt = steps(2, ps, opt)
    spent = tr.stats["remesh_s"]
    for layer in tr.layers:
        layer.cfg.device_budget_bytes = 30_000_000
    tr.on_failure(ShardLossError(lost_shards=1))
    events.append(("shard loss under 30 MB", tr.backend, tr.shards,
                   tr.stats["remesh_s"] - spent))
    ps, opt = steps(TRAIN_STEPS - 6, ps, opt)
    shape = [(e[1], e[2]) for e in events]
    if shape != [("ring", 3), ("ring", 2), ("tiled", None)] or (
            tr.stats["remesh_count"], tr.stats["degraded"]) != (3, 1):
        raise AssertionError(f"ring (e): re-meshes {events}, stats "
                             f"{tr.stats}")
    ref = np.asarray(ring_seg["gcn"])
    lerr = float(np.abs(np.asarray(losses) - ref).max())
    if not np.allclose(losses, ref, rtol=TRAIN_RTOL, atol=TRAIN_ATOL):
        raise AssertionError(f"ring (e): losses {losses} vs segment "
                             f"{ref.tolist()}")
    print(f"ring (e) elastic re-mesh [{smi}]: " + "; ".join(
        f"{what} -> {b}" + (f" x{p}" if p else "") + f" in {s:.3f} s"
        for what, b, p, s in events)
        + f" (remesh host seconds, plan rebuild included); "
        f"{tr.plan.streaming_mode} route after the spill; {len(losses)} "
        f"losses within {lerr:.3g} of segment's")
    del tr, state, data, ps, opt
    gc.collect()
    torch.cuda.empty_cache()

    # (f) serving's ring gate: a budget every batch's own plan exceeds
    # and every batch's per-shard ring plan fits
    reqs_r = serve_requests(16)
    roomy = GNNServingEngine(g13, x13, gcn13, None, exact_cfg())
    priced = []

    def price(sub, xs, run=roomy._run_batch, eng=roomy):
        dims_r = [f_pub, 64, c_pub]
        priced.append((eng._subgraph_footprint(sub.graph), min(
            ring_df.ring_stripe_bytes(sub.graph, ring_p,
                                      tile=eng.config.ring_tile,
                                      in_dim=max(dims_r),
                                      out_dim=max(dims_r), tile_format=f)
            for f in ("dense", "packed"))))
        return run(sub, xs)
    roomy._run_batch = price
    want_r = serve(roomy, reqs_r)
    budget = max(r for _, r in priced)
    if budget >= min(fp for fp, _ in priced):
        raise AssertionError(f"ring (f): no budget lies between the ring "
                             f"prices and the batches' own {priced}")
    eng_r = GNNServingEngine(g13, x13, gcn13, None, exact_cfg(
        engn=rt.EnGNConfig(in_dim=0, out_dim=0, device_budget_bytes=budget,
                           ring_shards=ring_p)))
    t = time.perf_counter()
    got_r = serve(eng_r, reqs_r)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t
    batches = eng_r.batcher.stats["batches"]
    if (eng_r.stats["ring_batches"], eng_r.stats["tiled_batches"]) != (
            batches, 0) or batches == 0:
        raise AssertionError(f"ring (f): {eng_r.stats['ring_batches']} ring "
                             f"and {eng_r.stats['tiled_batches']} tiled of "
                             f"{batches} batches")
    err = hold("ring (f)", got_r, want_r, rtol=1e-5, atol=1e-5)
    print(f"ring (f) serving pubmed gcn, ring_shards {ring_p} [{smi}]: budget "
          f"{budget} B under every batch's own price (smallest "
          f"{min(fp for fp, _ in priced)} B), {batches} of {batches} "
          f"batches on the ring, {dt * 1e3:.1f} ms for {len(reqs_r)} "
          f"requests, max abs err vs the unbudgeted engine {err:.3g}")
    del roomy, eng_r
    p14_counts = K.launch_counts()
    print(f"phase-14 launches: {p14_counts}")
    print(f"phase 14: {time.perf_counter() - t14:.1f} s")

    # -- seeded chaos, elastic restore and the LM stack (phase 15) --------------
    # (a) the chaos acceptance scenario on an 8-shard co-located ring; (b)
    # run_gnn --chaos-seed 3 on "blocked", dense and packed tiles; (c)
    # elastic_restore of (b)'s newest good checkpoint onto the elastic
    # mesh and a resumed step; (d) launch/train.py --arch granite_3_2b at
    # its full config; (e) one config of each other family at full width,
    # its depth cut, two steps each.
    gc.collect()
    torch.cuda.empty_cache()
    K.reset_launch_counts()
    from repro_torch.checkpoint.elastic import elastic_restore
    from repro_torch.configs import get_config as lm_config
    from repro_torch.configs import get_smoke as lm_smoke
    from repro_torch.distributed.chaos import (ChaosInjector, FaultEvent,
                                               FaultPlan, VirtualClock)
    from repro_torch.distributed.fault import (FaultConfig,
                                               FaultTolerantRunner)
    from repro_torch.distributed.sharding import NamedSharding, P
    from repro_torch.launch.mesh import make_elastic_mesh
    from repro_torch.nn import transformer as lm_T
    from repro_torch.training.optimizer import tree_leaves, tree_map
    t15 = time.perf_counter()
    p15_dir = Path(__file__).resolve().parent / "build" / "smoke_ckpt_chaos"

    def chaos_losses(step, state, data, n):
        ps, opt, out = state["params"], state["opt"], []
        for _ in range(n):
            ps, opt, m = step(ps, opt, next(data))
            out.append(float(m["loss"]))
        return out

    # (a) GCN, 12 steps, pubmed as build_gnn makes it (4,000 V, hidden 32,
    # batch 256), the plan of tests/test_elastic_ring.py
    chaos_steps = 12
    seg_a = chaos_losses(*train_mod.build_gnn(
        model="gcn", dataset="pubmed", backend="segment",
        steps=chaos_steps)[:3], chaos_steps)
    step, state, data, gd, aux = train_mod.build_gnn(
        model="gcn", dataset="pubmed", backend="ring", steps=chaos_steps,
        ring_shards=8)
    trainer = aux["trainer"]
    if (gd.backend, gd.meta["shards"]) != ("ring", 8):
        raise AssertionError(f"chaos (a): plan {gd.backend} {gd.meta}")
    losses_a = []

    def logged_a(ps, opt, batch):
        ps, opt, m = step(ps, opt, batch)
        losses_a.append(float(m["loss"]))
        return ps, opt, m

    plan_a = FaultPlan((FaultEvent(3, "transient"),
                        FaultEvent(5, "torn_ckpt", style="leaf"),
                        FaultEvent(7, "shard_loss", lost_shards=2),
                        FaultEvent(10, "straggler", delay_s=50.0)), seed=0)
    clock = VirtualClock()
    inj = ChaosInjector(plan_a, clock=clock, base_step_s=1.0)
    shutil.rmtree(p15_dir, ignore_errors=True)
    mgr = train_mod.CheckpointManager(p15_dir / "a", keep=3)
    runner = FaultTolerantRunner(
        inj.wrap_step(logged_a), inj.wrap_checkpoint(mgr),
        FaultConfig(ckpt_every=2, retry_backoff_s=0.5),
        on_failure=trainer.on_failure, on_straggler=trainer.on_straggler,
        clock=clock, sleep=clock.sleep)
    t = time.perf_counter()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always", RuntimeWarning)
        state, last = runner.run(state, data, num_steps=chaos_steps)
        mgr.wait()
    torch.cuda.synchronize()
    wall_a = time.perf_counter() - t
    st = runner.stats
    checks = {
        "each kind once": inj.stats == {"shard_loss": 1, "transient": 1,
                                        "straggler": 1, "torn_ckpt": 1},
        "12 steps": last == chaos_steps
        and int(state["opt"]["count"]) == chaos_steps,
        "one re-mesh to 6": trainer.stats["remesh_count"] == 1
        and trainer.plan.backend == "ring"
        and trainer.plan.meta["shards"] == 6,
        "recovery": st["failures"] == 2 and st["restores"] >= 1
        and st["lost_steps"] >= 1 and st["mttr_s"] > 0
        and st["stragglers"] == 1,
        "finite": all(np.isfinite(losses_a)),
        "segment's last loss": bool(np.isclose(losses_a[-1], seg_a[-1],
                                               rtol=5e-3, atol=1e-4)),
    }
    if not all(checks.values()):
        raise AssertionError(f"chaos (a): {checks}; stats {st}, trainer "
                             f"{trainer.stats}, injector {inj.stats}, "
                             f"losses {losses_a} vs segment {seg_a}")
    print(f"chaos (a) pubmed gcn ring 8 -> 6 [{smi}]: {last} steps in "
          f"{len(losses_a)} step calls, {wall_a:.2f} s (host clock); "
          f"failures {st['failures']:.0f}, restores {st['restores']:.0f}, "
          f"lost steps {st['lost_steps']:.0f}, mttr {st['mttr_s']:.2f} s "
          f"(virtual clock), re-mesh {trainer.stats['remesh_s']:.3f} s "
          f"(host); {sum('corrupt' in str(w.message) for w in caught)} "
          f"corrupt-checkpoint fallback(s); last loss {losses_a[-1]:.6f} vs "
          f"segment {seg_a[-1]:.6f}")
    del step, state, data, gd, aux, trainer, runner, mgr
    gc.collect()
    torch.cuda.empty_cache()

    # (b) run_gnn --gnn gcn --gnn-backend blocked --chaos-seed 3 --steps 20
    # --ckpt-every 4, once with dense and once with packed tiles (the
    # launcher has no format flag: its build_gnn is wrapped to pin one)
    real_build_gnn = train_mod.build_gnn

    def pinned_build(fmt):
        def build(**kw):
            step, state, data, _, aux = real_build_gnn(**kw)
            tr = aux["trainer"]
            for layer in tr.layers:
                layer.cfg.tile_format = fmt
            tr.rebuild()
            return tr.step, state, data, tr.plan, aux
        return build

    chaos_args = dict(gnn="gcn", gnn_backend="blocked", gnn_shards=None,
                      gnn_hidden=32, dataset="pubmed", device_budget=0,
                      batch=256, steps=20, ckpt_every=4, chaos_seed=3,
                      device=None, straggler_strikes=3)
    want_plan = FaultPlan.sample(3, 20)
    chaos_runs = {}
    for fmt in ("dense", "packed"):
        before = K.launch_counts()
        train_mod.build_gnn = pinned_build(fmt)
        try:
            t = time.perf_counter()
            out = train_mod.run_gnn(argparse.Namespace(
                **chaos_args, ckpt_dir=str(p15_dir / fmt)))
            torch.cuda.synchronize()
            wall = time.perf_counter() - t
        finally:
            train_mod.build_gnn = real_build_gnn
        after = K.launch_counts()
        launched = {k: after[k] - before[k] for k in after
                    if after[k] != before[k]}
        inj, ls = out["injector"], out["losses"]
        kernels = (("rer_spmm_sum", "rer_spmm_sum_t") if fmt == "dense"
                   else ("rer_gather_sum", "rer_gather_sum_t"))
        checks = {
            "the sampled plan": inj.plan == want_plan,
            "every event fired": json.loads(inj.describe())["fired"]
            == [0, 1, 2, 3] and set(inj.stats.values()) == {1},
            "20 steps": out["steps"] == 20,
            "finite, below the first": all(np.isfinite(ls))
            and ls[-1] < ls[0],
            "its kernels": all(launched.get(k, 0) > 0 for k in kernels),
        }
        if not all(checks.values()):
            raise AssertionError(f"chaos (b) {fmt}: {checks}; {out}, "
                                 f"launches {launched}")
        chaos_runs[fmt] = out
        print(f"chaos (b) run_gnn --chaos-seed 3 blocked {fmt} [{smi}]: "
              f"{out['steps']} steps in {len(ls)} step calls, {wall:.2f} s "
              f"(host clock, build included); failures "
              f"{out['runner']['failures']:.0f}, restores "
              f"{out['runner']['restores']:.0f}, lost steps "
              f"{out['runner']['lost_steps']:.0f}, mttr "
              f"{out['runner']['mttr_s']:.2f} s (virtual); loss {ls[0]:.4f} "
              f"-> {ls[-1]:.4f}; launches {launched}")

    # (c) elastic_restore of (b)'s newest good checkpoint (packed) onto
    # make_elastic_mesh(), then one resumed step against an uninterrupted
    # run's same step
    step, state, data, gd, aux = pinned_build("packed")(
        model="gcn", dataset="pubmed", backend="blocked", steps=20,
        hidden=32, batch=256)
    mesh = make_elastic_mesh()
    like = tree_map(lambda v: v.cpu(), state)
    shardings = tree_map(lambda _: NamedSharding(mesh, P()), like["params"])
    mgr = train_mod.CheckpointManager(p15_dir / "packed", keep=2)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)  # a torn newest
        r_mesh, restored, meta, at = elastic_restore(
            None, mgr, like, shardings=shardings,
            on_placement_error="raise")
    placed = (tree_leaves(restored["params"])
              + tree_leaves(restored["opt"]["m"])
              + tree_leaves(restored["opt"]["v"]))
    if not all(v.device.type == "cuda" for v in placed) or (
            int(restored["opt"]["count"]), meta["cursor"]) != (at, at):
        raise AssertionError(f"chaos (c): restored step {at}, count "
                             f"{int(restored['opt']['count'])}, meta {meta}, "
                             f"devices {sorted({str(v.device) for v in placed})}")
    straight = chaos_losses(step, state, data, at + 1)
    data.seek(meta["cursor"])
    _, _, m = step(restored["params"], restored["opt"], next(data))
    resumed = float(m["loss"])
    if not np.isclose(resumed, straight[at], rtol=1e-5, atol=0):
        raise AssertionError(f"chaos (c): resumed step {at + 1} loss "
                             f"{resumed} vs uninterrupted {straight[at]}")
    print(f"chaos (c) elastic_restore onto {r_mesh.shape} on "
          f"{r_mesh.device}: step {at}, cursor {meta['cursor']}, "
          f"{len(placed)} tensors placed on the card; resumed step "
          f"{at + 1} loss {resumed:.7f} vs uninterrupted "
          f"{straight[at]:.7f}")
    del step, state, data, gd, aux, restored, placed, mgr
    shutil.rmtree(p15_dir, ignore_errors=True)
    p15_gnn_counts = K.launch_counts()
    gc.collect()
    torch.cuda.empty_cache()

    # (d) launch/train.py --arch granite_3_2b at its full config
    lm_rows = []

    def lm_row(label, cfg, losses, step_s, params, tokens):
        ms = statistics.median(step_s[1:]) * 1e3
        flops = 6.0 * params * tokens
        row = {"run": label, "params": params, "layers": cfg.num_layers,
               "d_model": cfg.d_model, "tokens_per_step": tokens,
               "losses": losses, "median_step_ms": ms,
               "first_step_ms": step_s[0] * 1e3,
               "tokens_per_s": tokens / (ms / 1e3),
               "peak_gib": torch.cuda.max_memory_allocated() / 2**30,
               "model_flops_per_step": flops,
               "model_tflops_per_s": flops / (ms / 1e3) / 1e12}
        if not (all(np.isfinite(losses))
                and all(a != b for a, b in zip(losses, losses[1:]))):
            raise AssertionError(f"lm {label}: losses {losses}")
        lm_rows.append(row)
        print(f"lm {label} [{smi}]: {params / 1e9:.3f} B params, "
              f"{cfg.num_layers} layers, d_model {cfg.d_model}; median "
              f"{ms:.1f} ms/step of steps 2-{len(step_s)} (host clock to "
              f"the loss; first {step_s[0] * 1e3:.1f}), "
              f"{row['tokens_per_s']:.0f} tokens/s, peak "
              f"{row['peak_gib']:.2f} GiB, {flops / 1e12:.2f} model TFLOP a "
              f"step = {row['model_tflops_per_s']:.1f} TFLOP/s; losses "
              f"{[round(v, 4) for v in losses]}")

    torch.cuda.reset_peak_memory_stats()
    out = train_mod.main(["--arch", "granite_3_2b", "--batch", "1", "--seq",
                          "512", "--steps", "4", "--ckpt-dir",
                          str(p15_dir / "lm")])
    lm_row("granite_3_2b full (launch/train.py --arch)",
           lm_config("granite_3_2b"), out["losses"], out["step_s"],
           out["params"], 512)
    shutil.rmtree(p15_dir, ignore_errors=True)
    del out
    gc.collect()
    torch.cuda.empty_cache()

    # (e) one config of each other family at full width, depth cut, two
    # steps each (jamba: SMOKE; one full-width period is 45 B parameters)
    for arch, layers in (("moonshot_v1_16b_a3b", 2), ("falcon_mamba_7b", 2),
                         ("llama_3_2_vision_11b", 5),
                         ("seamless_m4t_large_v2", None),
                         ("jamba_1_5_large_398b", 0)):
        if layers == 0:
            cfg = lm_smoke(arch)
        elif layers is None:
            cfg = lm_config(arch)
        else:
            cfg = dataclasses.replace(lm_config(arch), num_layers=layers)
        torch.cuda.reset_peak_memory_stats()
        _, step, state, data, cfg = train_mod.build(
            arch, smoke=False, batch=1, seq=512, steps=2, cfg=cfg)
        ps, opt, losses, step_s = state["params"], state["opt"], [], []
        for _ in range(2):
            t = time.perf_counter()
            ps, opt, m = step(ps, opt, train_mod.batch_to_device(
                cfg, next(data), dev))
            losses.append(float(m["loss"]))
            step_s.append(time.perf_counter() - t)
        cut = ("SMOKE" if layers == 0 else "whole" if layers is None
               else f"{layers} of {lm_config(arch).num_layers} layers")
        lm_row(f"{arch} ({cut})", cfg, losses, step_s,
               lm_T.param_count(cfg), 512)
        del step, state, data, ps, opt, m
        gc.collect()
        torch.cuda.empty_cache()
    print(f"lm runs: {json.dumps(lm_rows)}")
    p15_counts = K.launch_counts()
    if p15_counts != p15_gnn_counts:
        raise AssertionError("lm: the LM runs launched a GNN kernel: "
                             f"{p15_counts} vs {p15_gnn_counts}")
    print(f"phase-15 launches: {p15_counts}")
    print(f"phase 15: {time.perf_counter() - t15:.1f} s")

    # -- prefill, decode, the all-to-all MoE and the dry run (phase 16) ---------
    # (a) granite_3_2b whole: prefill a 512-token prompt at batch 8, then 64
    # greedy decode steps; (b) prefill(k) + decode(k+1) against
    # prefill(k+1) at granite's full width; (c) one config of each other
    # family; (d) moe_ffn_a2a on a co-located (2, 4) mesh against the
    # dense dispatch; (e) the dry run of granite's train / prefill / decode
    # cells on `meta`.  The LM stack launches no kernel of its own (the
    # reference's is XLA).
    gc.collect()
    torch.cuda.empty_cache()
    K.reset_launch_counts()
    from repro_torch.data.pipeline import SyntheticTokenStream
    from repro_torch.distributed.sharding import Constrainer
    from repro_torch.launch import dryrun as lm_dry
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.nn import moe as lm_M
    from repro_torch.nn import moe_a2a as lm_A
    from repro_torch.nn.param import ParamSpec, map_tree
    from repro_torch.training.optimizer import init_opt_state
    from repro_torch.training.train_lib import (cast_params_for_compute,
                                                make_loss_fn, make_train_step,
                                                value_and_grad)
    t16 = time.perf_counter()
    LM_BATCH, PROMPT = 8, 512

    def lm_weights(cfg, seed, dtype):
        """Weights on the card at std 0.02 (norm scales ones, biases
        zeros: the tests' numpy draw, ROADMAP §C note 4), each stacked
        leaf drawn one period slice at a time straight into `dtype`."""
        gen = torch.Generator(device=dev).manual_seed(seed)

        def draw(spec):
            if spec.init in ("zeros", "ones"):
                fill = torch.zeros if spec.init == "zeros" else torch.ones
                return fill(spec.shape, dtype=dtype, device=dev)
            out = torch.empty(spec.shape, dtype=dtype, device=dev)
            for part in (out if out.dim() > 2 else (out,)):
                part.copy_(torch.randn(part.shape, generator=gen, device=dev)
                           .mul_(0.02))
            return out
        return map_tree(draw, lm_T.model_specs(cfg),
                        is_leaf=lambda x: isinstance(x, ParamSpec))

    def tree_bytes(tree):
        return sum(t.numel() * t.element_size() for t in tree_leaves(tree))

    def lm_extras(cfg, b, s, seed=0):
        rng = np.random.default_rng(seed)
        if cfg.family == "vlm":
            return {"image_embeds": torch.from_numpy(rng.standard_normal(
                (b, cfg.n_patches, cfg.d_model)).astype(np.float32)).to(
                dev, torch.bfloat16)}
        if cfg.family == "encdec":
            return {"frames": torch.from_numpy(rng.standard_normal(
                (b, s, cfg.d_model)).astype(np.float32)).to(
                dev, torch.bfloat16)}
        return {}

    def timed(fn):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, (time.perf_counter() - t) * 1e3

    def greedy(logits, cfg):
        return (torch.argmax(logits, -1).to(torch.int32)[:, None]
                % cfg.vocab_size)

    def serve(cfg, params, tokens, extras, steps, max_len):
        """Prefill `tokens`, then `steps` greedy decode steps: (prefill
        ms, per-step ms, last logits, state)."""
        with torch.no_grad():
            (logits, state), pre_ms = timed(lambda: lm_T.prefill(
                cfg, params, tokens, extras, max_len=max_len))
            if not torch.isfinite(logits).all():
                raise AssertionError(f"lm {cfg.name}: prefill logits")
            step_ms = []
            for _ in range(steps):
                tok = greedy(logits, cfg)
                (logits, state), ms = timed(
                    lambda: lm_T.decode_step(cfg, params, state, tok))
                step_ms.append(ms)
            if not torch.isfinite(logits).all():
                raise AssertionError(f"lm {cfg.name}: decode logits")
        if int(state["pos"]) != tokens.shape[1] + steps:
            raise AssertionError(f"lm {cfg.name}: pos {int(state['pos'])}")
        return pre_ms, step_ms, logits, state

    serve_rows = []

    def serve_row(label, cfg, params, pre_ms, step_ms, state, prompt, extra):
        ms = statistics.median(step_ms[1:])
        kv = sum(t.numel() * t.element_size()
                 for slot in state["layers"].values()
                 for name, t in slot.items() if name in ("k", "v"))
        row = {"run": label, "params": lm_T.param_count(cfg),
               "layers": cfg.num_layers, "d_model": cfg.d_model,
               "batch": LM_BATCH, "prompt": prompt, "prefill_ms": pre_ms,
               "decode_steps": len(step_ms), "decode_ms_per_token": ms,
               "tokens_per_s": LM_BATCH / (ms / 1e3),
               "weight_bytes": tree_bytes(params), "kv_cache_bytes": kv,
               "peak_gib": torch.cuda.max_memory_allocated() / 2**30}
        row.update(extra)
        serve_rows.append(row)
        print(f"serve {label} [{smi}]: {row['params'] / 1e9:.3f} B params, "
              f"{cfg.num_layers} layers, d_model {cfg.d_model}; prefill "
              f"{LM_BATCH} x {prompt} {pre_ms:.1f} ms, decode "
              f"{ms:.2f} ms/token (median of steps 2-{len(step_ms)}, host "
              f"clock around a synchronise), {row['tokens_per_s']:.0f} "
              f"tokens/s, KV cache {kv / 2**20:.1f} MiB, peak "
              f"{row['peak_gib']:.2f} GiB"
              + "".join(f", {k} {v}" for k, v in extra.items()))
        return row

    # (a) granite_3_2b whole, batch 8, a 512-token prompt, 64 decode steps
    g_cfg = lm_config("granite_3_2b")
    stream = SyntheticTokenStream(g_cfg.vocab_size, LM_BATCH, PROMPT, seed=0)
    prompt = torch.from_numpy(next(stream)["tokens"]).to(dev)
    g_max = PROMPT + 64
    master = lm_weights(g_cfg, 0, torch.float32)
    # (b) first, on the same prompt: prefill(511) + decode(token 512)
    # against prefill(512)'s last logits at test_smoke_decode_matches_
    # prefill_suffix's tolerance, in fp32 (the decode path's positions,
    # cache and masks; bf16 rounding at full width is measured beside it:
    # decode against prefill, and prefill against its fp32 self)
    suffix = {}
    for name, cfg in (("fp32", dataclasses.replace(g_cfg, dtype="float32")),
                      ("bf16", g_cfg)):
        with torch.no_grad():
            full, _ = lm_T.prefill(cfg, master, prompt, max_len=PROMPT)
            _, st = lm_T.prefill(cfg, master, prompt[:, :-1], max_len=PROMPT)
            dec, _ = lm_T.decode_step(cfg, master, st, prompt[:, -1:])
        suffix[name] = (full, float((dec - full).abs().max()),
                        bool(torch.allclose(dec, full, rtol=3e-2, atol=3e-2)))
        del st, dec
    floor = float((suffix["bf16"][0] - suffix["fp32"][0]).abs().max())
    if not suffix["fp32"][2]:
        raise AssertionError(f"lm (b): fp32 decode vs prefill suffix, max "
                             f"abs {suffix['fp32'][1]}")
    print(f"serve (b) granite_3_2b full width, batch 8: prefill(511) + "
          f"decode(512) vs prefill(512), max |diff| fp32 "
          f"{suffix['fp32'][1]:.3g} (rtol = atol = 3e-2: held), bf16 "
          f"{suffix['bf16'][1]:.3g} (allclose at 3e-2: "
          f"{suffix['bf16'][2]}) beside bf16 prefill vs fp32 prefill "
          f"{floor:.3g}, over logits of max "
          f"|{float(suffix['fp32'][0].abs().max()):.3f}|")
    suffix_row = {k: v[1] for k, v in suffix.items()}
    suffix_row["bf16_vs_fp32_prefill"] = floor
    del suffix
    # the reference casts each fp32 weight to bf16 at every use; the port's
    # layers do too on fp32 weights (a "per-use" row), and the serving runs
    # use a bf16 compute copy made once, which gives the same numbers
    pu_pre, pu_steps, _, _ = serve(g_cfg, master, prompt, {}, 8, g_max)
    g16, cast_ms = timed(lambda: cast_params_for_compute(g_cfg, master))
    per_use_ms = statistics.median(pu_steps[1:])
    del master
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    pre_ms, step_ms, _, state = serve(g_cfg, g16, prompt, {}, 64, g_max)
    w_bytes = tree_bytes(g16)
    kv_tok = 2 * g_cfg.num_layers * g_cfg.n_kv_heads * g_cfg.hd * 2
    live = LM_BATCH * (PROMPT + 33) * kv_tok      # the median step's
    bound_ms = (w_bytes + live) / HBM_BYTES_PER_S * 1e3
    serve_row("granite_3_2b whole (prefill + 64 decode steps)", g_cfg, g16,
              pre_ms, step_ms, state, PROMPT,
              {"bound_ms_per_token": round(bound_ms, 4),
               "bf16_weight_gb": round(w_bytes / 1e9, 3),
               "kv_bytes_per_token": kv_tok,
               "per_use_cast_decode_ms": round(per_use_ms, 3),
               "suffix_max_abs": suffix_row,
               "per_use_cast_prefill_ms": round(pu_pre, 1),
               "bf16_copy_cast_ms": round(cast_ms, 1)})
    del g16, state
    gc.collect()
    torch.cuda.empty_cache()

    # (c) one config of each other family, bf16 weights drawn once, batch
    # 8, 16 decode steps; depth cuts recorded
    c_runs = (("falcon_mamba_7b", None, PROMPT),
              ("llama_3_2_vision_11b", None, PROMPT),
              ("seamless_m4t_large_v2", None, PROMPT),
              ("moonshot_v1_16b_a3b", None, PROMPT),
              ("jamba_1_5_large_398b", 0, PROMPT))
    for arch, layers, plen in c_runs:
        cfg = (lm_smoke(arch) if layers == 0 else lm_config(arch)
               if layers is None else
               dataclasses.replace(lm_config(arch), num_layers=layers))
        params = lm_weights(cfg, 0, torch.bfloat16)
        toks = torch.from_numpy(next(SyntheticTokenStream(
            cfg.vocab_size, LM_BATCH, plen, seed=0))["tokens"]).to(dev)
        ex = lm_extras(cfg, LM_BATCH, plen)
        torch.cuda.reset_peak_memory_stats()
        pre_ms, step_ms, _, state = serve(cfg, params, toks, ex, 16,
                                          plen + 16)
        cut = ("SMOKE" if layers == 0 else "whole" if layers is None
               else f"{layers} of {lm_config(arch).num_layers} layers")
        serve_row(f"{arch} ({cut})", cfg, params, pre_ms, step_ms, state,
                  plen, {})
        del params, state, ex
        gc.collect()
        torch.cuda.empty_cache()

    # (d) moe_ffn_a2a on a co-located (2, 4) mesh (64 experts over model
    # = 4), moonshot at full width cut to 2 layers in fp32: a training
    # step's loss and gradients and a prefill + 8 decode steps through the
    # a2a against the dense dispatch on no mesh, at a capacity factor no
    # token is dropped at; then one training step timed at 1.25.  The
    # reference test's 8.0 keeps every token for its 8 experts top-2 (a
    # block's capacity is cf * k / E of its tokens: 4x); moonshot's 64
    # experts top-6 need cf >= E / k = 10.7 for that, so the check runs at
    # ceil(E / k) = 11, every dropped token counted (none allowed), and
    # 8.0 runs beside it with its drops and differences printed
    m_cfg = dataclasses.replace(lm_config("moonshot_v1_16b_a3b"),
                                num_layers=2, dtype="float32")
    m_params = lm_weights(m_cfg, 1, torch.float32)
    mesh24 = Constrainer(make_mesh((2, 4), ("data", "model")))
    if lm_A.model_axis_size(mesh24.mesh, mesh24.rules) != 4:
        raise AssertionError("a2a: the mesh's model axis is not 4")
    batch = {k: torch.from_numpy(v).to(dev) for k, v in next(
        SyntheticTokenStream(m_cfg.vocab_size, 2, 64, seed=0)).items()}
    real_a2a, real_moe, real_route = lm_A.moe_ffn_a2a, lm_M.moe_ffn, lm_M.route

    def a2a_vs_dense(cf):
        """(worst |a2a - dense| of loss / gradients / logits, whether all
        are within tests/test_moe_a2a.py's tolerances, a2a calls in
        training and serving, tokens dropped by each path)."""
        calls, drops = [], {"dense": 0, "a2a": 0}

        def counted_a2a(*a, **kw):
            calls.append(kw.get("capacity_factor"))
            return real_a2a(*a, **kw)

        def at_cf(cfg, p, x, sc=lm_T.no_sc, **kw):
            return real_moe(cfg, p, x, sc, capacity_factor=cf)

        def counted_route(*a, **kw):
            r = real_route(*a, **kw)
            path = "a2a" if r["slot"].dim() > 1 else "dense"
            drops[path] += int((~r["keep"]).sum())
            return r

        lm_A.moe_ffn_a2a, lm_M.moe_ffn = counted_a2a, at_cf
        lm_M.route = lm_A.route = counted_route
        try:
            grads = []
            for sc in (lm_T.no_sc, mesh24):
                loss, g = value_and_grad(make_loss_fn(
                    m_cfg, sc, q_chunk=64, loss_chunk=64), m_params, batch)
                grads.append((float(loss), g))
            n_train = len(calls)
            logits = []
            for sc in (lm_T.no_sc, mesh24):
                with torch.no_grad():
                    lg, st = lm_T.prefill(m_cfg, m_params, batch["tokens"],
                                          sc=sc, max_len=64 + 8)
                    out = [lg]
                    for _ in range(8):
                        lg, st = lm_T.decode_step(m_cfg, m_params, st,
                                                  greedy(out[0], m_cfg), sc)
                        out.append(lg)
                logits.append(out)
        finally:
            lm_A.moe_ffn_a2a, lm_M.moe_ffn = real_a2a, real_moe
            lm_M.route = lm_A.route = real_route
        (l_dense, g_dense), (l_a2a, g_a2a) = grads
        worst = {"loss": abs(l_a2a - l_dense), "grad": 0.0, "logits": 0.0}
        ok = bool(np.isclose(l_a2a, l_dense, rtol=2e-4, atol=2e-4))
        for x, y in zip(tree_leaves(g_a2a), tree_leaves(g_dense)):
            ok &= bool(torch.allclose(x, y, rtol=5e-3, atol=5e-4))
            worst["grad"] = max(worst["grad"], float((x - y).abs().max()))
        for x, y in zip(logits[1], logits[0]):
            ok &= bool(torch.allclose(x, y, rtol=2e-4, atol=2e-4))
            worst["logits"] = max(worst["logits"], float((x - y).abs().max()))
        return {"cf": cf, "max_abs": worst, "within": ok,
                "a2a_calls": (n_train, len(calls) - n_train),
                "dropped": drops, "loss": (l_a2a, l_dense)}

    no_drop_cf = float(math.ceil(m_cfg.n_experts / m_cfg.top_k))
    checked = a2a_vs_dense(no_drop_cf)
    # every MoE call of the mesh runs went through the a2a: the training
    # forward's (and its recomputation's), the prefill's and 8 decodes'
    n_train, served = checked["a2a_calls"]
    if (not checked["within"] or n_train < m_cfg.num_layers
            or served != m_cfg.num_layers * 9
            or any(checked["dropped"].values())):
        raise AssertionError(f"a2a (d): {checked}")
    at_8 = a2a_vs_dense(8.0)
    gc.collect()
    torch.cuda.empty_cache()
    step_ms = {}
    for name, sc in (("dense", lm_T.no_sc), ("a2a", mesh24)):
        ps = tree_map(torch.clone, m_params)
        step = make_train_step(m_cfg, sc=sc, q_chunk=64, loss_chunk=64,
                               donate=True)
        opt = init_opt_state(ps)
        ps, opt, m = step(ps, opt, batch)          # warm
        _, ms = timed(lambda: step(ps, opt, batch))
        step_ms[name] = ms
        del ps, opt, step
        gc.collect()
        torch.cuda.empty_cache()
    print(f"a2a (d) moonshot full width, 2 of 48 layers, fp32, (2, 4) mesh "
          f"[{smi}]: at capacity factor {no_drop_cf} (no token dropped) "
          f"loss {checked['loss'][0]:.6f} vs dense {checked['loss'][1]:.6f}, "
          f"max |diff| loss {checked['max_abs']['loss']:.2e}, gradients "
          f"{checked['max_abs']['grad']:.2e}, prefill + 8 decode logits "
          f"{checked['max_abs']['logits']:.2e}; a2a calls (training, "
          f"serving) {checked['a2a_calls']}; at 8.0 the a2a dropped "
          f"{at_8['dropped']['a2a']} routed tokens, the dense path "
          f"{at_8['dropped']['dense']}, max |diff| {at_8['max_abs']}; one "
          f"step (batch 2 x 64) at 1.25: a2a {step_ms['a2a']:.1f} ms, dense "
          f"{step_ms['dense']:.1f} ms (host clock)")
    a2a_row = {"checked": checked, "at_8": at_8, "step_ms_cf125": step_ms}
    del m_params
    gc.collect()
    torch.cuda.empty_cache()

    # (e) the dry run of granite_3_2b on the single (16, 16) mesh, on meta
    dry_rows = {}
    for shape in ("train_4k", "prefill_32k", "decode_32k"):
        rec = lm_dry.run_cell("granite_3_2b", shape, "single",
                              Path(__file__).resolve().parent / "build"
                              / "smoke_dryrun")
        if rec["status"] != "ok":
            raise AssertionError(f"dry run {shape}: {rec}")
        r = rec["roofline"]
        dry_rows[shape] = {k: r[k] for k in ("compute_s", "memory_s",
                                             "dominant",
                                             "roofline_fraction")}
        dry_rows[shape]["model_flops_ratio"] = rec["model_flops_ratio"]
        print(f"dry run granite_3_2b {shape} single: {rec['status']}, "
              f"compute {r['compute_s']:.4g} s, memory {r['memory_s']:.4g} s "
              f"a device ({r['dominant']}, fraction "
              f"{r['roofline_fraction']:.3f}), model / counted FLOPs "
              f"{rec['model_flops_ratio']:.3f}, traced in {rec['trace_s']} s")
    print(f"serve runs: {json.dumps(serve_rows)}")
    print(f"phase-16 a2a and dry run: {json.dumps({'a2a': a2a_row, 'dry': dry_rows})}")
    p16_counts = K.launch_counts()
    if any(p16_counts.values()):
        raise AssertionError(f"lm serving launched a GNN kernel: {p16_counts}")
    print(f"phase 16: {time.perf_counter() - t16:.1f} s")

    phases = {"inference": path_counts, "tiled": tiled_counts,
              "b4": b4_counts, "training": train_counts,
              "staged": staged_counts, "staged_tiled": staged_tiled_counts,
              "staged_training": staged_train_counts,
              "streamed_training": stream_counts, "phase12": p12_counts,
              "serving": p13_counts, "ring": p14_counts,
              "chaos": p15_counts, "lm_serving": p16_counts}
    for rec in records:
        # a B4 record's launches are its own stage's; every other record
        # reads its launch counter over its phases
        counter, chosen = counted_by[rec["name"]]
        rec["launches"] = (b4_launches[rec["name"]]
                           if rec["name"] in b4_launches
                           else sum(phases[p][counter]
                                    for p in chosen or phases))
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
