#!/usr/bin/env python3
"""Time R-GCN's typed pair projection (`kernels/typed_pairs`) at the
shapes of the benchmark's `rgcn-am` configuration, on the card.

    PYTHONPATH=src python3 benchmarks/torch/time_typed_pairs.py \
        [--reps 3] [--unchecked]

Makes AM's graph as the benchmark does (`portbench/lib/rmat.py`: 5.99 M
R-MAT triples and their inverses over 266 relations, 1,666,764 vertices,
degree relabel), prepares the port's typed blocked plan (`auto`: flat
entries and their (src, relation) pairs) and prints the plan's host
seconds by stage.  Then, at both layers' widths (267 -> 10, 10 -> 11),
with inputs from a seeded generator on the card, each pass of the
kernel, the projection, dW and dX, is first checked against its plain
version (within 1e-5 of the output's largest magnitude; `--unchecked`
skips it) and timed with CUDA events (min over `--reps` runs of a few
calls) beside its bound (max of bytes at 3.35 TB/s and operations at
67 TFLOP/s), its plain version (per relation `index_select` + `mm`)
and the route it replaced (the (N, R*H) einsum payload and the gather
of the pairs' rows; its gradients through that payload).  Prints one
JSON line with the times, the card's name and its power limit.  Needs a
CUDA card.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
HBM_BYTES_PER_S = 3.35e12         # H100 SXM, published
FP32_OPS_PER_S = 67e12            # H100 SXM, CUDA cores, published
LAYERS = ((267, 10), (10, 11))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--unchecked", action="store_true")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("time_typed_pairs: no CUDA card available", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    import repro_torch as rt
    from portbench.lib import program
    from portbench.lib.rmat import config_edges
    from repro_torch import tracing
    from repro_torch.kernels import _build
    from repro_torch.kernels.typed_pairs import ops
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    _build.build_all()

    cfg = json.loads((ROOT / "portbench" / "configs" / "rgcn-am.json")
                     .read_text())
    g = program.host_graph(*config_edges(cfg, dev), cfg)
    g, _ = program.relabel_and_normalise(g, cfg, {})
    layer = program.make_layers(cfg, dev, training=True)[0]
    tracing.reset()
    t = time.perf_counter()
    plan = rt.prepare_graph(g, layer.cfg, device=dev)
    prepare_s = time.perf_counter() - t
    stages = {k: round(v["host_s"], 3) for k, v in tracing.report().items()
              if k.startswith(("plan.", "graph."))}
    pairs = plan.carrier["typed_pairs"]
    n, r, p = g.num_vertices, pairs.num_relations, pairs.num_pairs
    print(f"plan: {prepare_s:.3f} s, stages {stages}; N {n}, R {r}, "
          f"{plan.carrier['typed_flat'][0].numel()} entries, P {p} pairs "
          f"({100 * p / (n * r):.2f}% of N R), "
          f"{pairs.blocks.shape[0]} blocks, {pairs.wblocks.shape[0]} dW "
          f"blocks", flush=True)
    rel = torch.repeat_interleave(
        torch.arange(r, device=dev),
        torch.from_numpy(pairs.pair_ptr[1:] - pairs.pair_ptr[:-1]).to(dev))
    key = pairs.pair_src.long() * r + rel
    gen = torch.Generator(device=dev).manual_seed(0)

    def timed(fn, calls=3) -> float:
        fn()
        torch.cuda.synchronize()
        best = float("inf")
        for _ in range(args.reps):
            start = torch.cuda.Event(enable_timing=True)
            stop = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(calls):
                fn()
            stop.record()
            stop.synchronize()
            best = min(best, start.elapsed_time(stop) / calls)
        return best

    def bound_ms(nbytes, ops_) -> float:
        return 1e3 * max(nbytes / HBM_BYTES_PER_S, ops_ / FP32_OPS_PER_S)

    def check(name, got, want):
        scale = max(1.0, float(want.abs().max()))
        if not torch.allclose(got, want, rtol=1e-5, atol=1e-5 * scale):
            err = float((got - want).abs().max())
            raise SystemExit(f"{name}: kernel and plain differ by {err}")

    rows = {}
    for f, h in LAYERS:
        x = torch.randn((n, f), generator=gen, device=dev)
        wr = torch.randn((r, f, h), generator=gen, device=dev) / f ** 0.5
        dy = torch.randn((p, h), generator=gen, device=dev)
        kern = {
            "project": lambda: ops._project(x, wr, pairs),
            "grad_w": lambda: ops._grad_w(x, dy, pairs, wr.shape),
            "grad_x": lambda: ops._grad_x(dy, wr, pairs, x.shape)}
        plain = {
            "project": lambda: ops.typed_pair_project_plain(x, wr, pairs),
            "grad_w": lambda: ops.typed_pair_grad_w_plain(x, dy, pairs,
                                                          wr.shape),
            "grad_x": lambda: ops.typed_pair_grad_x_plain(dy, wr, pairs,
                                                          x.shape)}

        def payload_grad():
            return torch.zeros((n * r, h), device=dev).index_add_(
                0, key, dy).view(n, r, h)
        replaced = {
            "project": lambda: torch.einsum(
                "nf,rfh->nrh", x, wr).reshape(n * r, h)[key],
            "grad_w": lambda: torch.einsum("nf,nrh->rfh", x,
                                           payload_grad()),
            "grad_x": lambda: torch.einsum("nrh,rfh->nf", payload_grad(),
                                           wr)}
        ops_ = 2.0 * p * f * h
        nbytes = {"project": 4 * (p * f + p * h + r * f * h + p),
                  "grad_w": 4 * (p * f + p * h + r * f * h + p),
                  "grad_x": 4 * (p * h + p + n * f + r * f * h)}
        for name in ("project", "grad_w", "grad_x"):
            if not args.unchecked:
                check(f"{name} {f}x{h}", kern[name](), plain[name]())
            row = {"ms": timed(kern[name]),
                   "bound_ms": bound_ms(nbytes[name], ops_),
                   "by": ("bytes" if nbytes[name] / HBM_BYTES_PER_S
                          >= ops_ / FP32_OPS_PER_S else "operations"),
                   "plain_ms": timed(plain[name], 1),
                   "replaced_ms": timed(replaced[name], 1)}
            rows[f"typed_pairs_{name}_{f}x{h}"] = row
            print(f"typed_pairs_{name} {f}x{h}: " + ", ".join(
                f"{k} {v:.4f}" if isinstance(v, float) else f"{k} {v}"
                for k, v in row.items()), flush=True)
            torch.cuda.empty_cache()
        del x, wr, dy
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(json.dumps({"card": smi, "prepare_s": prepare_s,
                      "stages": stages, "pairs": p, "rows": rows}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
