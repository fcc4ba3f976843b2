#!/usr/bin/env python3
"""Time the `feature_update` kernel (B4) of whichever `repro_torch` is on
the path, at the three stages of uncut pubmed it computes.

    PYTHONPATH=<tree>/src python3 benchmarks/torch/time_feature_update.py \
        --label new [--reps 5] [--unchecked]

Stages (19,717 rows, relu, float32, inputs and weights from a seeded
generator on the card): GS-Pool extraction 500 -> 64 with a bias,
GS-Pool update 564 -> 64 and GCN afu 500 -> 64 without one.  Each is
first checked against `fused_linear_act_plain` (within 1e-5 of the
output's largest magnitude), then timed with CUDA events (min over
`--reps` runs of 20 calls) beside one `torch.addmm` + relu on the same
inputs, the yardstick the port never calls (`--unchecked` skips the
check, to time a variant tree cut short on purpose).  Prints one JSON line with
the times, the card's name and its power limit.  Put two source trees on
the path in turns (old, new, new, old) within one call to compare kernel
versions; each tree builds its kernels into its own `build/`.  Needs a
CUDA card.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys

N = 19717
STAGES = (("gs_pool_extract", 500, True), ("gs_pool_update", 564, False),
          ("gcn_afu", 500, False))
CALLS = 20


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--label", required=True)
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--unchecked", action="store_true")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("time_feature_update: no CUDA card available", file=sys.stderr)
        return 2
    from repro_torch.kernels.feature_update import ops
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)

    def timed(fn) -> float:
        fn()
        best = float("inf")
        for _ in range(args.reps):
            start = torch.cuda.Event(enable_timing=True)
            stop = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(CALLS):
                fn()
            stop.record()
            stop.synchronize()
            best = min(best, start.elapsed_time(stop) / CALLS)
        return best

    rows = {}
    with torch.inference_mode():
        for name, k, has_bias in STAGES:
            x = torch.randn((N, k), generator=gen, device=dev) * 0.1
            w = torch.randn((k, 64), generator=gen, device=dev) / k ** 0.5
            b = (torch.randn((64,), generator=gen, device=dev) * 0.1
                 if has_bias else torch.zeros(64, device=dev))
            y = ops.fused_linear_act(x, w, b, act="relu")
            want = ops.fused_linear_act_plain(x, w, b, act="relu")
            torch.cuda.synchronize()
            err = float((y - want).abs().max())
            scale = max(1.0, float(want.abs().max()))
            if not (args.unchecked or torch.allclose(
                    y, want, rtol=1e-5, atol=1e-5 * scale)):
                raise AssertionError(f"{name}: kernel disagrees (max abs "
                                     f"err {err})")
            rows[name] = {
                "shape": [N, k, 64], "max_abs_err": err,
                "ms": timed(lambda: ops.fused_linear_act(x, w, b,
                                                         act="relu")),
                "addmm_relu_ms": timed(lambda: torch.relu(
                    torch.addmm(b, x, w)))}
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    print(json.dumps({"label": args.label, "stages": rows, "card": smi}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
