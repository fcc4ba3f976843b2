#!/usr/bin/env python3
"""Where one LM training step's time goes on the card.

    python3 benchmarks/torch/profile_lm.py [--arch granite_3_2b]
        [--batch 1] [--seq 512] [--layers N]

Builds the config as `launch/train.py --arch` does (full size unless
`--layers` cuts its depth), warms up two steps, then times the step's
two halves apart over three steps with a synchronise around each
(`value_and_grad` of the loss: forward, recompute and backward; then
the in-place clip + AdamW), and traces one whole step under
`torch.profiler`: the device time of each operator's kernels, and the
device's busy share of the step's wall time.  Needs a CUDA card.
"""
from __future__ import annotations

import argparse
import dataclasses
import statistics
import subprocess
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[2] / "src"))


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("profile_lm: needs a CUDA card", file=sys.stderr)
        return 2
    from repro_torch.configs import get_config
    from repro_torch.launch import train as train_mod
    from repro_torch.nn import transformer as T
    from repro_torch.training import train_lib

    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="granite_3_2b")
    ap.add_argument("--batch", type=int, default=1)
    ap.add_argument("--seq", type=int, default=512)
    ap.add_argument("--layers", type=int, default=None)
    args = ap.parse_args()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    cfg = get_config(args.arch)
    if args.layers:
        cfg = dataclasses.replace(cfg, num_layers=args.layers)
    dev = torch.device("cuda")
    _, step, state, data, cfg = train_mod.build(
        args.arch, smoke=False, batch=args.batch, seq=args.seq, steps=10,
        cfg=cfg)
    ps, opt = state["params"], state["opt"]
    batches = [train_mod.batch_to_device(cfg, next(data), dev)
               for _ in range(6)]
    for b in batches[:2]:
        ps, opt, m = step(ps, opt, b)
    torch.cuda.synchronize()

    # the two halves apart, as make_train_step(donate=True) runs them
    q, lc = min(512, args.seq), min(256, args.seq)
    loss_fn = train_lib.make_loss_fn(cfg, q_chunk=q, loss_chunk=lc)
    opt_cfg = train_lib.AdamWConfig()
    fb, up = [], []
    for b in batches[2:5]:
        t = time.perf_counter()
        _, grads = train_lib.value_and_grad(loss_fn, ps, b)
        torch.cuda.synchronize()
        fb.append((time.perf_counter() - t) * 1e3)
        t = time.perf_counter()
        lr = train_lib.cosine_schedule(opt["count"] + 1, peak_lr=3e-4,
                                       warmup=2000, total=10)
        ps, opt, _ = train_lib._apply_update(opt_cfg, grads, opt, ps, lr,
                                             True)
        torch.cuda.synchronize()
        up.append((time.perf_counter() - t) * 1e3)
        del grads
    print(f"{args.arch} ({cfg.num_layers} layers, "
          f"{T.param_count(cfg) / 1e9:.3f} B params), batch {args.batch} x "
          f"{args.seq} [{smi}]: loss + backward "
          f"{statistics.median(fb):.1f} ms, clip + AdamW in place "
          f"{statistics.median(up):.1f} ms (median of 3, host clock with "
          f"a synchronise)")

    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        ps, opt, m = step(ps, opt, batches[5])
        float(m["loss"])
        wall = (time.perf_counter() - t) * 1e3
    events = prof.key_averages()

    def dev_us(e):
        return float(getattr(e, "self_device_time_total", None)
                     or getattr(e, "self_cuda_time_total", 0.0))

    # an operator's self device time is its kernels' time, which the
    # kernels' own entries list again: sum the device-side entries only
    device_ms = sum(dev_us(e) for e in events
                    if e.device_type == torch.autograd.DeviceType.CUDA) / 1e3
    print(f"one traced step: {wall:.1f} ms wall under the profiler, "
          f"{device_ms:.1f} ms of device time (kernels and copies: busy "
          f"share {device_ms / wall:.3f} of the wall)")
    ops = [e for e in events
           if e.device_type != torch.autograd.DeviceType.CUDA]
    for e in sorted(ops, key=dev_us, reverse=True)[:15]:
        if dev_us(e) <= 0:
            break
        print(f"  device {dev_us(e) / 1e3:9.2f} ms  {e.count:7d} x  "
              f"{e.key[:90]}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
