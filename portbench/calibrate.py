#!/usr/bin/env python3
"""The readings a cell's limits are set from, on the card at the cell's
own size (never run by the benchmark's own runs).

    python3 portbench/calibrate.py --workload <cell> --base-seed <n>
        [--seeds 12] [--controls 3]

Prepares the cell's program once (the graph and the plan do not depend
on the seed) and then, for each of `--seeds` seeds, binds that seed's
inputs into the same program objects, drives the timed call (a forward,
or the checked training steps) and compares what it produced with the
plain reference in float64, as a run's check does: the lower readings.
For the first `--controls` seeds it also compares the reference in the
program's place computed in the next precision down (TF32 products for
the float32 configurations) and each fault the mode can plant in it:
the upper readings.  `--witness` also holds the reference in float32
against float64 on every seed.  Prints one JSON line per reading (with each
step's and each leaf's gaps) and a summary line last.
"""
import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--base-seed", type=int, required=True)
    ap.add_argument("--seeds", type=int, default=12)
    ap.add_argument("--controls", type=int, default=3)
    ap.add_argument("--witness", action="store_true",
                    help="also hold the plain reference in float32 against "
                         "float64 on every seed: a second sound float32 "
                         "evaluation beside the program")
    args = ap.parse_args(argv)
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    import torch
    from portbench.lib import program, spec
    from portbench.modes.infer import sync

    if not torch.cuda.is_available():
        print("calibrate: needs a CUDA card", file=sys.stderr)
        return 3
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cell = spec.Cell(args.workload, ROOT)
    mode = cell.mode().Mode(cell, dev)
    program.build_kernels(dev)
    mode.make_graph()
    seeds = [args.base_seed + 7919 * i for i in range(args.seeds)]
    t = time.perf_counter()
    mode.prepare(mode.draw(seeds[0]))
    print(json.dumps({"prepare_s": time.perf_counter() - t,
                      "times": mode.times}), flush=True)
    lower, upper, witness = {}, {}, {}

    def emit(kind, seed, readings, detail=None):
        print(json.dumps({"kind": kind, "seed": seed, **readings,
                          **({"detail": detail} if detail else {})}),
              flush=True)
        return readings

    for i, seed in enumerate(seeds):
        inputs = mode.draw(seed)
        mode.bind(inputs)
        mode.iterate()
        sync(dev)
        ref = mode.reference(inputs)
        out = mode.outputs()
        r = emit("program", seed, mode.compare(inputs, ref, out),
                 mode.detail(inputs, ref, out))
        if args.witness:
            narrow = mode.reference(inputs, "fp32")
            w = emit("witness_fp32_vs_fp64", seed,
                     mode.compare(inputs, ref, narrow),
                     mode.detail(inputs, ref, narrow))
            for k, v in w.items():
                witness[k] = max(witness.get(k, 0.0), v)
            del narrow
        for k, v in r.items():
            lower[k] = max(lower.get(k, 0.0), v)
        if i < args.controls:
            cands = {"control_tf32": mode.reference(inputs, "tf32")}
            for fault in mode.faults:
                cands[f"fault_{fault}"] = mode.reference(inputs,
                                                         fault=fault)
            for kind, cand in cands.items():
                r = emit(kind, seed, mode.compare(inputs, ref, cand),
                         mode.detail(inputs, ref, cand))
                for k, v in r.items():
                    slot = upper.setdefault(kind, {})
                    slot[k] = min(slot.get(k, float("inf")), v)
        del ref, inputs
        torch.cuda.empty_cache()
    print(json.dumps({"summary": args.workload, "lower": lower,
                      "upper": upper, "witness_fp32": witness,
                      "limits": cell.limits(),
                      "card": torch.cuda.get_device_name(dev)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
