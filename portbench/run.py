#!/usr/bin/env python3
"""The port's benchmark: one run of one cell of `BENCHMARK.json`.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s>
        --trace <0|1>

Runs from the root of a checkout on a machine with a CUDA card.  Builds
the port's kernels into the checkout's `build/` (only the first run of a
checkout compiles), makes the cell's inputs from the configuration and
the seed, prepares and warms up, measures for `--seconds`, checks what
the timed path produced against the plain reference, and prints one JSON
line last on standard output: the end-to-end metrics with `--trace 0`,
the per-layer ones with `--trace 1`.  The numbers compared, each beside
its limit, are the last lines of standard error and the line's last key.

Exits non-zero, printing no result, without a card (or with fewer cards
than the cell asks for), without the port beside it, or when JAX, the
JAX package or `benchmarks/` is loaded once the window has closed.
"""
import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "repro", "benchmarks")


def _caches() -> None:
    """Every build and kernel cache inside the checkout, at fixed paths."""
    base = ROOT / "build" / "portbench"
    for var, sub in (("TRITON_CACHE_DIR", "triton"),
                     ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TORCHINDUCTOR_CACHE_DIR", "inductor")):
        os.environ[var] = str(base / sub)


def forbidden_modules(names=None) -> list:
    """Module names (default: the loaded ones) whose top-level name
    (whole, before the first dot) is JAX's, the JAX package's or
    `benchmarks`'."""
    names = list(sys.modules) if names is None else names
    return sorted({m.split(".")[0] for m in names} & set(FORBIDDEN))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    if not (ROOT / "src" / "repro_torch").is_dir():
        print("portbench: the port (src/repro_torch) is not in this "
              "checkout", file=sys.stderr)
        return 2
    _caches()
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    import torch
    from portbench.lib import cellrun, spec

    chips = spec.Cell(args.workload, ROOT).chips
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"portbench: {args.workload} needs {chips} CUDA card(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}"
              f" available", file=sys.stderr)
        return 3
    line, checks = cellrun.run(args.workload, seed=args.seed,
                               seconds=args.seconds, traced=bool(args.trace),
                               device=torch.device("cuda", 0), t0=T0,
                               root=ROOT)
    bad = forbidden_modules()
    if bad:
        print(f"portbench: loaded {', '.join(bad)}, which the benchmark "
              f"must not", file=sys.stderr)
        return 4
    line["card"] = cellrun.card_limit()
    line["checks"] = {name: {"value": v, "limit": lim}
                      for name, v, lim in checks}
    for name, v, lim in checks:
        print(f"check {name} {v!r} limit {lim!r} "
              f"{'ok' if v <= lim else 'FAILED'}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
