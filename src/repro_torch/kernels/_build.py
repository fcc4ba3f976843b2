"""Build the port's CUDA kernels at first use and load them with ctypes.

Each `csrc/<name>.cu` exports a plain C launcher (no PyTorch headers), so
`nvcc` builds it in seconds:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
         -Xcompiler -fPIC -o lib<name>.so <name>.cu

The first `load()` builds every missing library, one `nvcc` per source,
all started together, into `build/repro_torch/<hash>/` at the repository
root; the hash covers the sources and the flags, so an edited kernel
builds anew and an unchanged one is reused.  Each compiler log (with
`-Xptxas -v`: registers, shared memory, spills) stays beside its
library as `<name>.log`.  The `build.compiled` counter of
`repro_torch.tracing` counts the libraries nvcc built in this process.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict

from repro_torch.tracing import count

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
KERNELS = ("rer_spmm", "rer_gather", "fused_engn", "chunk_queue",
           "rer_spmm_bwd", "rer_gather_bwd", "feature_update",
           "typed_pairs", "rer_gather_gated")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LIBS: Dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH); "
                       "the CUDA kernels build only where the toolkit is")


def build_dir() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh")):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_ROOT / h.hexdigest()[:16]


def build_all() -> Path:
    """Build every kernel library that is not built yet, in parallel.
    Returns the build directory."""
    out = build_dir()
    todo = [k for k in KERNELS if not (out / f"lib{k}.so").exists()]
    if not todo:
        count("build.compiled", 0)
        return out
    out.mkdir(parents=True, exist_ok=True)
    nvcc = nvcc_path()
    jobs = []
    for name in todo:
        tmp = out / f"lib{name}.so.{os.getpid()}.tmp"
        log = out / f"{name}.log"
        with open(log, "w") as fh:
            proc = subprocess.Popen(
                [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")],
                stdout=fh, stderr=subprocess.STDOUT)
        jobs.append((name, tmp, log, proc))
    failed = []
    for name, tmp, log, proc in jobs:
        if proc.wait() != 0:
            failed.append(f"--- {name} ---\n{log.read_text()}")
        else:
            os.replace(tmp, out / f"lib{name}.so")
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    count("build.compiled", len(todo))
    return out


def load(name: str) -> ctypes.CDLL:
    """The loaded library of one kernel, built on first use."""
    lib = _LIBS.get(name)
    if lib is None:
        lib = ctypes.CDLL(str(build_all() / f"lib{name}.so"))
        _LIBS[name] = lib
    return lib
