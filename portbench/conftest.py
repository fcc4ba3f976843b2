"""Fixtures of the harness's own tests, and the `cuda` marker: a test
that needs the card skips inside its fixture when none is present."""
import json
import shutil
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[1]

# vertices and edges of the CPU-sized copies of each configuration: the
# widths, relations and every other key stay as published
TINY = {"gcn-reddit": (700, 9000), "rgcn-am": (900, 6000)}


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA CUDA card (the port's kernels); "
        "the test skips itself when none is present")


def make_tiny_root(dest: Path) -> Path:
    """A copy of `BENCHMARK.json` and `portbench/` under `dest` whose
    configurations hold a few hundred vertices."""
    shutil.copytree(REPO / "portbench", dest / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(REPO / "BENCHMARK.json", dest)
    for name, (n, e) in TINY.items():
        path = dest / "portbench" / "configs" / f"{name}.json"
        cfg = json.loads(path.read_text())
        cfg["graph"]["vertices"], cfg["graph"]["edges"] = n, e
        if "triples" in cfg["graph"]:          # drawn, then reversed
            cfg["graph"]["triples"] = e // 2
        cfg["labelled"] = min(cfg["labelled"], n // 2)
        path.write_text(json.dumps(cfg))
    return dest


@pytest.fixture
def tiny_root(tmp_path):
    return make_tiny_root(tmp_path)


@pytest.fixture
def cuda_device():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card: the port's kernels run only on one")
    return torch.device("cuda", 0)
