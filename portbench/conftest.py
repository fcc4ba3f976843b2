"""Fixtures of the harness's own tests, and the `cuda` marker: a test
that needs the card skips inside its fixture when none is present."""
import json
import shutil
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[1]

# vertices and edges of the CPU-sized copies of the configurations (any
# configuration not named here takes TINY_DEFAULT): the widths, relations
# and every other key stay as published
TINY = {"gcn-reddit": (700, 9000), "rgcn-am": (900, 6000)}
TINY_DEFAULT = (600, 6000)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA CUDA card (the port's kernels); "
        "the test skips itself when none is present")


def shrink_configs(root: Path) -> None:
    """Cut every configuration under `root` to its CPU size."""
    for path in sorted((root / "portbench" / "configs").glob("*.json")):
        n, e = TINY.get(path.stem, TINY_DEFAULT)
        cfg = json.loads(path.read_text())
        cfg["graph"]["vertices"], cfg["graph"]["edges"] = n, e
        if "triples" in cfg["graph"]:          # drawn, then reversed
            cfg["graph"]["triples"] = e // 2
        if "labelled" in cfg:
            cfg["labelled"] = min(cfg["labelled"], n // 2)
        path.write_text(json.dumps(cfg))


def make_tiny_root(dest: Path) -> Path:
    """A copy of `BENCHMARK.json` and `portbench/` under `dest` whose
    configurations hold a few hundred vertices."""
    shutil.copytree(REPO / "portbench", dest / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(REPO / "BENCHMARK.json", dest)
    shrink_configs(dest)
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
