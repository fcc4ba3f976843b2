"""The port stands alone: `src/repro_torch/**`, `chip_smoke.py` and the
port's timing scripts (`benchmarks/torch/`) import neither JAX nor the
reference package, importing the port loads neither, no kernel is built
at import time, and the CUDA sources use a plain C interface (no PyTorch
headers).  The port's tests run torch at their worker's share of the
host's cores (`tests/_torch_cpu.py`)."""
import _torch_cpu
import ast
import os
import subprocess
import sys
from pathlib import Path

import jax  # noqa: F401  (both packages in one process; JAX stays on CPU)
import pytest
import torch  # noqa: F401

ROOT = Path(__file__).resolve().parent.parent
PORT = ROOT / "src" / "repro_torch"
FILES = (sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]
         + sorted((ROOT / "benchmarks" / "torch").glob("*.py")))


def _imported_modules(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom):
            if node.level == 0 and node.module:
                yield node.module


def _forbidden(mod: str) -> bool:
    top = mod.split(".")[0]
    return top in ("jax", "jaxlib", "repro")


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_reference_import(path):
    bad = [m for m in _imported_modules(path) if _forbidden(m)]
    assert bad == [], f"{path.relative_to(ROOT)} imports {bad}"


def test_importing_the_port_loads_neither_jax_nor_the_reference():
    mods = []
    for p in sorted(PORT.rglob("*.py")):
        parts = ("repro_torch",) + p.relative_to(PORT).with_suffix("").parts
        mods.append(".".join(parts[:-1] if parts[-1] == "__init__"
                             else parts))
    code = (
        "import importlib, sys\n"
        f"for m in {mods!r}:\n"
        "    importlib.import_module(m)\n"
        "from repro_torch.kernels import _build\n"
        "bad = [m for m in sys.modules\n"
        "       if m.split('.')[0] in ('jax', 'jaxlib', 'repro')]\n"
        "assert not bad, bad\n"
        "assert not _build._LIBS, 'a kernel was built at import'\n"
        "print('ok')\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


@pytest.mark.parametrize("src", sorted((PORT / "csrc").glob("*.cu")),
                         ids=lambda p: p.name)
def test_cuda_sources_are_plain_c_launchers(src):
    text = src.read_text()
    for header in ("torch/", "ATen/", "c10/", "pybind11"):
        assert f"#include <{header}" not in text
    assert 'extern "C" int ' in text
    assert "return (int)cudaGetLastError();" in text
    # the source note names the Pallas kernel it replaces, and it exists;
    # a kernel that replaces none says so and names the reference's route
    # it stands in for, which exists
    ref = next(w for w in text.split() if w.startswith("src/repro/"))
    assert (ref.startswith("src/repro/kernels/")
            or "Replaces no TPU kernel" in text)
    assert (ROOT / ref.split("::")[0]).exists()


def test_chip_smoke_exits_nonzero_without_a_card(tmp_path):
    """In a directory holding only chip_smoke.py and on a CUDA-less box,
    the smoke fails and prints no result line."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    (tmp_path / "chip_smoke.py").write_text(
        (ROOT / "chip_smoke.py").read_text())
    out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                         capture_output=True, text=True, timeout=300,
                         env=dict(os.environ, PYTHONPATH=""))
    assert out.returncode != 0
    assert '"ok"' not in out.stdout


def test_every_cuda_source_is_built_and_counted():
    """Each `csrc/*.cu` is in the build list, and its wrapper module is
    registered for the launch counters the smoke reads (the streamed
    executor's chunk_queue kernel and the tile-part call form, the
    backward kernels and the transposed sums, B4 too)."""
    from repro_torch.kernels import _build, _modules, launch_counts
    sources = sorted(p.stem for p in (PORT / "csrc").glob("*.cu"))
    assert sorted(_build.KERNELS) == sources
    assert set(_modules()) == set(sources)
    counts = launch_counts()
    for key in ("chunk_queue_sum", "chunk_queue_sum_relu",
                "rer_gather_tile_part_sum", "rer_gather_tile_part_max",
                "rer_spmm_sum", "rer_gather_sum", "fused_engn_sum",
                "rer_spmm_sum_t", "rer_gather_sum_t", "rer_spmm_bwd_max", "rer_gather_bwd_count",
                "rer_gather_bwd_max", "feature_update_relu"):
        assert key in counts, key


def test_every_port_test_runs_at_its_share_of_the_cores():
    """Each `tests/test_torch_*.py` imports `_torch_cpu` before anything
    else, so that a worker's torch threads are its share of the cores
    whichever file it collects first; this process runs at that
    count."""
    for path in sorted((ROOT / "tests").glob("test_torch_*.py")):
        tree = ast.parse(path.read_text(), filename=str(path))
        first = next(node for node in tree.body
                     if isinstance(node, (ast.Import, ast.ImportFrom))
                     and getattr(node, "module", None) != "__future__")
        names = [alias.name for alias in getattr(first, "names", [])]
        assert isinstance(first, ast.Import) and names == ["_torch_cpu"], \
            path.name
    workers = int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))
    assert _torch_cpu.THREADS == max(1, os.cpu_count() // workers)
    assert torch.get_num_threads() == _torch_cpu.THREADS
