"""What a run loads: nothing of JAX, of the JAX package `repro` or of
`benchmarks/` (top-level module names compared whole: `repro_torch`
starts with `repro`), and the run refuses without a card."""
import json
import subprocess
import sys
import textwrap

import pytest

from portbench import run
from portbench.lib import spec

PROBE = textwrap.dedent("""
    import json, sys, torch
    from pathlib import Path
    sys.path[:0] = [{repo!r}, {src!r}]
    torch.set_num_threads(1)    # tiny cells, beside the suite's workers
    from portbench.lib import cellrun, spec
    for cell in spec.cell_names(root=Path({root!r})):
        cellrun.run(cell, seed=1, seconds=0.05, traced=True,
                    device=torch.device("cpu"), t0=0.0, root=Path({root!r}))
    print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
""")


def test_a_run_loads_no_jax_and_no_reference_package(tiny_root):
    code = PROBE.format(repo=str(spec.ROOT), src=str(spec.ROOT / "src"),
                        root=str(tiny_root))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, cwd=tiny_root)
    assert out.returncode == 0, out.stderr[-2000:]
    top = set(json.loads(out.stdout.strip().splitlines()[-1]))
    assert "repro_torch" in top and "portbench" in top
    assert not top & set(run.FORBIDDEN), top & set(run.FORBIDDEN)


def test_forbidden_names_are_compared_whole():
    assert run.forbidden_modules(["repro_torch.core", "jaxtyping",
                                  "benchmarks_x", "portbench.lib"]) == []
    assert run.forbidden_modules(["repro.core", "jax", "flax.linen",
                                  "benchmarks.torch"]) == [
        "benchmarks", "flax", "jax", "repro"]


def test_the_run_refuses_without_a_card(monkeypatch, capsys):
    import torch
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(run, "_caches", lambda: None)   # leave the env be
    assert run.main(["--workload", "gcn-reddit.infer", "--seed", "1",
                     "--seconds", "1"]) != 0
    assert capsys.readouterr().out == ""


@pytest.mark.cuda
def test_a_small_run_on_the_card(tiny_root, cuda_device):
    """Every cell at a few hundred vertices through the card's kernels."""
    from portbench.lib import cellrun
    for cell in spec.cell_names(root=tiny_root):
        line, _ = cellrun.run(cell, seed=3, seconds=0.2, traced=True,
                              device=cuda_device, t0=0.0, root=tiny_root)
        assert line["correct"] and line["device"]["platform"] == "gpu"
        assert line["device"]["busy_s"] > 0


def test_a_checkout_without_the_port_prints_no_result(tmp_path):
    """Only BENCHMARK.json and the files under `paths`: the run exits
    non-zero and prints nothing on standard output."""
    import shutil
    shutil.copytree(spec.ROOT / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(spec.ROOT / "BENCHMARK.json", tmp_path)
    out = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload",
         "gcn-reddit.infer", "--seed", "1", "--seconds", "1", "--trace",
         "0"], capture_output=True, text=True, timeout=120, cwd=tmp_path,
        env={"PATH": "/usr/bin:/bin"})
    assert out.returncode != 0 and out.stdout == ""
