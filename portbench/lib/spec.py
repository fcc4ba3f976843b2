"""Finding a cell's files by name.

`BENCHMARK.json` lists the cells; each names a configuration and a
traffic mix, and the harness finds every other file by those names, so a
new cell, configuration, metric or kernel family is new files and new
entries, never an edit.
"""
from __future__ import annotations

import importlib.util
import json
import re
from pathlib import Path
from types import ModuleType
from typing import Any, Dict, List, Optional

ROOT = Path(__file__).resolve().parents[2]

NAME_RE = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT_RE = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def check_name(name: str, what: str) -> str:
    if not isinstance(name, str) or not NAME_RE.match(name):
        raise ValueError(f"{what} {name!r}: a name is 1-64 letters, digits, "
                         f"'_', '.' and '-', starting with a letter, a digit "
                         f"or '_'")
    return name


def _json(path: Path) -> Dict[str, Any]:
    with open(path) as fh:
        return json.load(fh)


def load_benchmark(root: Path = ROOT) -> Dict[str, Any]:
    return _json(root / "BENCHMARK.json")


def workload_entry(bench: Dict[str, Any], cell: str) -> Dict[str, Any]:
    for w in bench["workloads"]:
        if w["name"] == cell:
            return w
    raise KeyError(f"no workload {cell!r} in BENCHMARK.json")


def bench_dir(root: Path = ROOT) -> Path:
    return root / "portbench"


def load_data(kind: str, name: str, root: Path = ROOT) -> Dict[str, Any]:
    """`portbench/<kind>/<name>.json`: a configuration, a traffic mix or a
    cell's own file."""
    check_name(name, kind)
    return _json(bench_dir(root) / kind / f"{name}.json")


def _module(path: Path, label: str) -> ModuleType:
    spec = importlib.util.spec_from_file_location(label, path)
    if spec is None or spec.loader is None:
        raise ImportError(f"cannot load {path}")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def load_module(kind: str, name: str, root: Path = ROOT) -> ModuleType:
    """`portbench/<kind>/<name>.py` (a mode, a metric reader or a
    reference model), loaded by path so that a name may hold dots."""
    check_name(name, kind)
    return _module(bench_dir(root) / kind / f"{name}.py",
                   f"portbench_{kind}_{name.replace('.', '_')}")


def kernel_families(root: Path = ROOT) -> List[Dict[str, Any]]:
    """Every `portbench/kernels/<family>.json`: name patterns of one
    family of device kernels and the role its time counts under."""
    out = []
    for path in sorted((bench_dir(root) / "kernels").glob("*.json")):
        fam = _json(path)
        fam.setdefault("family", path.stem)
        out.append(fam)
    return out


def cell_names(mode: Optional[str] = None, root: Path = ROOT) -> List[str]:
    """The cells of `BENCHMARK.json` in its order; with `mode`, those whose
    traffic mix that mode drives ("infer", "train")."""
    bench = load_benchmark(root)
    return [w["name"] for w in bench["workloads"]
            if mode is None
            or load_data("traffic", w["traffic"], root)["mode"] == mode]


def cell_metrics(bench: Dict[str, Any], cell: str,
                 section: str) -> List[Dict[str, Any]]:
    """The entries of `end_to_end` or `per_layer` that this cell reports:
    those that list it under `workloads`, and those with no such list."""
    return [m for m in bench[section]
            if "workloads" not in m or cell in m["workloads"]]


class Cell:
    """A cell's entry and the files it names."""

    def __init__(self, cell: str, root: Path = ROOT):
        self.root = root
        self.bench = load_benchmark(root)
        self.entry = workload_entry(self.bench, cell)
        self.name = cell
        self.config = load_data("configs", self.entry["config"], root)
        self.traffic = load_data("traffic", self.entry["traffic"], root)
        self.own = load_data("workloads", cell, root)
        self.chips = int(self.entry["chips"])

    def mode(self) -> ModuleType:
        return load_module("modes", self.traffic["mode"], self.root)

    def reference(self) -> ModuleType:
        return load_module("reference", self.config["model"], self.root)

    def metrics(self, section: str) -> List[Dict[str, Any]]:
        return cell_metrics(self.bench, self.name, section)

    def limits(self) -> Dict[str, float]:
        return dict(self.own["limits"])
