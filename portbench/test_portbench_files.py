"""The benchmark's files: BENCHMARK.json against its contract, every
file a cell names, and a new cell found by its files alone."""
import json
import re
import shutil

import pytest

from portbench.lib import spec

REPO = spec.ROOT

BENCH = json.loads((REPO / "BENCHMARK.json").read_text())
TOP_KEYS = {"command", "paths", "run_seconds", "configs", "workloads",
            "end_to_end", "per_layer"}
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


def _line(text, limit=200):
    return (isinstance(text, str) and 1 <= len(text) <= limit
            and "\n" not in text and "\t" not in text)


def test_top_level_keys_and_paths():
    assert set(BENCH) == TOP_KEYS
    assert BENCH["paths"] == ["portbench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert 0 < len(BENCH["command"]) <= 32
    assert all(_line(w) for w in BENCH["command"])
    assert (REPO / BENCH["command"][1]).is_file()
    assert len(json.dumps(BENCH)) < 64 * 1024


@pytest.mark.parametrize("entry", BENCH["configs"], ids=lambda e: e["name"])
def test_config_entries(entry):
    assert set(entry) == {"name", "source", "file", "reduced", "why"}
    spec.check_name(entry["name"], "config")
    assert _line(entry["source"]) and _line(entry["why"])
    assert entry["file"].startswith("portbench/configs/")
    cfg = json.loads((REPO / entry["file"]).read_text())
    assert cfg["name"] == entry["name"]
    assert cfg["reduced"] == entry["reduced"] == []
    assert any(w["config"] == entry["name"] for w in BENCH["workloads"])


@pytest.mark.parametrize("entry", BENCH["workloads"], ids=lambda e: e["name"])
def test_workload_entries_find_their_files(entry):
    assert set(entry) == {"name", "config", "traffic", "chips", "why"}
    for key in ("name", "config", "traffic"):
        spec.check_name(entry[key], key)
    assert entry["chips"] == 1 and _line(entry["why"])
    cell = spec.Cell(entry["name"])
    assert cell.mode().Mode and cell.reference().forward
    assert cell.limits() and int(cell.own["trace_iters"]) > 0
    reported = {m["name"] for m in cell.metrics("end_to_end")}
    assert "setup_s" in reported and len(reported) >= 2
    layer = cell.metrics("per_layer")
    assert layer and all(m["moves"] in reported for m in layer)


@pytest.mark.parametrize("section", ["end_to_end", "per_layer"])
def test_metric_entries(section):
    names = [m["name"] for m in BENCH[section]]
    assert len(names) == len(set(names))
    cells = {w["name"] for w in BENCH["workloads"]}
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    for m in BENCH[section]:
        spec.check_name(m["name"], "metric")
        assert spec.UNIT_RE.match(m["unit"]) and m["better"] in ("lower",
                                                                "higher")
        assert m["source"] in SOURCES
        assert set(m.get("workloads", [])) <= cells
        if section == "end_to_end":
            assert m["source"] in ("host_clock", "device_trace")
            assert 0.01 <= m["bound"] <= 0.25
        else:
            assert m["moves"] in e2e and _line(m["layer"])
            reader = spec.load_module("metrics", m["name"])
            assert callable(reader.read)
    if section == "end_to_end":
        assert "setup_s" in e2e


def test_kernel_families_compile():
    fams = spec.kernel_families()
    assert {f["family"] for f in fams} >= {"rer_gather", "rer_gather_bwd",
                                           "rer_gather_max_count"}
    for fam in fams:
        assert fam["role"] and [re.compile(p) for p in fam["patterns"]]


def test_files_under_paths_are_named_from_names():
    for path in (REPO / "portbench").rglob("*"):
        if "__pycache__" in path.parts:
            continue
        rel = path.relative_to(REPO).as_posix()
        assert re.fullmatch(r"[A-Za-z0-9_.\-/]{1,200}", rel), rel


def test_a_new_cell_is_found_by_its_files_alone(tmp_path):
    """A configuration, a cell, a metric and a kernel family added as new
    files and BENCHMARK.json entries, with no existing file edited."""
    shutil.copytree(REPO / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    pb = tmp_path / "portbench"
    cfg = json.loads((pb / "configs" / "gcn-reddit.json").read_text())
    cfg.update(name="gcn-extra", dims=[602, 64, 41])
    (pb / "configs" / "gcn-extra.json").write_text(json.dumps(cfg))
    (pb / "workloads" / "gcn-extra.infer.json").write_text(
        json.dumps({"trace_iters": 3, "limits": {"logit_gap": 1e-4}}))
    (pb / "metrics" / "extra_count.py").write_text(
        "def read(ctx):\n    return 1.0\n")
    (pb / "kernels" / "extra.json").write_text(json.dumps(
        {"family": "extra", "role": "aggregate", "patterns": ["^extra"]}))
    bench["configs"].append({"name": "gcn-extra", "source": "x",
                             "file": "portbench/configs/gcn-extra.json",
                             "reduced": [], "why": "x"})
    bench["workloads"].append({"name": "gcn-extra.infer",
                               "config": "gcn-extra", "traffic": "infer",
                               "chips": 1, "why": "x"})
    bench["per_layer"].append({"name": "extra_count", "unit": "1",
                               "better": "lower", "source": "host_clock",
                               "layer": "plan", "moves": "setup_s",
                               "workloads": ["gcn-extra.infer"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    cell = spec.Cell("gcn-extra.infer", tmp_path)
    assert cell.config["dims"] == [602, 64, 41]
    assert cell.mode().Mode.train is False
    assert "extra_count" in {m["name"] for m in cell.metrics("per_layer")}
    assert spec.load_module("metrics", "extra_count", tmp_path).read(None)
    assert "extra" in {f["family"] for f in spec.kernel_families(tmp_path)}


@pytest.mark.parametrize("bad", ["", "a b", "a,b", "a/b", "-a", "x" * 65,
                                 "é"])
def test_bad_names_are_refused(bad):
    with pytest.raises(ValueError):
        spec.check_name(bad, "name")
