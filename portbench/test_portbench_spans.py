"""The readers of the port's spans, stages and counters: each loads and
reads nothing on the CPU, and the pure helpers sum a hand-made report."""
import math

import pytest
import torch

from portbench.lib import cellrun, spans, spec
from portbench.lib.readers import Context
from portbench.lib.trace import TraceSummary

NEW = ["extract_ms.infer", "aggregate_ms.infer", "update_ms.infer",
       "fwd_ms.train", "bwd_ms.train", "opt_ms.train", "plan_graph_s",
       "plan_tiles_s", "plan_groups_s", "plan_upload_s", "kernels_built"]

REPORT = {
    "engn.extract": {"calls": 8, "host_s": 0.01, "device_s": 0.004},
    "engn.aggregate": {"calls": 8, "host_s": 0.02, "device_s": 0.04},
    "step.optimizer": {"calls": 4, "host_s": 0.01, "device_s": None},
    "graph.relabel": {"calls": 2, "host_s": 3.0, "device_s": None},
    "plan.fold": {"calls": 1, "host_s": 1.5, "device_s": None},
    "build.compiled": {"calls": 0, "host_s": 0.0, "device_s": None},
}


def _ctx(train, trace):
    return Context(train=train, dims=[8, 4, 2], work={}, iter_s=0.01,
                   trace=trace, peaks=None, families=[], prepare_s=1.0,
                   plan_bytes=0, build_s=0.1)


@pytest.mark.parametrize("name", NEW)
def test_every_new_reader_reads_nothing_on_the_cpu(tiny_root, name):
    """No trace, or a traced stretch with no device operation (a CPU
    run), in either mode: None."""
    reader = spec.load_module("metrics", name, tiny_root)
    idle = TraceSummary(iters=4, window_s=0.1, busy_s=0.0, device_ops=[],
                        gaps=[])
    for train in (False, True):
        assert reader.read(_ctx(train, None)) is None
        assert reader.read(_ctx(train, idle)) is None


def test_a_traced_cpu_run_reports_none_of_them(tiny_root):
    line, _ = cellrun.run("rgcn-am.train", seed=2 ** 32 + 3, seconds=0.1,
                          traced=True, device=torch.device("cpu"), t0=0.0,
                          root=tiny_root)
    assert not set(line["metrics"]) & set(NEW)


def test_helpers_sum_a_report():
    assert math.isclose(spans.device_ms_per_iter(
        REPORT, ["engn.extract", "engn.aggregate"], 4), 11.0)
    assert spans.device_ms_per_iter(REPORT, ["step.optimizer"], 4) is None
    assert spans.device_ms_per_iter(REPORT, ["engn.update"], 4) is None
    assert spans.device_ms_per_iter(REPORT, ["engn.extract"], 0) is None
    assert math.isclose(spans.host_seconds(
        REPORT, ["graph.relabel", "graph.normalise", "plan.fold"]), 4.5)
    assert spans.host_seconds(REPORT, ["plan.upload"]) is None


def test_readers_on_a_device_trace_take_the_program_report(monkeypatch):
    """With a device operation in the trace, the readers read the
    program's report: the parent commit's port, with no tracing module,
    reads as no report."""
    busy = TraceSummary(iters=4, window_s=0.1, busy_s=0.05,
                        device_ops=[("k", 0.0, 0.05)], gaps=[])
    monkeypatch.setattr(spans, "program_report", lambda: REPORT)
    assert math.isclose(spans.span_ms(_ctx(False, busy), False,
                                      ["engn.aggregate"]), 10.0)
    assert spans.span_ms(_ctx(True, busy), False, ["engn.aggregate"]) is None
    assert math.isclose(spans.stage_s(_ctx(True, busy), ["plan.fold"]), 1.5)
    assert spans.counter(_ctx(False, busy), "build.compiled") == 0
    assert spans.counter(_ctx(False, busy), "nothing") is None
    monkeypatch.setattr(spans, "program_report", lambda: None)
    assert spans.stage_s(_ctx(True, busy), ["plan.fold"]) is None
    assert spans.counter(_ctx(False, busy), "build.compiled") is None
