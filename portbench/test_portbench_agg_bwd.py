"""The reader of the port's `engn.aggregate_bwd` span, `agg_bwd_ms.train`:
it reads nothing on the CPU, nothing in an inference cell, nothing from a
port without the span, and the span's device ms per step otherwise."""
import math

import pytest
import torch

from portbench.lib import cellrun, spans, spec
from portbench.lib.readers import Context
from portbench.lib.trace import TraceSummary

NAME = "agg_bwd_ms.train"

REPORT = {
    "engn.aggregate": {"calls": 8, "host_s": 0.02, "device_s": 0.04},
    "engn.aggregate_bwd": {"calls": 8, "host_s": 0.03, "device_s": 0.06},
}


def _ctx(train, trace):
    return Context(train=train, dims=[8, 4, 2], work={}, iter_s=0.01,
                   trace=trace, peaks=None, families=[], prepare_s=1.0,
                   plan_bytes=0, build_s=0.1)


def _busy():
    return TraceSummary(iters=4, window_s=0.1, busy_s=0.05,
                        device_ops=[("k", 0.0, 0.05)], gaps=[])


@pytest.mark.parametrize("train", [False, True])
def test_the_reader_reads_nothing_on_the_cpu(tiny_root, train):
    """No trace, or a traced stretch with no device operation: None."""
    reader = spec.load_module("metrics", NAME, tiny_root)
    idle = TraceSummary(iters=4, window_s=0.1, busy_s=0.0, device_ops=[],
                        gaps=[])
    assert reader.read(_ctx(train, None)) is None
    assert reader.read(_ctx(train, idle)) is None


def test_a_traced_cpu_run_does_not_report_it(tiny_root):
    line, _ = cellrun.run("gcn-reddit.train", seed=2 ** 32 + 5,
                          seconds=0.1, traced=True,
                          device=torch.device("cpu"), t0=0.0,
                          root=tiny_root)
    assert line["correct"] and NAME not in line["metrics"]


def test_the_reader_takes_the_span_per_step(tiny_root, monkeypatch):
    """0.06 s of device time over 4 traced steps: 15 ms a step, in a
    training cell only, and only from the backward's span."""
    reader = spec.load_module("metrics", NAME, tiny_root)
    monkeypatch.setattr(spans, "program_report", lambda: REPORT)
    assert math.isclose(reader.read(_ctx(True, _busy())), 15.0)
    assert reader.read(_ctx(False, _busy())) is None


@pytest.mark.parametrize("report", [None, {"engn.aggregate": REPORT[
    "engn.aggregate"]}], ids=["no_tracing_module", "no_backward_span"])
def test_a_port_without_the_span_reads_as_nothing(tiny_root, monkeypatch,
                                                  report):
    """The parent commit's port, with no tracing module or with tracing
    but no `engn.aggregate_bwd`: the metric is left out, not raised."""
    reader = spec.load_module("metrics", NAME, tiny_root)
    monkeypatch.setattr(spans, "program_report", lambda: report)
    assert reader.read(_ctx(True, _busy())) is None
