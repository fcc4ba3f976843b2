"""The reader of the port's max backward counters, `max_walk_share.train`:
it reads nothing on the CPU, nothing in an inference cell, nothing from a
port without the counters, and the flagged rows' share otherwise."""
import math

import pytest

from portbench.lib import spans, spec
from portbench.lib.readers import Context
from portbench.lib.trace import TraceSummary

NAME = "max_walk_share.train"

REPORT = {
    "engn.aggregate_bwd": {"calls": 8, "host_s": 0.03, "device_s": 0.06},
    "max_bwd.rows": {"calls": 4000, "host_s": 0.0, "device_s": None},
    "max_bwd.walk_rows": {"calls": 500, "host_s": 0.0, "device_s": None},
}


def _ctx(train, trace):
    return Context(train=train, dims=[8, 4, 2], work={}, iter_s=0.01,
                   trace=trace, peaks=None, families=[], prepare_s=1.0,
                   plan_bytes=0, build_s=0.1)


def _busy():
    return TraceSummary(iters=4, window_s=0.1, busy_s=0.05,
                        device_ops=[("k", 0.0, 0.05)], gaps=[])


def test_the_reader_reads_nothing_on_the_cpu(tiny_root, monkeypatch):
    """No trace, or a traced stretch with no device operation: None,
    whatever the port counted."""
    reader = spec.load_module("metrics", NAME, tiny_root)
    monkeypatch.setattr(spans, "program_report", lambda: REPORT)
    idle = TraceSummary(iters=4, window_s=0.1, busy_s=0.0, device_ops=[],
                        gaps=[])
    assert reader.read(_ctx(True, None)) is None
    assert reader.read(_ctx(True, idle)) is None


def test_the_reader_takes_the_flagged_share(tiny_root, monkeypatch):
    """500 of 4,000 rows flagged: 12.5%, in a training cell only."""
    reader = spec.load_module("metrics", NAME, tiny_root)
    monkeypatch.setattr(spans, "program_report", lambda: REPORT)
    assert math.isclose(reader.read(_ctx(True, _busy())), 12.5)
    assert reader.read(_ctx(False, _busy())) is None


@pytest.mark.parametrize("report", [
    None, {"engn.aggregate_bwd": REPORT["engn.aggregate_bwd"]},
    {"max_bwd.rows": {"calls": 0, "host_s": 0.0, "device_s": None}}],
    ids=["no_tracing_module", "no_counters", "no_rows"])
def test_a_port_without_the_counters_reads_as_nothing(tiny_root,
                                                      monkeypatch, report):
    """The parent commit's port (no tracing module, or no counters), or
    a traced stretch with no max backward: the metric is left out, not
    raised."""
    reader = spec.load_module("metrics", NAME, tiny_root)
    monkeypatch.setattr(spans, "program_report", lambda: report)
    assert reader.read(_ctx(True, _busy())) is None
