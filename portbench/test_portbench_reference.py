"""The yardstick on the CPU: the references agree with the port at small
size, the frozen copies count what they should, the R-MAT rule holds,
and the trace summing reads a trace right."""
import math

import numpy as np
import pytest
import torch

from portbench.lib import cellrun, counts, plain, rmat, spec, trace
from portbench.lib.spec import Cell

CELLS = spec.cell_names()

# the `work` each configuration's cells printed on the card (graph seed 0)
# and the least FLOPs and aggregate bytes counted from it, forward and
# step: (config, train) -> (FLOPs, bytes)
CARD_WORK = {
    "gcn-reddit": {"n": 232965, "entries": 79020678, "src_rows": 232965,
                   "dst_rows": 232965, "self_term": 0},
    "rgcn-am": {"n": 1666764, "entries": 11975532, "src_rows": 8053434,
                "dst_rows": 8053434, "self_term": 1},
}
PINNED = {
    ("gcn-reddit", False): (65056891884.0, 2211464952.0),
    ("gcn-reddit", True): (132558984408.0, 4422929904.0),
    ("rgcn-am", False): (54523322160.0, 554095008.0),
    ("rgcn-am", True): (111185087880.0, 1108190016.0),
}


@pytest.mark.parametrize("cell", CELLS)
def test_reference_agrees_with_the_port_on_the_cpu(tiny_root, cell):
    """A whole run of each cell on the CPU at a few hundred vertices (the
    port's plain paths): correct, every reading under its limit."""
    line, checks = cellrun.run(cell, seed=2 ** 33 + 1, seconds=0.2,
                               traced=False, device=torch.device("cpu"),
                               t0=0.0, root=tiny_root)
    assert line["correct"] and line["failed"] == 0 and line["attempted"] > 0
    for name, value, limit in checks:
        assert value <= limit, (name, value, limit)
    assert set(line["metrics"]) >= {"setup_s", "peak_gib"}


def test_traced_run_reports_per_layer_metrics_it_can_read(tiny_root):
    line, _ = cellrun.run("gcn-reddit.infer", seed=5, seconds=0.1,
                          traced=True, device=torch.device("cpu"), t0=0.0,
                          root=tiny_root)
    # a CPU run has no device trace and no peak: only the host readings
    assert set(line["metrics"]) == {"prepare_s", "plan_gib", "build_s"}
    assert line["device"]["window_s"] > 0
    assert len(line["breakdown"]["idle_gaps"]) <= trace.TOP


def test_same_seed_same_inputs(tiny_root):
    cell = Cell("rgcn-am.train", tiny_root)
    mode = cell.mode().Mode(cell, torch.device("cpu"))
    a, b = mode.draw(2 ** 31 + 11), mode.draw(2 ** 31 + 11)
    assert torch.equal(a["x"], b["x"]) and torch.equal(a["labels"],
                                                       b["labels"])
    assert all(torch.equal(s, t) for s, t in zip(a["sets"], b["sets"]))
    c = mode.draw(2 ** 31 + 12)
    assert not torch.equal(a["x"], c["x"])
    assert [s.numel() for s in a["sets"]] == [s.numel() for s in c["sets"]]


def test_rmat_rule():
    src, dst, rel = rmat.rmat_edges(1000, 20000, seed=3,
                                    device=torch.device("cpu"),
                                    num_relations=7)
    s2, d2, r2 = rmat.rmat_edges(1000, 20000, seed=3,
                                 device=torch.device("cpu"), num_relations=7)
    assert torch.equal(src, s2) and torch.equal(dst, d2)
    assert torch.equal(rel, r2)
    assert int(src.max()) < 1000 and int(src.min()) >= 0
    assert int(rel.max()) < 7 and int(rel.min()) >= 0
    assert rmat.levels_for(232965) == 18 and rmat.levels_for(1) == 0
    # skewed: the most-connected tenth of the vertices hold most edges
    deg = torch.bincount(src.long(), minlength=1000) + torch.bincount(
        dst.long(), minlength=1000)
    assert float(deg.sort(descending=True).values[:100].sum()) > 0.3 * 40000
    assert rmat.rmat_edges(10, 5, 1, torch.device("cpu"))[2] is None


def test_dasr_copy_matches_the_port():
    from repro_torch.core.dasr import dasr_decide
    for args in ((232965, 114_832_965, 602, 128), (1000, 5000, 16, 64)):
        port = dasr_decide(*args)
        mine = counts.dasr_decide(*args)
        assert (port.order, port.fau_ops, port.afu_ops) == mine


def test_least_work_counts():
    work = {"n": 10, "entries": 40, "src_rows": 10, "dst_rows": 10,
            "self_term": 0}
    # GCN forward, FAU both layers: 2NFH + 2EH per layer
    assert counts.model_flops([8, 4, 2], work, train=False) == (
        2 * 10 * 8 * 4 + 2 * 40 * 4 + 2 * 10 * 4 * 2 + 2 * 40 * 2)
    # a step: layer 1 adds dW and A^T G; layer 2 also dX
    assert counts.model_flops([8, 4, 2], work, train=True) == (
        2 * (2 * 10 * 8 * 4 + 2 * 40 * 4)
        + 3 * 2 * 10 * 4 * 2 + 2 * 2 * 40 * 2)
    fwd = counts.aggregate_bytes([8, 4, 2], work, train=False)
    assert fwd == 12 * 40 * 2 + 8 * 10 * (4 + 2)
    assert counts.aggregate_bytes([8, 4, 2], work, train=True) == 2 * fwd
    # an R-GCN layer counts its self term per pass
    rg = dict(work, src_rows=30, dst_rows=30, self_term=1)
    fl, order, width = counts.layer_flops(
        n=10, f=8, h=4, entries=40, src_rows=30, dst_rows=30,
        self_term=True, train=False, input_trained=False)
    assert (order, width) == ("fau", 4)
    assert fl == 2 * 30 * 8 * 4 + 2 * 40 * 4 + 2 * 10 * 8 * 4
    assert counts.model_flops([8, 4], rg, train=False) == fl
    assert counts.load_peaks("NVIDIA H100 80GB HBM3")["fp32_flops_per_s"] \
        == 67e12
    assert counts.load_peaks("cpu") is None


@pytest.mark.parametrize("config,train", sorted(PINNED))
def test_least_work_of_the_current_configurations_is_pinned(config, train):
    """GCN's and R-GCN's references define no arithmetic of their own, so
    the dispatch hands the readers the DASR counts, to the FLOP and the
    byte."""
    cfg = spec.load_data("configs", config)
    flops, agg_bytes = counts.least_work(
        spec.load_module("reference", cfg["model"]))
    assert (flops, agg_bytes) == (counts.model_flops, counts.aggregate_bytes)
    got = (flops(cfg["dims"], CARD_WORK[config], train),
           agg_bytes(cfg["dims"], CARD_WORK[config], train))
    assert got == PINNED[config, train]


def test_trace_summing():
    ev = [
        {"ph": "X", "cat": "user_annotation", "name": trace.WINDOW,
         "ts": 0, "dur": 100},
        {"ph": "X", "cat": "cpu_op", "name": "aten::mm", "ts": 0, "dur": 30},
        {"ph": "X", "cat": "cpu_op", "name": "aten::relu", "ts": 60,
         "dur": 30},
        {"ph": "X", "cat": "kernel", "name": "void (anonymous namespace)::"
         "rer_gather_kernel<false, 4>(long long const*)", "ts": 10,
         "dur": 20},
        {"ph": "X", "cat": "kernel", "name": "gemm", "ts": 25, "dur": 15},
        {"ph": "X", "cat": "gpu_memset", "name": "Memset", "ts": 70,
         "dur": 10},
        {"ph": "X", "cat": "gpu_user_annotation", "name": trace.WINDOW,
         "ts": 0, "dur": 100},
    ]
    s = trace.summarise(ev, iters=2)
    assert math.isclose(s.window_s, 100e-6)
    assert math.isclose(s.busy_s, 40e-6)          # [10, 40) and [70, 80)
    assert s.launches() == 3
    fam = spec.kernel_families()
    agg = [p for f in fam if f["role"] == "aggregate" for p in f["patterns"]]
    assert math.isclose(s.family_seconds(agg), 20e-6)
    assert s.family_seconds(["(^|[ :])scatter_kernel<"]) == 0
    b = s.breakdown()
    assert b["device_ops"][0][0] == "void rer_gather_kernel<false, 4>"
    assert math.isclose(b["device_ops"][0][1], 20e-6)
    gaps = dict((k, v) for k, v in b["idle_gaps"])
    assert math.isclose(gaps["aten::mm"], 10e-6)      # [0, 10)
    assert math.isclose(gaps["host"], 30e-6)          # [40, 70): no op
    assert math.isclose(gaps["aten::relu"], 20e-6)    # [80, 100)
    assert trace.summarise(ev[1:], 2) is None


def test_tf32_rounding():
    x = torch.tensor([1.0, 1.0 + 2 ** -11, 1.0 + 3 * 2 ** -11, -3.14159])
    r = plain.round_tf32(x)
    assert r[0] == 1.0 and r[1] == 1.0            # toward zero
    assert r[2] == 1.0 + 2 ** -10
    assert -3.14159 <= float(r[3]) < -3.14159 + 2 ** -9
    a = torch.randn(5, 7, requires_grad=True)
    b = torch.randn(7, 3, requires_grad=True)
    plain.mm(a, b, "tf32").sum().backward()
    assert a.grad is not None and b.grad is not None


def test_degree_order_matches_the_port():
    from repro_torch.graphs.degree import degree_sort_permutation
    from repro_torch.graphs.format import COOGraph
    src, dst, _ = rmat.rmat_edges(300, 3000, 9, torch.device("cpu"))
    port = degree_sort_permutation(COOGraph(300, src.numpy(), dst.numpy()))
    mine = plain.degree_order(src, dst, 300).numpy()
    assert np.array_equal(port, mine)


def test_zipf_traffic_copy():
    from portbench.lib.traffic import zipf_traffic
    deg = np.array([5, 50, 1, 500, 7])
    a, b = zipf_traffic(deg, seed=4)(1000), zipf_traffic(deg, seed=4)(1000)
    assert np.array_equal(a, b) and a.dtype == np.int32
    counts = np.bincount(a, minlength=5)
    assert counts[3] > counts[1] > counts[4]     # hottest by degree rank
