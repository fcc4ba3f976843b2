"""`repro_torch.tracing`: the off path is one flag check, spans land in
the profiler's trace nested as they ran, set-up stages fill the table,
and `report()` has its shape.  Torch and numpy only (no JAX), so the
`cuda` case runs on the card as it is."""
import _torch_cpu  # noqa: F401  (this worker's share of the cores)
import json

import numpy as np
import pytest
import torch

import repro_torch as rt
from repro_torch import tracing
from repro_torch.core.engn import upload_groups
from repro_torch.graphs.degree import (apply_vertex_permutation,
                                       degree_sort_permutation)
from repro_torch.graphs.format import COOGraph
from repro_torch.graphs.partition import build_tile_store, pack_tile_store
from repro_torch.kernels.rer_gather import ops as gather_ops
from repro_torch.kernels.rer_gather_bwd import ops as gather_bwd_ops
from repro_torch.training.optimizer import init_opt_state
from repro_torch.training.train_lib import make_gnn_train_step

CPU = torch.profiler.ProfilerActivity.CPU
ENGN = {"engn.extract", "engn.aggregate", "engn.update"}
STEP = {"step.forward", "step.backward", "step.optimizer"}


def _graph(n=300, e=2400, relations=1, seed=0):
    rng = np.random.default_rng(seed)
    rel = (rng.integers(0, relations, e).astype(np.int32)
           if relations > 1 else None)
    return COOGraph(n, rng.integers(0, n, e).astype(np.int32),
                    rng.integers(0, n, e).astype(np.int32), None, rel,
                    relations)


def _gcn(n=300, dims=(8, 6, 3)):
    """A relabelled, normalised graph, a packed blocked GCN stack on the
    CPU, its plan and features."""
    g = _graph(n)
    g = apply_vertex_permutation(g, degree_sort_permutation(g))
    g = g.gcn_normalized()
    layers = rt.make_gnn_stack("gcn", list(dims), backend="blocked",
                               tile=64, device="cpu")
    for layer in layers:
        layer.cfg.tile_format = "packed"
    plan = rt.prepare_graph(g, layers[0].cfg, device="cpu")
    x = torch.from_numpy(np.random.default_rng(1).standard_normal(
        (n, dims[0])).astype(np.float32))
    return layers, plan, x


def _step(layers, plan, x):
    def loss_fn(params, batch):
        return rt.apply_stack(layers, plan, x, params=params).square().mean()
    params = [{k: v.detach().clone() for k, v in layer.named_parameters()}
              for layer in layers]
    return make_gnn_train_step(loss_fn)(params, init_opt_state(params), {})


def test_off_path_is_one_flag_check(monkeypatch):
    """With no profiler recording, a forward and a train step make no
    `record_function`, no clock read and no CUDA event, and record
    nothing; the numbers are those of an untouched run."""
    layers, plan, x = _gcn()
    want = rt.apply_stack(layers, plan, x)

    def refuse(*a, **k):
        raise AssertionError("the off path made a call")
    tracing.reset()
    monkeypatch.setattr(tracing, "record_function", refuse)
    monkeypatch.setattr(tracing, "perf_counter", refuse)
    monkeypatch.setattr(torch.cuda, "Event", refuse)
    assert tracing.span("engn.extract") is tracing._NULL
    with tracing.span("engn.extract"):
        pass
    assert torch.equal(rt.apply_stack(layers, plan, x), want)
    _step(layers, plan, x)
    assert tracing.report() == {}


def test_spans_nest_in_the_exported_trace(tmp_path):
    tracing.reset()
    with torch.profiler.profile(activities=[CPU]) as prof:
        with tracing.span("outer"):
            with tracing.span("inner"):
                torch.ones(4).add_(1)
            with tracing.span("inner"):
                pass
    out = tmp_path / "trace.json"
    prof.export_chrome_trace(str(out))
    events = json.loads(out.read_text())["traceEvents"]
    ann = {}
    for ev in events:
        if ev.get("cat") == "user_annotation" and ev.get("ph") == "X":
            ann.setdefault(ev["name"], []).append(
                (float(ev["ts"]), float(ev["ts"]) + float(ev["dur"])))
    (o0, o1), = ann["outer"]
    assert len(ann["inner"]) == 2
    assert all(o0 <= s <= e <= o1 for s, e in ann["inner"])
    rep = tracing.report()
    assert rep["outer"]["calls"] == 1 and rep["inner"]["calls"] == 2


def test_forward_and_step_spans_under_a_profiler():
    """Two layers: each EnGN stage twice a forward; a step's three
    phases once, its forward holding the layers' stages."""
    layers, plan, x = _gcn()
    tracing.reset()
    with torch.profiler.profile(activities=[CPU]):
        rt.apply_stack(layers, plan, x)
    rep = tracing.report()
    assert set(rep) == ENGN
    assert all(rep[k]["calls"] == 2 for k in ENGN)
    tracing.reset()
    with torch.profiler.profile(activities=[CPU]):
        _step(layers, plan, x)
    rep = tracing.report()
    assert set(rep) == ENGN | STEP
    assert all(rep[k]["calls"] == 1 for k in STEP)
    assert rep["step.forward"]["host_s"] >= rep["engn.aggregate"]["host_s"]


def test_prepare_graph_fills_the_plan_stages():
    tracing.reset()
    _gcn()
    rep = tracing.report()
    # a CPU plan takes the flat entries: no bucket groups, no upload
    assert set(rep) == {"graph.relabel", "graph.normalise", "plan.tiles",
                        "plan.pack", "plan.format", "plan.groups"}
    assert rep["graph.relabel"]["calls"] == 2
    assert all(v["host_s"] > 0 and v["device_s"] is None
               for v in rep.values())
    tracing.reset()
    layers = rt.make_gnn_stack("rgcn", [8, 4, 3], backend="blocked",
                               tile=64, num_relations=3, device="cpu")
    layers[0].cfg.tile_format = "auto"
    rt.prepare_graph(_graph(relations=3), layers[0].cfg, device="cpu")
    assert set(tracing.report()) == {"plan.fold", "plan.tiles", "plan.pack",
                                     "plan.groups"}


def test_report_shape_and_reset():
    tracing.reset()
    tracing.count("built", 0)
    tracing.count("built", 2)
    with tracing.stage("set-up"):
        pass
    rep = tracing.report()
    assert rep["built"] == {"calls": 2, "host_s": 0.0, "device_s": None}
    assert rep["set-up"]["calls"] == 1 and rep["set-up"]["host_s"] >= 0
    assert rep["set-up"]["device_s"] is None
    tracing.reset()
    assert tracing.report() == {}


@pytest.mark.cuda
def test_device_seconds_on_a_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    a = torch.randn(2048, 2048, device="cuda")
    torch.cuda.synchronize()
    tracing.reset()
    acts = [CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts):
        with tracing.span("mm"):
            for _ in range(4):
                a = a @ a / 2048
    rep = tracing.report()
    assert rep["mm"]["calls"] == 1 and rep["mm"]["device_s"] > 0


def test_a_device_counter_joins_its_name_at_report():
    """A device counter is made once per (name, device) and kept; what
    it gained since the last report joins its name's calls there, once;
    `reset` forgets it."""
    tracing.reset()
    c = tracing.device_counter("kernel.rows", "cpu")
    assert tracing.device_counter("kernel.rows", torch.device("cpu")) is c
    assert int(c) == 0 and c.dtype == torch.int64
    assert "kernel.rows" not in tracing.report()
    c += 5
    tracing.count("kernel.rows", 1)
    assert tracing.report()["kernel.rows"]["calls"] == 6
    assert tracing.report()["kernel.rows"]["calls"] == 6
    c += 2
    assert tracing.report()["kernel.rows"]["calls"] == 8
    tracing.reset()
    assert tracing.report() == {}
    assert int(tracing.device_counter("kernel.rows", "cpu")) == 0
    tracing.reset()


def test_sum_backward_counters_only_while_recording():
    """`sum_t.entries` and `sum_t.merged_rows` (beside `max_bwd.*`) are
    counted only while a profiler records: a packed sum backward over CPU
    groups counts its real entries and, from its source table, the dX
    rows the card's split pieces add (each split piece's columns with an
    entry); with no profiler it counts nothing."""
    g = _graph()
    store = pack_tile_store(build_tile_store(
        COOGraph(g.num_vertices, g.src, g.dst, np.ones(g.num_edges,
                                                       np.float32)), 64))
    groups = upload_groups(gather_ops.prepare_packed_groups(store), "cpu",
                           source=True)
    src = groups.source
    ptr, tiles = src.ptr.numpy(), src.tiles.numpy()
    want = 0
    for _, lo, hi, split, _, _ in src.pieces.tolist():
        cols = set()
        for e in range(lo, hi):
            j = int(np.searchsorted(ptr, e, "right")) - 1
            gi, k, _ = tiles[j]
            cols.add(int(groups[gi]["cols"][k, e - ptr[j]]))
        want += len(cols) if split else 0
    assert 0 < want < store.nnz
    gy = torch.ones(store.padded_vertices, 3)
    tracing.reset()
    gather_bwd_ops.packed_groups_t(groups, gy, q=store.q)
    assert tracing.report() == {}
    with torch.profiler.profile(activities=[CPU]):
        gather_bwd_ops.packed_groups_t(groups, gy, q=store.q)
        gather_bwd_ops.packed_groups_t(list(groups), gy, q=store.q)
    rep = tracing.report()
    assert rep["sum_t.entries"]["calls"] == 2 * store.nnz
    assert rep["sum_t.merged_rows"]["calls"] == 2 * want
    tracing.reset()
