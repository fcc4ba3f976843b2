"""Max plans over neighbour sets, on the CPU.

The tile carriers merge repeated (src, dst) edges into one entry by
summing their weights, which a max must not see: a max plan holds the
graph's distinct edges (`graphs/partition.py::distinct_edges`, the
`plan.distinct` stage of `prepare_graph`, `prepare_tiled` and
`prepare_ring`), so that on a multigraph every route's max equals
`segment`'s, exactly.  Sum and mean plans keep the repeats.  Also: the
upload helpers take a device named by a string (ROADMAP C5), and the
packed aggregate's backward runs in the `engn.aggregate_bwd` span.
"""
import numpy as np
import pytest
import torch

import repro_torch as rt
from repro_torch import tracing
from repro_torch.core import engn as t_engn
from repro_torch.graphs.degree import (apply_vertex_permutation,
                                       degree_sort_permutation)
from repro_torch.graphs.format import COOGraph
from repro_torch.graphs.generate import make_dataset, rmat_graph
from repro_torch.graphs.partition import (build_tile_store, distinct_edges,
                                          pack_tile_store)
from repro_torch.kernels import rer_gather

# (model, backend, tile format): every route that builds tile carriers
ROUTES = [("gs_pool", "blocked", "dense"), ("gs_pool", "blocked", "packed"),
          ("gs_pool", "fused", "auto"), ("gs_pool", "tiled", "packed"),
          ("gs_pool", "ring", "auto"), ("gcn", "blocked", "dense"),
          ("gcn", "blocked", "packed"), ("gcn", "fused", "auto")]


def _multigraph(weighted: bool, n=120):
    """The 120-vertex cora stand-in, degree-relabelled: 467 edges, of
    which 365 distinct; GCN-normalised (one weight per pair) or
    unweighted."""
    g, _, _ = make_dataset("cora", seed=0, max_vertices=n, feature_dim=8)
    g = apply_vertex_permutation(g, degree_sort_permutation(g))
    return g.gcn_normalized() if weighted else g


def _distinct_count(g: COOGraph) -> int:
    return np.unique(g.dst.astype(np.int64) * g.num_vertices + g.src).size


def _layer(model, backend, fmt, f, h):
    layer, = rt.make_gnn_stack(model, [f, h], backend=backend, tile=16,
                               device="cpu", seed=3)
    layer.cfg.aggregate_op = "max"
    layer.cfg.tile_format = fmt
    layer.cfg.ring_shards = 2
    return layer


def _feat(n, f, seed):
    # a few exact ties, and values of both signs
    rng = np.random.default_rng(seed)
    return torch.from_numpy(np.round(rng.standard_normal((n, f)), 1)
                            .astype(np.float32))


def test_distinct_edges_keeps_each_pair_once_in_key_order():
    g = COOGraph(5, np.array([0, 1, 0, 2, 1, 0], np.int32),
                 np.array([3, 3, 3, 4, 3, 3], np.int32),
                 np.array([.5, 2., .5, 1., 2., .5], np.float32))
    out, dropped = distinct_edges(g)
    assert dropped == 3
    assert out.src.tolist() == [0, 1, 2] and out.dst.tolist() == [3, 3, 4]
    assert out.val.tolist() == [.5, 2., 1.]
    # a typed graph keys the relation too; a graph without repeats is
    # returned as it is
    typed = COOGraph(5, g.src, g.dst, None,
                     np.array([0, 0, 1, 0, 0, 0], np.int32), 2)
    out, dropped = distinct_edges(typed)
    assert dropped == 2 and out.rel.tolist() == [0, 1, 0, 0]
    assert out.src.tolist() == [0, 0, 1, 2] and out.val is None
    same, dropped = distinct_edges(out)
    assert same is out and dropped == 0


def test_repeats_of_another_weight_raise_and_name_their_count():
    g = COOGraph(4, np.array([0, 0, 0, 1, 1], np.int32),
                 np.array([2, 2, 2, 3, 3], np.int32),
                 np.array([1., 1., 3., 2., 5.], np.float32))
    with pytest.raises(ValueError, match=r"^2 repeated"):
        distinct_edges(g)
    layer = _layer("gcn", "blocked", "packed", 4, 4)
    with pytest.raises(ValueError, match=r"^2 repeated"):
        rt.prepare_graph(g, layer.cfg, device="cpu")
    layer.cfg.aggregate_op = "sum"        # a sum merges them, as before
    rt.prepare_graph(g, layer.cfg, device="cpu")


@pytest.mark.parametrize("model,backend,fmt", ROUTES)
def test_max_plan_equals_segment_on_a_multigraph(model, backend, fmt):
    """The aggregate over the plan's carriers equals `segment`'s over the
    drawn edges exactly, and so does the layer; summed repeats would
    not."""
    g = _multigraph(weighted=model == "gcn")
    n, f, h = g.num_vertices, 8, 6
    assert _distinct_count(g) < g.num_edges
    layer = _layer(model, backend, fmt, f, h)
    ref = _layer(model, "segment", "auto", f, h)
    seg_plan = rt.prepare_graph(g, ref.cfg, device="cpu")
    plan = rt.prepare_graph(g, layer.cfg, device="cpu")
    assert plan.backend == backend
    feat = torch.relu(_feat(n, h, 1))
    want = ref._aggregate(seg_plan, feat)
    # what a carrier of summed repeats gives differs on this graph
    merged = COOGraph(n, *_merged(g))
    summed = ref._aggregate(rt.prepare_graph(merged, ref.cfg, device="cpu"),
                            feat)
    assert not torch.equal(summed, want)
    x = _feat(n, f, 2)
    with torch.no_grad():
        y_ref = ref(seg_plan, x)
        if backend not in ("tiled", "ring"):
            assert torch.equal(layer._aggregate(plan, feat), want)
        y = layer(plan, x)
    torch.testing.assert_close(y, y_ref, rtol=1e-6, atol=1e-6)


def _merged(g: COOGraph):
    """(src, dst, val): each pair once, with its repeats' weights
    summed, as the tile carriers merge them."""
    key = g.dst.astype(np.int64) * g.num_vertices + g.src
    ku, inv = np.unique(key, return_inverse=True)
    val = np.zeros(ku.size, np.float64)
    np.add.at(val, inv, g.weights())
    n = g.num_vertices
    return ((ku % n).astype(np.int32), (ku // n).astype(np.int32),
            val.astype(np.float32))


@pytest.mark.parametrize("op", ["sum", "mean"])
def test_sum_and_mean_plans_keep_the_repeats(op):
    g = _multigraph(weighted=False)
    layer = _layer("gcn", "blocked", "packed", 8, 6)
    layer.cfg.aggregate_op = op
    tracing.reset()
    plan = rt.prepare_graph(g, layer.cfg, device="cpu")
    assert "plan.distinct" not in tracing.report()
    _, _, gval = plan.carrier["packed_flat"]
    want = pack_tile_store(build_tile_store(g, 16)).val
    np.testing.assert_array_equal(gval.numpy(), want)
    assert gval.max() > 1.0               # the repeats, summed


def test_the_dropped_repeats_are_counted():
    g = rmat_graph(300, 4000, seed=5)
    dropped = g.num_edges - _distinct_count(g)
    assert dropped > 0
    layer = _layer("gs_pool", "blocked", "packed", 8, 6)
    tracing.reset()
    plan = rt.prepare_graph(g, layer.cfg, device="cpu")
    rep = tracing.report()
    assert rep["plan.distinct_dropped"]["calls"] == dropped
    assert rep["plan.distinct"]["calls"] == 1
    assert plan.carrier["packed_flat"][0].numel() == _distinct_count(g)
    assert float(plan.carrier["packed_flat"][2].max()) == 1.0


def test_upload_helpers_take_a_device_named_by_a_string():
    """ROADMAP C5: `upload_groups` and `_upload` read the device's type
    from a string as from a `torch.device`."""
    a = np.arange(6, dtype=np.int32)
    assert torch.equal(t_engn._upload(a, "cpu"), torch.from_numpy(a))
    ps = pack_tile_store(build_tile_store(rmat_graph(40, 200, seed=1), 16))
    groups = t_engn.upload_groups(rer_gather.prepare_packed_groups(ps),
                                  "cpu")
    assert len(groups) > 0 and groups.work is not None
    assert all(gr["rows"].device.type == "cpu" for gr in groups)


@pytest.mark.parametrize("op", ["sum", "max"])
def test_the_packed_backward_runs_in_its_span(op):
    """A traced CPU step through a plan's bucket groups: the aggregate's
    backward is one `engn.aggregate_bwd` span (no device time on the
    CPU)."""
    ps = pack_tile_store(build_tile_store(rmat_graph(40, 200, seed=2), 16))
    groups = t_engn.upload_groups(rer_gather.prepare_packed_groups(ps),
                                  "cpu")
    x = _feat(ps.padded_vertices, 5, 3).requires_grad_(True)
    tracing.reset()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        y = rer_gather.packed_groups_spmm(groups, x, q=ps.q, op=op)
        y.sum().backward()
    rep = tracing.report()
    assert rep["engn.aggregate_bwd"]["calls"] == 1
    assert rep["engn.aggregate_bwd"]["device_s"] is None
    assert x.grad is not None and x.grad.abs().sum() > 0
