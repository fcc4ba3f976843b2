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
import _torch_cpu  # noqa: F401  (this worker's share of the cores)
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
from repro_torch.kernels import rer_gather, rer_gather_bwd
from repro_torch.kernels.rer_gather_bwd import ops as bwd_ops

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


# -- the max backward's three passes: winner words, resolve, tie walk ------

HUB = 70_000            # the hub row's in-edges, above 2^16


def _three_pass_store(seed=0, tile=256, scale=1):
    """The packed tile store of `_three_pass_case`'s graph."""
    rng = np.random.default_rng(seed)
    n = HUB + 16
    bg = rmat_graph(600, 1500, seed=seed)
    src = np.concatenate([bg.src, np.arange(1, HUB + 1)]).astype(np.int32)
    dst = np.concatenate([bg.dst, np.zeros(HUB, np.int32)]).astype(np.int32)
    key = dst.astype(np.int64) * n + src
    _, first = np.unique(key, return_index=True)
    src, dst = src[first], dst[first]
    val = np.where(dst == 0, 1, rng.integers(1, 3, src.size)) * scale
    g = COOGraph(n, src, dst, val.astype(np.float32))
    return pack_tile_store(build_tile_store(g, tile))


def _three_pass_case(f, seed=0, tile=256, scale=1):
    """A max plan with every case the three passes meet: background
    R-MAT edges of weight 1 or 2 among the first 600 vertices (lone
    winners of weight 2), a hub row 0 fed by every vertex 1..HUB, split
    across bucket groups (its first tiles also hold background edges)
    and segments; x ReLU'd from one-decimal normals, and its feature 0
    all 0 (a dead unit: every entry of a row ties there).  Every weight
    times `scale`.  Returns (groups, q, the flat (src, dst, val)
    entries, x, y)."""
    ps = _three_pass_store(seed, tile, scale)
    groups = t_engn.upload_groups(rer_gather.prepare_packed_groups(ps),
                                  "cpu")
    x = torch.relu(_feat(ps.padded_vertices, f, seed + 1))
    x[:, 0] = 0.0
    y = rer_gather.packed_groups_plain(groups, x, q=ps.q, op="max")
    flat = [torch.from_numpy(a) for a in rer_gather.flat_entries(ps)]
    return groups, ps.q, flat, x, y


def _words_by_entry(flat, x, y):
    """The words from the flat entries, one (row, feature) at a time."""
    gsrc, gdst, gval = (a.numpy() for a in flat)
    xs, ys = x.numpy(), y.numpy()
    win = (gval != 0)[:, None] & (gval[:, None] * xs[gsrc] == ys[gdst])
    words = np.zeros(xs.shape, np.int64)
    np.add.at(words, gdst, win)
    e, f = np.nonzero(win)
    unit = (words[gdst[e], f] == 1) & (gval[e] == 1)
    words[gdst[e[unit]], f[unit]] = -(gsrc[e[unit]].astype(np.int64) + 1)
    return words


def _dyadic_g(cnt, seed):
    """A cotangent whose every share g / count is a multiple of 1/16, so
    dX sums exactly in any order; a quarter of the rows are 0, the hub
    row's is not."""
    rng = np.random.default_rng(seed)
    k = rng.integers(-4, 5, cnt.shape)
    k[rng.random(cnt.shape[0]) < 0.25] = 0
    k[0] = 1
    g = np.maximum(cnt.numpy(), 1) * k / 16.0
    return torch.from_numpy(g.astype(np.float32))


@pytest.mark.parametrize("f", [3, 41])
def test_max_words_name_the_lone_winners_and_count_the_rest(f):
    """The plain words hold, per (row, feature), -(s+1) for one winner
    of weight 1, else the count, which decodes to the plain count: ties
    at 0, lone winners of weight 2 (word 1) and the hub's count above
    2^16 among them."""
    groups, q, flat, x, y = _three_pass_case(f)
    words = rer_gather_bwd.packed_max_words_plain(groups, x, y, q=q)
    cnt = rer_gather_bwd.packed_max_count_plain(groups, x, y, q=q)
    np.testing.assert_array_equal(words.numpy(), _words_by_entry(flat, x, y))
    assert torch.equal(torch.where(words < 0, 1, words), cnt)
    gsrc, gdst, gval = flat
    hub = int((gdst == 0).sum())
    assert hub >= HUB > 2 ** 16
    assert int(words[0, 0]) == hub                   # the dead unit's ties
    assert int((words < 0).sum()) > 0 and int((words > 1).sum()) > 0
    heavy = torch.unique(gdst[gval == 2.0]).long()
    assert bool((words[heavy] == 1).any())           # lone, weight 2
    in_groups = sum(bool(((gr["block_row"] == 0)[:, None]
                          & (gr["rows"] == 0) & (gr["vals"] != 0)).any())
                    for gr in groups)
    assert in_groups > 1                             # the hub row, split


@pytest.mark.parametrize("f", [3, 41])
def test_three_pass_backward_equals_the_two_pass_bit_for_bit(f):
    """The plain words, resolve pass and tie walk give the two-pass
    plain dX (count, then scatter over every entry) bit for bit; only
    rows with a tie or a lone winner of weight 2 under a nonzero g are
    flagged, so rows whose g is 0 are not."""
    groups, q, flat, x, y = _three_pass_case(f, seed=f)
    words = rer_gather_bwd.packed_max_words_plain(groups, x, y, q=q)
    cnt = torch.where(words < 0, 1, words)
    g = _dyadic_g(cnt, seed=f + 1)
    want = rer_gather_bwd.packed_max_scatter_plain(groups, x, y, g, cnt,
                                                   q=q)
    dx, flag = bwd_ops.packed_max_resolve_plain(words, g)
    assert torch.equal(flag.bool(), ((words > 0) & (g != 0)).any(dim=1))
    assert bool(flag[0])                             # the hub's ties
    assert not bool(flag[(g == 0).all(dim=1)].any())
    assert 0 < int(flag.sum()) < int((cnt > 0).any(dim=1).sum())
    got = bwd_ops.packed_max_walk_plain(groups, x, y, g, words, flag, dx,
                                        q=q)
    assert torch.equal(got, want)


def test_the_max_backward_counts_its_rows_while_traced():
    """`max_bwd.rows` and `max_bwd.walk_rows` are counted only while a
    profiler records: the rows of the call and the rows it flagged."""
    groups, q, _, x, y = _three_pass_case(3, seed=4)
    g = _dyadic_g(rer_gather_bwd.packed_max_count_plain(groups, x, y, q=q),
                  seed=5)
    _, flag = rer_gather_bwd.packed_max_backward_plain(groups, x, y, g, q=q)
    tracing.reset()
    rer_gather_bwd.packed_max_backward(groups, x, y, g, q=q)
    assert "max_bwd.rows" not in tracing.report()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        rer_gather_bwd.packed_max_backward(groups, x, y, g, q=q)
        rer_gather_bwd.packed_max_backward(groups, x, y, g, q=q)
    rep = tracing.report()
    assert rep["max_bwd.rows"]["calls"] == 2 * x.shape[0]
    assert rep["max_bwd.walk_rows"]["calls"] == 2 * int(flag.sum())


def test_a_plan_with_no_weight_of_one_takes_the_two_passes():
    """Where no entry has weight 1 no word can name a winner: the words
    are the counts, the resolve pass flags every row with a count and a
    nonzero g, and the three passes give the two-pass oracle's dX (count,
    then scatter over every row) bit for bit; a traced call counts the
    flagged rows as walked."""
    groups, q, _, x, y = _three_pass_case(3, seed=6, scale=3)
    assert not any(bool((gr["vals"] == 1.0).any()) for gr in groups)
    cnt = rer_gather_bwd.packed_max_count_plain(groups, x, y, q=q)
    assert torch.equal(rer_gather_bwd.packed_max_words_plain(groups, x, y,
                                                             q=q), cnt)
    g = _dyadic_g(cnt, seed=7)
    dx, flag = rer_gather_bwd.packed_max_backward_plain(groups, x, y, g,
                                                        q=q)
    assert torch.equal(flag.bool(), ((cnt > 0) & (g != 0)).any(dim=1))
    assert 0 < int(flag.sum()) < x.shape[0]
    assert torch.equal(dx, rer_gather_bwd.packed_max_scatter_plain(
        groups, x, y, g, cnt, q=q))
    tracing.reset()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        rer_gather_bwd.packed_max_backward(groups, x, y, g, q=q)
    rep = tracing.report()
    assert rep["max_bwd.rows"]["calls"] == x.shape[0]
    assert rep["max_bwd.walk_rows"]["calls"] == int(flag.sum())


@pytest.mark.cuda
@pytest.mark.parametrize("f", [3, 41, 300])
def test_three_pass_max_backward_on_card(f):
    """The card's words equal the plain ones, exactly, the hub's 70,000
    ties merged across ~1,100 segments and two bucket groups among them;
    its dX equals the plain dX bit for bit (every share a multiple of
    1/16, so the atomics' order does not show); one launch each of the
    count, the resolve pass and the walk; a traced call counts its rows
    and flagged rows."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    dev = torch.device("cuda")
    groups, q, _, x, y = _three_pass_case(f, seed=f)
    cnt = rer_gather_bwd.packed_max_count_plain(groups, x, y, q=q)
    g = _dyadic_g(cnt, seed=f + 1)
    want, flag = rer_gather_bwd.packed_max_backward_plain(groups, x, y, g,
                                                          q=q)
    words = rer_gather_bwd.packed_max_words_plain(groups, x, y, q=q)
    dg = [{k: v.to(dev) for k, v in gr.items()} for gr in groups]
    xd, yd, gd = x.to(dev), y.to(dev), g.to(dev)
    before = dict(bwd_ops.LAUNCHES)
    got_words = rer_gather_bwd.packed_max_words(dg, xd, yd, q=q)
    got = rer_gather_bwd.packed_max_backward(dg, xd, yd, gd, q=q)
    torch.cuda.synchronize()
    assert bwd_ops.LAUNCHES == {
        "count": before["count"] + 2, "resolve": before["resolve"] + 1,
        "max": before["max"] + 1}
    assert torch.equal(got_words.cpu(), words)
    assert torch.equal(got.cpu(), want)
    tracing.reset()
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]):
        rer_gather_bwd.packed_max_backward(dg, xd, yd, gd, q=q)
    rep = tracing.report()
    assert rep["max_bwd.rows"]["calls"] == x.shape[0]
    assert rep["max_bwd.walk_rows"]["calls"] == int(flag.sum())


@pytest.mark.cuda
@pytest.mark.parametrize("f", [3, 300])
def test_two_pass_max_backward_on_card_where_no_weight_is_one(f):
    """With no weight 1 in a plan's groups the card runs the same three
    passes: its words equal the plain counts, its flags the rows with a
    count and a nonzero g, and its dX the two-pass oracle's (count, then
    scatter over every row) bit for bit; one launch each of the count
    (with the words' call, two), the resolve pass and the walk; a traced
    call counts the flagged rows as walked."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    dev = torch.device("cuda")
    groups, q, _, x, y = _three_pass_case(f, seed=f, scale=3)
    cnt = rer_gather_bwd.packed_max_count_plain(groups, x, y, q=q)
    g = _dyadic_g(cnt, seed=f + 2)
    want = rer_gather_bwd.packed_max_scatter_plain(groups, x, y, g, cnt,
                                                   q=q)
    dg = t_engn.upload_groups(rer_gather.prepare_packed_groups(
        _three_pass_store(seed=f, scale=3)), dev)
    assert not any(bool((gr["vals"] == 1.0).any()) for gr in dg)
    xd, yd, gd = x.to(dev), y.to(dev), g.to(dev)
    before = dict(bwd_ops.LAUNCHES)
    got_words = rer_gather_bwd.packed_max_words(dg, xd, yd, q=q)
    got = rer_gather_bwd.packed_max_backward(dg, xd, yd, gd, q=q)
    torch.cuda.synchronize()
    assert bwd_ops.LAUNCHES == {
        "count": before["count"] + 2, "resolve": before["resolve"] + 1,
        "max": before["max"] + 1}
    _, flag = rer_gather_bwd.packed_max_resolve(got_words, gd)
    assert torch.equal(got_words.cpu(), cnt)
    assert torch.equal(flag.cpu().bool(), ((cnt > 0) & (g != 0)).any(dim=1))
    assert torch.equal(got.cpu(), want)
    tracing.reset()
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]):
        rer_gather_bwd.packed_max_backward(dg, xd, yd, gd, q=q)
    rep = tracing.report()
    assert rep["max_bwd.rows"]["calls"] == x.shape[0]
    assert rep["max_bwd.walk_rows"]["calls"] == int(flag.sum())
