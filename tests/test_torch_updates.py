"""Dynamic graphs on the port (`graphs/updates.py`,
`TiledExecutor.apply_updates`, `engn.update_plan`, the serving engine's
and pipeline's `apply_updates`) against the reference, on the CPU.

The log and the store merges are numpy copies of the reference's: every
snapshot (the epoch graph, its touched sets and its delta) and every
merged `EdgeTileStore` / `PackedTileStore` is exactly the reference's and
bitwise equal to a fresh build of the epoch graph.  On integer graphs
(small-integer weights and features: fp32 sums are exact in any order)
a merged executor's or plan's aggregate is exactly a fresh one's and
the reference's, and `TiledStats` equal the reference's field for field;
responses of the serving engine agree within rtol=1e-4, atol=1e-5.  The
`cuda`-marked tests run on a card only and skip here.
"""
import _torch_cpu  # noqa: F401  (this worker's share of the cores)
import dataclasses

import numpy as np
import pytest
import torch

import jax

try:
    from hypothesis import given, settings, strategies as st
except ImportError:                     # clean checkout: vendored fallback
    from _hypothesis_fallback import given, settings, st

from repro.core import engn as j_engn
from repro.core import models as j_models
from repro.core import tiled as j_tiled
from repro.graphs import format as j_format
from repro.graphs import generate as j_generate
from repro.graphs import partition as j_part
from repro.graphs import updates as j_updates
from repro.serving import engine as j_engine
import repro_torch as rt
from repro_torch import kernels as K
from repro_torch.core import engn as t_engn
from repro_torch.core import tiled as t_tiled
from repro_torch.graphs import partition as t_part
from repro_torch.graphs import updates as t_updates
from repro_torch.graphs.format import COOGraph
from repro_torch.graphs.updates import (UpdateLog, update_packed_store,
                                        update_tile_store)
from repro_torch.interop import load_reference_params
from repro_torch.kernels.chunk_queue import ops as t_queue
from repro_torch.serving import (DegreeAwareCache, GNNServingEngine,
                                 ServingConfig, ServingPipeline)

RTOL, ATOL = 1e-4, 1e-5


# -- fixtures --------------------------------------------------------------

def _int_graph(n, e, seed, relations=1):
    """Deduplicated integer-weighted graph (optionally relation-typed),
    as the port's `COOGraph`."""
    g = j_generate.rmat_graph(n, e, seed=seed)
    uniq = np.unique(np.stack([g.src, g.dst]), axis=1)
    rng = np.random.default_rng(seed)
    val = rng.integers(1, 4, uniq.shape[1]).astype(np.float32)
    rel = (rng.integers(0, relations, uniq.shape[1]).astype(np.int32)
           if relations > 1 else None)
    return COOGraph(n, uniq[0].astype(np.int32), uniq[1].astype(np.int32),
                    val, rel, relations)


def _ref(g):
    """The same graph as the reference's `COOGraph`."""
    return j_format.COOGraph(g.num_vertices, g.src, g.dst, g.val, g.rel,
                             g.num_relations)


def _int_features(n, f, seed):
    rng = np.random.default_rng(seed + 17)
    return rng.integers(-3, 4, (n, f)).astype(np.float32)


def _random_epoch(log, seed, n_del, n_ins, grow=0):
    """Delete n_del random existing edges, insert n_ins random ones
    (into [0, n + grow)), snapshot.  Typed logs draw relation ids, and
    delete with a wildcard relation on odd seeds."""
    rng = np.random.default_rng(seed)
    g = log.graph
    r = g.num_relations
    if n_del and g.num_edges:
        pick = rng.choice(g.num_edges, min(n_del, g.num_edges),
                          replace=False)
        rel = g.rel[pick] if (r > 1 and g.rel is not None
                              and seed % 2 == 0) else None
        log.delete(g.src[pick], g.dst[pick], rel)
    if n_ins:
        hi = g.num_vertices + grow
        log.insert(rng.integers(0, hi, n_ins),
                   rng.integers(0, hi, n_ins),
                   rng.integers(1, 4, n_ins).astype(np.float32),
                   rng.integers(0, r, n_ins) if r > 1 else None)
    return log.snapshot()


def _twin_logs(g):
    """A port log and a reference log over the same base graph."""
    return UpdateLog(g), j_updates.UpdateLog(_ref(g))


def _assert_arrays_eq(a, b, name):
    if b is None:
        assert a is None, name
        return
    assert a is not None, name
    assert a.dtype == b.dtype, (name, a.dtype, b.dtype)
    assert np.array_equal(a, b), name


def _assert_store_eq(a, b):
    """Field-by-field bitwise equality of two tile stores (either
    package's)."""
    assert type(a).__name__ == type(b).__name__
    for f in dataclasses.fields(b):
        va, vb = getattr(a, f.name), getattr(b, f.name)
        if isinstance(va, np.ndarray) or isinstance(vb, np.ndarray):
            _assert_arrays_eq(va, vb, f.name)
        else:
            assert va == vb, f.name


def _assert_snapshot_eq(got, want):
    assert got.epoch == want.epoch
    for f in ("num_vertices", "num_relations"):
        assert getattr(got.graph, f) == getattr(want.graph, f), f
    for f in ("src", "dst", "val", "rel"):
        _assert_arrays_eq(getattr(got.graph, f), getattr(want.graph, f), f)
    _assert_arrays_eq(got.touched_dst, want.touched_dst, "touched_dst")
    _assert_arrays_eq(got.touched_src, want.touched_src, "touched_src")
    for f in dataclasses.fields(want.batch):
        _assert_arrays_eq(getattr(got.batch, f.name),
                          getattr(want.batch, f.name), f.name)
    assert got.batch.num_deleted == want.batch.num_deleted
    assert got.batch.num_inserted == want.batch.num_inserted


def _stats(stats):
    return dataclasses.asdict(stats)


# -- the log ---------------------------------------------------------------

def test_log_delete_cancels_earlier_insert():
    log = UpdateLog(_int_graph(8, 10, 0))
    log.insert(1, 2, 2.0)
    log.delete(1, 2)
    log.insert(1, 2, 3.0)
    snap = log.snapshot()
    m = (snap.graph.src == 1) & (snap.graph.dst == 2)
    assert m.sum() == 1 and snap.graph.weights()[m][0] == 3.0
    assert log.epoch == 1 and log.pending == 0


def test_log_multi_edge_delete_and_touched_sets():
    g = COOGraph(5, np.array([0, 0, 3], np.int32),
                 np.array([1, 1, 2], np.int32),
                 np.array([1.0, 2.0, 3.0], np.float32))
    log = UpdateLog(g)
    log.delete(0, 1)
    snap = log.snapshot()
    assert snap.batch.num_deleted == 2
    assert snap.batch.del_src.shape == (1,)
    assert snap.graph.num_edges == 1
    assert snap.touched_dst.tolist() == [1]
    assert snap.touched_src.tolist() == [0]


def test_log_vertex_growth_and_validation():
    log = UpdateLog(_int_graph(8, 10, 1))
    log.insert(7, 12)
    assert log.snapshot().graph.num_vertices == 13
    with pytest.raises(ValueError, match="negative"):
        log.insert(-1, 0)
    tlog = UpdateLog(_int_graph(8, 10, 1, relations=3))
    with pytest.raises(ValueError, match="out of range"):
        tlog.insert(0, 1, rel=3)


def test_log_wildcard_delete_kills_all_relations():
    g = COOGraph(4, np.array([0, 0, 1], np.int32),
                 np.array([2, 2, 3], np.int32), np.ones(3, np.float32),
                 np.array([0, 2, 1], np.int32), 3)
    log = UpdateLog(g)
    log.delete(0, 2)
    snap = log.snapshot()
    assert snap.graph.num_edges == 1 and snap.graph.rel.tolist() == [1]


def _ops_inserts(log, rng, g):
    log.insert(rng.integers(0, g.num_vertices, 30),
               rng.integers(0, g.num_vertices, 30),
               rng.integers(1, 4, 30).astype(np.float32))


def _ops_deletes(log, rng, g):
    pick = rng.choice(g.num_edges, 25, replace=False)
    log.delete(g.src[pick], g.dst[pick])
    log.delete(np.array([0, 1]), np.array([5, 9]))       # maybe absent


def _ops_cancel(log, rng, g):
    log.insert([3, 4, 3], [5, 5, 5], [2.0, 1.0, 3.0])
    log.delete(3, 5)
    log.insert(3, 5, 1.0)
    log.delete(g.src[:4], g.dst[:4])


def _ops_growth(log, rng, g):
    log.insert(rng.integers(0, g.num_vertices + 20, 25),
               rng.integers(g.num_vertices, g.num_vertices + 20, 25))
    log.delete(g.src[-3:], g.dst[-3:])


def _ops_typed(log, rng, g):
    log.insert(rng.integers(0, g.num_vertices, 20),
               rng.integers(0, g.num_vertices, 20), None,
               rng.integers(0, g.num_relations, 20))
    log.delete(g.src[:6], g.dst[:6], g.rel[:6])           # one relation
    log.delete(g.src[6:12], g.dst[6:12])                  # wildcard
    log.insert(g.src[6:8], g.dst[6:8], 2.0, 1)


@pytest.mark.parametrize("ops,relations", [
    (_ops_inserts, 1), (_ops_deletes, 1), (_ops_cancel, 1),
    (_ops_growth, 1), (_ops_typed, 3), (_ops_growth, 3)],
    ids=["inserts", "deletes", "cancel", "growth", "typed_wildcard",
         "typed_growth"])
def test_snapshot_equals_reference(ops, relations):
    """Two epochs of the same ops through both logs: each snapshot's
    epoch graph, delta and touched sets are the reference's, array for
    array."""
    g = _int_graph(80, 500, 4, relations=relations)
    tlog, jlog = _twin_logs(g)
    for ep in range(2):
        for log in (tlog, jlog):
            ops(log, np.random.default_rng(10 + ep), log.graph)
        _assert_snapshot_eq(tlog.snapshot(), jlog.snapshot())
        assert tlog.pending == jlog.pending == 0


# -- the store merges --------------------------------------------------------

def _merged_stores(mod, store, packed, snap):
    new_store, delta = mod.update_tile_store(store, snap.batch,
                                             snap.graph.num_vertices)
    return new_store, mod.update_packed_store(packed, new_store, delta), \
        delta


@settings(max_examples=12, deadline=None)
@given(n=st.integers(6, 120), e=st.integers(2, 500),
       seed=st.integers(0, 5), tile=st.integers(4, 33),
       relations=st.sampled_from([1, 1, 3]),
       grow=st.sampled_from([0, 0, 9]))
def test_property_store_merge_matches_rebuild_and_reference(
        n, e, seed, tile, relations, grow):
    """Two epochs of random deletes and inserts (sometimes growing the
    vertex set past a grid boundary, sometimes typed): the merged stores
    and the `StoreDelta` equal the reference's, and the stores equal a
    fresh build and pack of the epoch graph, field for field."""
    g = _int_graph(n, e, seed, relations=relations)
    tlog, jlog = _twin_logs(g)
    ts = t_part.build_tile_store(g, tile)
    tp = t_part.pack_tile_store(ts)
    js = j_part.build_tile_store(_ref(g), tile)
    jp = j_part.pack_tile_store(js)
    for ep in range(2):
        tsnap = _random_epoch(tlog, seed + 11 * ep, n_del=e // 6 + 1,
                              n_ins=e // 4 + 1, grow=grow)
        jsnap = _random_epoch(jlog, seed + 11 * ep, n_del=e // 6 + 1,
                              n_ins=e // 4 + 1, grow=grow)
        ts, tp, tdelta = _merged_stores(t_updates, ts, tp, tsnap)
        js, jp, jdelta = _merged_stores(j_updates, js, jp, jsnap)
        _assert_store_eq(ts, js)
        _assert_store_eq(tp, jp)
        for f in dataclasses.fields(jdelta):
            a, b = getattr(tdelta, f.name), getattr(jdelta, f.name)
            if isinstance(b, np.ndarray):
                _assert_arrays_eq(a, b, f.name)
            else:
                assert a == b, f.name
        fresh = t_part.build_tile_store(tsnap.graph, tile)
        _assert_store_eq(ts, fresh)
        _assert_store_eq(tp, t_part.pack_tile_store(fresh))


def test_delete_to_empty_tiles_compact_away():
    g = COOGraph(64, np.array([0, 1, 60, 61], np.int32),
                 np.array([1, 0, 61, 60], np.int32), np.ones(4, np.float32))
    store = t_part.build_tile_store(g, 8)
    packed = t_part.pack_tile_store(store)
    log = UpdateLog(g)
    log.delete(np.array([60, 61]), np.array([61, 60]))
    snap = log.snapshot()
    new_store, delta = update_tile_store(store, snap.batch, 64)
    new_packed = update_packed_store(packed, new_store, delta)
    assert delta.tiles_dropped >= 1
    _assert_store_eq(new_store, t_part.build_tile_store(snap.graph, 8))
    _assert_store_eq(new_packed, t_part.pack_tile_store(
        t_part.build_tile_store(snap.graph, 8)))
    log.delete(np.array([0, 1]), np.array([1, 0]))
    snap2 = log.snapshot()
    empty, delta2 = update_tile_store(new_store, snap2.batch, 64)
    empty_packed = update_packed_store(new_packed, empty, delta2)
    assert empty.nnzb == 0 and empty_packed.val.size == 0
    _assert_store_eq(empty, t_part.build_tile_store(snap2.graph, 8))


def test_untouched_tiles_copy_bitwise_from_old_packed():
    g = _int_graph(96, 400, 3)
    store = t_part.build_tile_store(g, 16)
    packed = t_part.pack_tile_store(store)
    log = UpdateLog(g)
    log.insert(0, 1, 2.0)                 # touches exactly one tile
    snap = log.snapshot()
    new_store, delta = update_tile_store(store, snap.batch, 96)
    assert delta.touched_tiles.size < new_store.nnzb
    _assert_store_eq(update_packed_store(packed, new_store, delta),
                     t_part.pack_tile_store(new_store))


# -- the executor --------------------------------------------------------------

@settings(max_examples=8, deadline=None)
@given(n=st.integers(8, 110), e=st.integers(2, 450),
       seed=st.integers(0, 4), tile=st.integers(5, 22),
       fmt=st.sampled_from(["dense", "packed"]),
       op=st.sampled_from(["sum", "max", "mean"]))
def test_property_executor_apply_updates_parity(n, e, seed, tile, fmt, op):
    """Two epochs through `apply_updates`: the returned deltas and the
    stats after the merges and after the next aggregate equal the
    reference executor's; the aggregate equals a fresh executor's and
    the reference's, bitwise; the store is never rebuilt."""
    g = _int_graph(n, e, seed)
    ex = t_tiled.TiledExecutor(g, tile=tile, chunk=3, tile_format=fmt,
                               device="cpu")
    jx = j_tiled.TiledExecutor(_ref(g), tile=tile, chunk=3, tile_format=fmt)
    tlog, jlog = _twin_logs(g)
    for ep in range(2):
        kw = dict(n_del=e // 5 + 1, n_ins=e // 3 + 1, grow=(5 if ep else 0))
        td = ex.apply_updates(_random_epoch(tlog, seed + 7 * ep, **kw))
        jd = jx.apply_updates(_random_epoch(jlog, seed + 7 * ep, **kw))
        _assert_arrays_eq(td.touched_tiles, jd.touched_tiles, "touched")
        _assert_arrays_eq(td.old_of_new, jd.old_of_new, "old_of_new")
        assert (td.edges_kept, td.edges_inserted, td.tiles_dropped) == (
            jd.edges_kept, jd.edges_inserted, jd.tiles_dropped)
    assert ex.stats.store_builds == 1 and ex.stats.delta_merges == 2
    assert _stats(ex.stats) == _stats(jx.stats)
    assert ex.format_choice.fmt == fmt
    x = _int_features(tlog.graph.num_vertices, 6, seed)
    fresh = t_tiled.TiledExecutor(tlog.graph, tile=tile, chunk=3,
                                  tile_format=fmt, device="cpu")
    got = ex.aggregate(x, op).numpy()
    assert np.array_equal(got, fresh.aggregate(x, op).numpy()), (fmt, op)
    assert np.array_equal(got, np.asarray(jx.aggregate(x, op)))
    assert _stats(ex.stats) == _stats(jx.stats)


@pytest.mark.parametrize("op", ["sum", "max"])
def test_merged_executor_on_real_weights_matches_fresh_and_reference(op):
    """Real-valued weights and features, a roomy budget: the sum takes
    the queue, the max the callback route (the card's route for a max),
    before and after a merge; both match a fresh executor and the
    reference's within the fp32 tolerance."""
    g0 = j_generate.rmat_graph(150, 1200, seed=2).gcn_normalized()
    g = COOGraph(150, g0.src, g0.dst, g0.val)
    kw = dict(tile=32, budget_bytes=10 ** 8, tile_format="packed",
              streaming_mode="auto" if op == "sum" else "callback")
    ex = t_tiled.TiledExecutor(g, device="cpu", **kw)
    jx = j_tiled.TiledExecutor(_ref(g), **kw)
    x = j_generate.random_features(150, 8, seed=3)
    ex.aggregate(x, op)
    jx.aggregate(x, op)
    tlog, jlog = _twin_logs(g)
    ex.apply_updates(_random_epoch(tlog, 3, 100, 150, grow=40))
    jx.apply_updates(_random_epoch(jlog, 3, 100, 150, grow=40))
    x = j_generate.random_features(tlog.graph.num_vertices, 8, seed=4)
    got = ex.aggregate(x, op).numpy()
    fresh = t_tiled.TiledExecutor(tlog.graph, device="cpu", **kw)
    np.testing.assert_allclose(got, fresh.aggregate(x, op).numpy(),
                               rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(got, np.asarray(jx.aggregate(x, op)),
                               rtol=RTOL, atol=ATOL)
    assert (ex.stats.queue_launches > 0) == (op == "sum")
    assert (ex.stats.steps > 0) == (op == "max")
    assert _stats(ex.stats) == _stats(jx.stats)


def test_apply_updates_drops_the_stale_tile_queue():
    """On the kernel route (impl="cuda", the kernels' plain versions on
    a CPU executor) the first sum builds the `TileQueue` with B5's
    row-sorted copy and B5^T's source table; after a merge every piece
    of derived state is gone, the next sum rebuilds the queue over the
    merged store and matches a fresh executor and `tile_queue_plain`."""
    g = _int_graph(120, 700, 5)
    kw = dict(tile=16, tile_format="packed", impl="cuda", device="cpu")
    ex = t_tiled.TiledExecutor(g, **kw)
    x0 = _int_features(120, 5, 0)
    ex.aggregate(x0, "sum")
    ex.aggregate(x0, "mean")
    ex.transposed()
    old_tq = ex._tq
    assert old_tq is not None and ex._queue_cache and ex._tq_price
    assert ex._counts_dev is not None and ex._transposed is not None
    log = UpdateLog(g)
    ex.apply_updates(_random_epoch(log, 6, 90, 160, grow=30))
    assert ex._tq is None and ex._tq_price is None
    assert not ex._queue_cache and not ex._queue_max_diff
    assert ex._counts_dev is None and ex._transposed is None
    assert not ex._diff_cache and not ex._xcache
    builds = ex.stats.queue_builds
    x = _int_features(log.graph.num_vertices, 5, 1)
    got = ex.aggregate(x, "sum").numpy()
    assert ex._tq is not None and ex._tq is not old_tq
    assert ex._tq.n == log.graph.num_vertices
    assert ex.stats.queue_builds == builds + 1
    fresh = t_tiled.TiledExecutor(log.graph, **kw)
    assert np.array_equal(got, fresh.aggregate(x, "sum").numpy())
    plain = t_queue.tile_queue_plain(ex._tq, torch.from_numpy(x)).numpy()
    assert np.array_equal(got, plain)
    np.testing.assert_array_equal(
        ex.aggregate(x, "mean").numpy(), fresh.aggregate(x, "mean").numpy())


def test_int8_executor_rebuilds_its_quantiser_for_the_new_store():
    """An int8 executor through a merge: the quantiser is rebuilt with
    one residual per entry of the merged packed store, and the next
    aggregates equal a fresh int8 executor's on the epoch graph (the
    same quantised values with fresh error feedback) and the
    reference's."""
    g = _int_graph(100, 600, 7)
    kw = dict(tile=16, tile_format="packed", value_dtype="int8",
              streaming_mode="callback")
    ex = t_tiled.TiledExecutor(g, device="cpu", **kw)
    jx = j_tiled.TiledExecutor(_ref(g), **kw)
    x = _int_features(100, 4, 2)
    ex.aggregate(x, "sum")
    jx.aggregate(x, "sum")
    tlog, jlog = _twin_logs(g)
    ex.apply_updates(_random_epoch(tlog, 8, 120, 250, grow=20))
    jx.apply_updates(_random_epoch(jlog, 8, 120, 250, grow=20))
    assert ex.quantizer.err.shape == (ex.packed.nnz,)
    assert not ex.quantizer.err.any()
    fresh = t_tiled.TiledExecutor(tlog.graph, device="cpu", **kw)
    x = _int_features(tlog.graph.num_vertices, 4, 3)
    for _ in range(2):
        got = ex.aggregate(x, "sum").numpy()
        assert np.array_equal(got, fresh.aggregate(x, "sum").numpy())
        np.testing.assert_allclose(got, np.asarray(jx.aggregate(x, "sum")),
                                   rtol=RTOL, atol=ATOL)
        assert np.array_equal(ex.quantizer.err, jx.quantizer.err)
    assert _stats(ex.stats) == _stats(jx.stats)


# -- update_plan ---------------------------------------------------------------

@pytest.mark.parametrize("backend,fmt", [
    ("segment", "dense"), ("fused", "dense"), ("blocked", "dense"),
    ("blocked", "packed"), ("tiled", "dense"), ("tiled", "packed")])
def test_update_plan_matches_fresh_prepare_and_reference(backend, fmt):
    """Across backends and formats the re-priced plan aggregates bitwise
    like a fresh `prepare_graph` of the epoch graph; a tiled plan merges
    in place (one store build, two merges) and its re-priced meta equals
    the fresh plan's and the reference's."""
    g = _int_graph(96, 420, 2)
    kw = dict(in_dim=6, out_dim=6, backend=backend, tile=16, tile_format=fmt)
    cfg = t_engn.EnGNConfig(**kw)
    jcfg = j_engn.EnGNConfig(**kw)
    plan = rt.prepare_graph(g, cfg, device="cpu")
    jplan = j_engn.prepare_graph(_ref(g), jcfg)
    tlog, jlog = _twin_logs(g)
    for ep in range(2):
        kw_ep = dict(n_del=60, n_ins=90, grow=(7 if ep else 0))
        plan = rt.update_plan(plan, _random_epoch(tlog, 31 + ep, **kw_ep),
                              cfg)
        jplan = j_engn.update_plan(
            jplan, _random_epoch(jlog, 31 + ep, **kw_ep), jcfg)
    assert plan.n == tlog.graph.num_vertices and plan.backend == backend
    assert plan.device == torch.device("cpu")
    x = _int_features(tlog.graph.num_vertices, 6, 2)
    fresh = rt.prepare_graph(tlog.graph, cfg, device="cpu")
    if backend == "tiled":
        st_ = plan.carrier["tiled_exec"].stats
        assert st_.store_builds == 1 and st_.delta_merges == 2
        for k in ("q", "host_bytes", "queue_plan", "resident_feature_bytes"):
            assert plan.meta[k] == fresh.meta[k] == jplan.meta[k], k
        got = plan.carrier["tiled_exec"].aggregate(x, "sum").numpy()
        want = fresh.carrier["tiled_exec"].aggregate(x, "sum").numpy()
        ref = np.asarray(jplan.carrier["tiled_exec"].aggregate(x, "sum"))
    else:
        layer = t_engn.EnGNLayer(cfg, device="cpu")
        got = layer._aggregate(plan, torch.from_numpy(x)).numpy()
        want = layer._aggregate(fresh, torch.from_numpy(x)).numpy()
        jlayer = j_engn.EnGNLayer(jcfg)
        ref = np.asarray(jlayer._aggregate(jplan, jax.numpy.asarray(x)))
    assert np.array_equal(got, want), (backend, fmt)
    assert np.array_equal(got, ref), (backend, fmt)


def test_update_plan_spill_rebuilds_and_carries_counters():
    """A plan priced for inference updated under a training config whose
    backward streams double the width: the step no longer fits, the plan
    re-prepares with a smaller tile and counts both store builds, as
    the reference's does."""
    g = _int_graph(64, 300, 4)
    kw = dict(in_dim=16, out_dim=16, backend="tiled", tile=32,
              tiled_chunk=2, device_budget_bytes=21_000)
    infer, jinfer = t_engn.EnGNConfig(**kw), j_engn.EnGNConfig(**kw)
    plan = rt.prepare_graph(g, infer, device="cpu")
    jplan = j_engn.prepare_graph(_ref(g), jinfer)
    assert plan.meta["tile"] == 32
    tlog, jlog = _twin_logs(g)
    train = dataclasses.replace(infer, training=True)
    plan2 = rt.update_plan(plan, _random_epoch(tlog, 5, 20, 60), train)
    jplan2 = j_engn.update_plan(jplan, _random_epoch(jlog, 5, 20, 60),
                                dataclasses.replace(jinfer, training=True))
    st_ = plan2.carrier["tiled_exec"].stats
    assert st_.store_builds >= 2 and st_.delta_merges == 1
    assert _stats(st_) == _stats(jplan2.carrier["tiled_exec"].stats)
    assert plan2.meta["tile"] == jplan2.meta["tile"] < 32
    assert plan2.n == tlog.graph.num_vertices
    x = _int_features(tlog.graph.num_vertices, 16, 4)
    want = rt.prepare_graph(tlog.graph, train, device="cpu").carrier[
        "tiled_exec"].aggregate(x, "sum").numpy()
    got = plan2.carrier["tiled_exec"].aggregate(x, "sum").numpy()
    assert np.array_equal(got, want)


def test_update_plan_mean_tracks_new_in_degrees():
    g = _int_graph(40, 160, 6)
    cfg = t_engn.EnGNConfig(in_dim=5, out_dim=5, aggregate_op="mean",
                            backend="tiled", tile=8)
    plan = rt.prepare_graph(g, cfg, device="cpu")
    log = UpdateLog(g)
    plan = rt.update_plan(plan, _random_epoch(log, 9, 30, 50), cfg)
    x = _int_features(log.graph.num_vertices, 5, 6)
    gg = log.graph
    ev = torch.from_numpy(x)[torch.from_numpy(gg.src).long()] \
        * torch.from_numpy(gg.weights())[:, None]
    want = rt.segment_aggregate(ev, torch.from_numpy(gg.dst),
                                gg.num_vertices, "mean").numpy()
    got = plan.carrier["tiled_exec"].aggregate(x, "mean").numpy()
    assert np.array_equal(got, want)


def test_update_plan_rebuilds_a_rel_normalised_typed_plan():
    """R-GCN's folded relation norms depend on every in-degree: a typed
    tiled plan re-prepares from the epoch graph (one build, no merge),
    and its forward equals a fresh plan's."""
    g = _int_graph(80, 400, 3, relations=3)
    layers = rt.make_gnn_stack("rgcn", [6, 4], num_relations=3,
                               device="cpu")
    cfg = dataclasses.replace(layers[0].cfg, backend="tiled", tile=16)
    plan = rt.prepare_graph(g, cfg, device="cpu")
    log = UpdateLog(g)
    plan = rt.update_plan(plan, _random_epoch(log, 4, 40, 60, grow=10), cfg)
    st_ = plan.carrier["tiled_exec"].stats
    assert (st_.store_builds, st_.delta_merges) == (1, 0)
    fresh = rt.prepare_graph(log.graph, cfg, device="cpu")
    x = _int_features(log.graph.num_vertices, 6, 3)
    with torch.no_grad():
        np.testing.assert_allclose(
            rt.apply_stack(layers, plan, x).numpy(),
            rt.apply_stack(layers, fresh, x).numpy(), rtol=RTOL, atol=ATOL)


# -- the cache ----------------------------------------------------------------

def test_cache_invalidate_drops_rows_but_keeps_pins():
    deg = np.arange(10)[::-1].astype(np.float32)
    c = DegreeAwareCache(capacity=6, degrees=deg, reserved_frac=0.5)
    c.insert(np.arange(6), np.ones((6, 4), np.float32))
    pinned_before = set(c.pinned_ids)
    assert c.invalidate([0, 5, 9]) == 2
    assert c.stats["invalidations"] == 2
    assert set(c.pinned_ids) == pinned_before
    mask, _ = c.lookup(np.array([0, 5]))
    assert not mask.any()
    c.insert(np.array([0]), np.zeros((1, 4), np.float32))
    mask, _ = c.lookup(np.array([0]))
    assert mask.all()


def test_cache_pin_drift_and_repin():
    deg = np.arange(8, dtype=np.float32)
    c = DegreeAwareCache(capacity=4, degrees=deg, reserved_frac=0.5)
    assert c.pin_drift(deg) == 0.0
    flipped = deg[::-1].copy()
    assert c.pin_drift(flipped) == 1.0
    c.insert(np.array([7, 0]), np.ones((2, 3), np.float32))
    assert c.repin(flipped) == 4 and c.stats["repins"] == 1
    assert set(c.pinned_ids) == {0, 1}
    mask, _ = c.lookup(np.array([7, 0]))
    assert mask.all() and 0 in c._pinned and 7 in c._lru


# -- serving ------------------------------------------------------------------

def _serving_pair(g, x, cfg_kw):
    jl = j_models.make_gnn_stack("gcn", [6, 8, 4])
    jp = j_models.init_stack(jl, jax.random.key(0))
    tl = rt.make_gnn_stack("gcn", [6, 8, 4], device="cpu")
    load_reference_params(tl, [{k: np.asarray(v) for k, v in p.items()}
                               for p in jp])
    te = GNNServingEngine(g, x, tl, None, ServingConfig(**cfg_kw))
    je = j_engine.GNNServingEngine(_ref(g), x, jl, jp,
                                   j_engine.ServingConfig(**cfg_kw))
    return te, je, tl


def _ask(eng, rid, ids):
    eng.submit(rid, ids)
    return eng.drain()[0].outputs


@pytest.mark.parametrize("warm", [False, True])
def test_serving_engine_updates_match_cold_engine_and_reference(warm):
    """Mid-traffic epochs (one growing the vertex set): each
    `apply_updates` returns the reference's dict (affected, invalidated,
    pin drift, repins, warm refills), and afterwards the long-lived
    engine, surviving cache rows included, answers like a cold engine on
    the final graph and like the reference."""
    g = _int_graph(120, 700, 8)
    x0 = _int_features(120, 6, 8)
    cfg_kw = dict(batch_size=32, num_hops=2, cache_capacity=64,
                  warm_cache=warm, warm_cache_max=16,
                  hub_drift_threshold=0.0 if warm else 0.25)
    te, je, tl = _serving_pair(g, x0, cfg_kw)
    rng = np.random.default_rng(8)
    tlog, jlog = _twin_logs(g)
    rid = 0
    for ep in range(2):
        for _ in range(3):
            ids = rng.integers(0, tlog.graph.num_vertices, 20).astype(
                np.int32)
            np.testing.assert_allclose(_ask(te, rid, ids), _ask(je, rid, ids),
                                       rtol=RTOL, atol=ATOL)
            rid += 1
        kw = dict(n_del=25, n_ins=40, grow=(6 if ep else 0))
        tsnap = _random_epoch(tlog, 13 + ep, **kw)
        jsnap = _random_epoch(jlog, 13 + ep, **kw)
        x_new = _int_features(tsnap.graph.num_vertices, 6, 8)
        x_new[:x0.shape[0]] = x0
        info = te.apply_updates(tsnap, x_new=x_new)
        assert info == je.apply_updates(jsnap, x_new=x_new)
        assert info["affected"] > 0
        x0 = x_new
    assert te.stats == je.stats
    assert te.stats["updates_applied"] == 2
    assert te.cache.stats == je.cache.stats
    cold = GNNServingEngine(tlog.graph, x0, tl, None,
                            ServingConfig(batch_size=32, num_hops=2))
    ids = np.unique(rng.integers(0, tlog.graph.num_vertices, 48)).astype(
        np.int32)
    got = _ask(te, rid, ids)
    np.testing.assert_allclose(got, _ask(cold, rid, ids), rtol=RTOL,
                               atol=ATOL)
    np.testing.assert_allclose(got, _ask(je, rid, ids), rtol=RTOL, atol=ATOL)


def test_apply_updates_pads_or_checks_the_features():
    g = _int_graph(60, 300, 1)
    te, _, _ = _serving_pair(g, _int_features(60, 6, 1), {})
    log = UpdateLog(g)
    log.insert(3, 70)
    snap = log.snapshot()
    with pytest.raises(ValueError, match="x_new has 60 rows"):
        te.apply_updates(snap, x_new=_int_features(60, 6, 1))
    te.apply_updates(snap)
    assert te.x.shape == (71, 6) and not te.x[60:].any()
    assert te.graph is snap.graph and te.extractor.g is snap.graph
    out = _ask(te, 0, np.array([70, 3], np.int32))
    assert out.shape == (2, 4) and np.isfinite(out).all()


def test_pipeline_apply_updates_drains_first():
    """Batches in flight were extracted on the old graph: the pipeline
    completes them before the swap, then answers on the new graph."""
    g = _int_graph(100, 600, 2)
    x = _int_features(100, 6, 2)
    te, _, tl = _serving_pair(g, x, dict(batch_size=8, cache_capacity=32))
    pl = ServingPipeline(te)
    for rid in range(6):
        pl.submit(rid, np.arange(rid * 5, rid * 5 + 5, dtype=np.int32))
    pl.pump()
    assert pl.inflight
    log = UpdateLog(g)
    snap = _random_epoch(log, 2, 50, 80)
    info = pl.apply_updates(snap)
    assert not pl.inflight and not pl.batcher.queue
    assert set(info) == {"affected", "invalidated", "pin_drift", "repinned",
                         "warm_refilled"}
    assert te.graph is snap.graph
    ids = np.arange(40, dtype=np.int32)
    pl.submit(99, ids)
    got = {r.rid: r.outputs for r in pl.drain()}
    cold = GNNServingEngine(snap.graph, x, tl, None,
                            ServingConfig(batch_size=8))
    np.testing.assert_allclose(got[99], _ask(cold, 0, ids), rtol=RTOL,
                               atol=ATOL)
    pl.close()


# -- on the card ----------------------------------------------------------------

def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.cuda
def test_merge_on_card_rebuilds_the_queue_and_runs_b5():
    """A card executor whose queue was built before the merge: the next
    sum rebuilds the `TileQueue` over the merged store and B5 runs on it,
    matching `tile_queue_plain`, a fresh card executor and the CPU's."""
    dev = _card()
    g0 = j_generate.rmat_graph(3000, 24000, seed=1).gcn_normalized()
    g = COOGraph(3000, g0.src, g0.dst, g0.val)
    kw = dict(tile=256, tile_format="packed")
    ex = t_tiled.TiledExecutor(g, device=dev, **kw)
    x = j_generate.random_features(3000, 64, seed=2)
    ex.aggregate(x, "sum")
    old_tq = ex._tq
    log = UpdateLog(g)
    ex.apply_updates(_random_epoch(log, 1, 2000, 3000, grow=500))
    x = j_generate.random_features(log.graph.num_vertices, 64, seed=3)
    K.reset_launch_counts()
    got = ex.aggregate(x, "sum")
    torch.cuda.synchronize()
    assert K.launch_counts()["chunk_queue_sum"] > 0
    assert ex._tq is not None and ex._tq is not old_tq
    assert ex._tq.n == log.graph.num_vertices
    xd = torch.from_numpy(x).to(dev)
    plain = t_queue.tile_queue_plain(ex._tq, xd).cpu()
    np.testing.assert_allclose(got.numpy(), plain.numpy(), rtol=RTOL,
                               atol=ATOL)
    fresh = t_tiled.TiledExecutor(log.graph, device=dev, **kw)
    np.testing.assert_allclose(got.numpy(), fresh.aggregate(x, "sum").numpy(),
                               rtol=RTOL, atol=ATOL)
    cpu = t_tiled.TiledExecutor(log.graph, device="cpu", **kw)
    np.testing.assert_allclose(got.numpy(), cpu.aggregate(x, "sum").numpy(),
                               rtol=RTOL, atol=ATOL)


@pytest.mark.cuda
def test_int8_merge_on_card_sizes_the_quantiser_for_the_new_store():
    dev = _card()
    g = _int_graph(2000, 16000, 3)
    kw = dict(tile=128, tile_format="packed", value_dtype="int8",
              streaming_mode="callback")
    ex = t_tiled.TiledExecutor(g, device=dev, **kw)
    x = _int_features(2000, 16, 3)
    ex.aggregate(x, "sum")
    log = UpdateLog(g)
    ex.apply_updates(_random_epoch(log, 2, 1500, 2500, grow=300))
    assert ex.quantizer.err.shape == (ex.packed.nnz,)
    x = _int_features(log.graph.num_vertices, 16, 4)
    cpu = t_tiled.TiledExecutor(log.graph, device="cpu", **kw)
    np.testing.assert_allclose(ex.aggregate(x, "sum").numpy(),
                               cpu.aggregate(x, "sum").numpy(),
                               rtol=RTOL, atol=ATOL)
    assert np.array_equal(ex.quantizer.err, cpu.quantizer.err)
