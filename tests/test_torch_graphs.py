"""The port's host-side carriers equal the reference's, field for field:
the same seed builds the same graph, permutation, normalisation, tiles,
tile stores, packed groups, flat entries, format choice and budget
prices."""
import _torch_cpu  # noqa: F401  (this worker's share of the cores)
import dataclasses

import jax  # noqa: F401  (both packages in one process; JAX stays on CPU)
import numpy as np
import pytest
import torch  # noqa: F401

from repro.core import dasr as j_dasr
from repro.core.tiled import dense_footprint_bytes as j_footprint
from repro.graphs import degree as j_degree
from repro.graphs import format as j_format
from repro.graphs import generate as j_generate
from repro.graphs import partition as j_partition
from repro.kernels import autotune as j_autotune
from repro.kernels.rer_gather import ops as j_gather
from repro.kernels.rer_spmm import ops as j_spmm
from repro_torch.core import dasr as t_dasr
from repro_torch.core.tiled import dense_footprint_bytes as t_footprint
from repro_torch.graphs import degree as t_degree
from repro_torch.graphs import format as t_format
from repro_torch.graphs import generate as t_generate
from repro_torch.graphs import partition as t_partition
from repro_torch.kernels import autotune as t_autotune
from repro_torch.kernels import rer_gather as t_gather
from repro_torch.kernels import rer_spmm as t_spmm


def assert_same(a, b, where=""):
    """Exact equality of arrays (values and dtype), scalars, tuples and
    dataclasses, recursively."""
    if dataclasses.is_dataclass(a):
        assert type(a).__name__ == type(b).__name__, where
        for fld in dataclasses.fields(a):
            assert_same(getattr(a, fld.name), getattr(b, fld.name),
                        f"{where}.{fld.name}")
    elif isinstance(a, np.ndarray):
        assert isinstance(b, np.ndarray), where
        assert a.dtype == b.dtype, (where, a.dtype, b.dtype)
        np.testing.assert_array_equal(a, b, err_msg=where)
    elif isinstance(a, (tuple, list)):
        assert len(a) == len(b), where
        for i, (x, y) in enumerate(zip(a, b)):
            assert_same(x, y, f"{where}[{i}]")
    else:
        assert a == b, (where, a, b)


def _pair(name="cora", seed=0, **kw):
    kw = {"max_vertices": 300, **kw}
    return (j_generate.make_dataset(name, seed=seed, **kw),
            t_generate.make_dataset(name, seed=seed, **kw))


@pytest.mark.parametrize("name,kw", [
    ("cora", {}), ("pubmed", {"max_vertices": 500}),
    ("aifb", {"max_vertices": 200}), ("cora", {"feature_dim": 17}),
    ("cora", {"max_edges": 90})])
@pytest.mark.parametrize("seed", [0, 3])
def test_make_dataset_same_graph(name, kw, seed):
    (jg, jf, jl), (tg, tf, tl) = _pair(name, seed, **kw)
    assert (jf, jl) == (tf, tl)
    assert_same(jg, tg, name)


@pytest.mark.parametrize("n,e,rels", [(50, 300, 1), (130, 900, 1),
                                      (64, 400, 5)])
def test_rmat_graph_same_edges(n, e, rels):
    assert_same(j_generate.rmat_graph(n, e, seed=7, num_relations=rels),
                t_generate.rmat_graph(n, e, seed=7, num_relations=rels))
    assert j_generate.DATASET_STATS == t_generate.DATASET_STATS


def test_random_features_same():
    np.testing.assert_array_equal(j_generate.random_features(40, 9, seed=2),
                                  t_generate.random_features(40, 9, seed=2))


def test_degree_permutation_and_features():
    (jg, jf, _), (tg, _, _) = _pair()
    jp = j_degree.degree_sort_permutation(jg)
    tp = t_degree.degree_sort_permutation(tg)
    assert_same(jp, tp)
    assert_same(j_degree.apply_vertex_permutation(jg, jp),
                t_degree.apply_vertex_permutation(tg, tp))
    x = j_generate.random_features(jg.num_vertices, 5, seed=1)
    assert_same(j_degree.permute_features(x, jp),
                t_degree.permute_features(x, tp))
    assert_same(j_degree.unpermute_features(x, jp),
                t_degree.unpermute_features(x, tp))


def test_gcn_normalized_and_degrees():
    (jg, _, _), (tg, _, _) = _pair()
    assert_same(jg.gcn_normalized(), tg.gcn_normalized())
    assert_same(jg.degrees(), tg.degrees())
    assert_same(jg.with_self_loops(), tg.with_self_loops())


@pytest.mark.parametrize("order", ["column", "row", "s"])
@pytest.mark.parametrize("tile", [16, 32])
def test_coo_to_blocked(order, tile):
    (jg, _, _), (tg, _, _) = _pair()
    jb = j_format.coo_to_blocked(jg.gcn_normalized(), tile, order=order)
    tb = t_format.coo_to_blocked(tg.gcn_normalized(), tile, order=order)
    for fld in ("num_vertices", "tile", "q", "blocks", "block_row",
                "block_col"):
        assert_same(getattr(jb, fld), getattr(tb, fld), fld)
    assert (jb.nnzb, jb.padded_vertices) == (tb.nnzb, tb.padded_vertices)


@pytest.mark.parametrize("tile", [16, 32])
def test_prepare_blocks(tile):
    # vertices 0..39 only: the last intervals have no tiles and get pads
    g = t_format.COOGraph(96, np.arange(40, dtype=np.int32),
                          (np.arange(40, dtype=np.int32) * 7) % 40)
    b = t_format.coo_to_blocked(g, tile)
    assert_same(j_spmm.prepare_blocks(b.blocks, b.block_row, b.block_col,
                                      b.q),
                t_spmm.prepare_blocks(b.blocks, b.block_row, b.block_col,
                                      b.q))


@pytest.mark.parametrize("name,tile", [("cora", 16), ("cora", 32),
                                       ("aifb", 16)])
def test_tile_store_and_packed_store(name, tile):
    (jg, _, _), (tg, _, _) = _pair(name, max_vertices=200)
    js = j_partition.build_tile_store(jg, tile)
    ts = t_partition.build_tile_store(tg, tile)
    assert_same(js, ts, "EdgeTileStore")
    jp, tp = j_partition.pack_tile_store(js), t_partition.pack_tile_store(ts)
    assert_same(jp, tp, "PackedTileStore")
    for floor in (1, 8, 32):
        assert jp.packed_slots(floor) == tp.packed_slots(floor)
        assert jp.fill_factor(floor) == tp.fill_factor(floor)
    assert jp.dense_fill() == tp.dense_fill()
    assert_same(jp.tile_nnz(), tp.tile_nnz())
    tiles = np.array([0, 2, -1, 1])
    bucket = j_partition.pow2_bucket(int(jp.tile_nnz().max()))
    assert_same(jp.pack(tiles, 6, bucket), tp.pack(tiles, 6, bucket))


@pytest.mark.parametrize("floor", [1, 8, 64])
def test_prepare_packed_groups_and_flat_entries(floor):
    (jg, _, _), (tg, _, _) = _pair(max_vertices=250)
    jp = j_partition.pack_tile_store(
        j_partition.build_tile_store(jg.gcn_normalized(), 16))
    tp = t_partition.pack_tile_store(
        t_partition.build_tile_store(tg.gcn_normalized(), 16))
    assert_same(j_gather.prepare_packed_groups(jp, floor),
                t_gather.prepare_packed_groups(tp, floor))
    assert_same(j_gather.flat_entries(jp), t_gather.flat_entries(tp))


def test_partition_helpers():
    for n in (0, 1, 7, 8, 9, 1000):
        for floor in (1, 8):
            assert (j_partition.pow2_bucket(n, floor)
                    == t_partition.pow2_bucket(n, floor))
    for f, h in ((8, 4), (4, 8), (64, 32), (1433, 64)):
        assert (j_partition.tile_schedule_order(f, h)
                == t_partition.tile_schedule_order(f, h))
        for order in ("column", "row"):
            assert (j_partition.io_cost(order, 5, f, h)
                    == t_partition.io_cost(order, 5, f, h))
    rng = np.random.default_rng(0)
    key = rng.integers(0, 20, 200)
    w = rng.standard_normal(200).astype(np.float32)
    assert_same(j_partition.merge_by_key(key, w),
                t_partition.merge_by_key(key, w))


@pytest.mark.parametrize("requested", ["dense", "packed", "auto"])
@pytest.mark.parametrize("tile", [8, 32])
def test_choose_tile_format_record(requested, tile):
    (jg, _, _), (tg, _, _) = _pair(max_vertices=200)
    jp = j_partition.pack_tile_store(j_partition.build_tile_store(jg, tile))
    tp = t_partition.pack_tile_store(t_partition.build_tile_store(tg, tile))
    for vd in ("fp32", "int8"):
        jc = j_autotune.choose_tile_format(requested, jp, backend="blocked",
                                           value_dtype=vd)
        tc = t_autotune.choose_tile_format(requested, tp, backend="blocked",
                                           value_dtype=vd)
        assert jc.as_dict() == tc.as_dict()
    assert (j_autotune.choose_tile_format(requested, None).as_dict()
            == t_autotune.choose_tile_format(requested, None).as_dict())


def _measured_pair(monkeypatch, dim=16):
    """The reference's and the port's measured choice over one graph, each
    cache emptied first and each store's `densify` spied on (the sample
    the dense step times)."""
    g = j_generate.rmat_graph(300, 3000, seed=1)
    js = j_partition.build_tile_store(g, 32)
    ts = t_partition.build_tile_store(g, 32)
    jp, tp = j_partition.pack_tile_store(js), t_partition.pack_tile_store(ts)
    sampled = {}
    for name, mod in (("ref", j_partition), ("port", t_partition)):
        real = mod.EdgeTileStore.densify

        def spy(self, tiles, out, real=real, name=name):
            sampled[name] = np.asarray(tiles).copy()
            return real(self, tiles, out)
        monkeypatch.setattr(mod.EdgeTileStore, "densify", spy)
    monkeypatch.setattr(j_autotune, "_MEASURED", {})
    monkeypatch.setattr(t_autotune, "_MEASURED", {})
    jc = j_autotune.measured_choice(js, jp, dim=dim)
    tc = t_autotune.measured_choice(ts, tp, dim=dim, device="cpu")
    return (js, jp, jc), (ts, tp, tc), sampled


def test_measured_choice_sample_key_and_record_equal_reference(monkeypatch):
    """The timed choice: the sample (the 4 densest tiles), the cache key
    and its hit, and every field but the format and floor picked, which
    are timed, equal the reference's; the record is the cost model's at
    the floor that won, with reason "measured"."""
    (js, jp, jc), (ts, tp, tc), sampled = _measured_pair(monkeypatch)
    _same = np.testing.assert_array_equal
    _same(sampled["port"], sampled["ref"])
    nnz = tp.tile_nnz()
    assert set(nnz[sampled["port"]]) <= set(np.sort(nnz)[-4:])
    key = t_autotune._fingerprint(tp, "tiled", 16)
    assert key == j_autotune._fingerprint(jp, "tiled", 16)
    assert list(t_autotune._MEASURED) == [key]
    assert list(j_autotune._MEASURED) == [key]
    assert tc.reason == jc.reason == "measured"
    assert tc.bucket_floor in (8, 32) and tc.fmt in ("dense", "packed")
    model = t_autotune._model_choice(tp, tc.bucket_floor)
    assert dataclasses.replace(tc, fmt=model.fmt, reason="cost-model") == \
        model
    assert model.as_dict() == j_autotune._model_choice(
        jp, tc.bucket_floor).as_dict()
    sampled.clear()
    assert t_autotune.measured_choice(ts, tp, dim=16, device="cpu") is tc
    assert t_autotune.measured_choice(ts, tp, dim=12, device="cpu") is tc
    assert sampled == {}     # a hit (dim 12 pads to 16 too) times nothing


@pytest.mark.parametrize("vd", ["fp32", "int8"])
def test_choose_tile_format_measured_equals_reference(monkeypatch, vd):
    """`choose_tile_format(measure=True)` through the measured choice:
    the floors it tries, its reason and the value dtype it records equal
    the reference's; without a store, or for a forced format, it is the
    cost model's."""
    (js, jp, _), (ts, tp, _), _ = _measured_pair(monkeypatch)
    monkeypatch.setattr(j_autotune, "_MEASURED", {})
    monkeypatch.setattr(t_autotune, "_MEASURED", {})
    jc = j_autotune.choose_tile_format("auto", jp, measure=True, store=js,
                                       dim=16, value_dtype=vd)
    tc = t_autotune.choose_tile_format("auto", tp, measure=True, store=ts,
                                       dim=16, value_dtype=vd, device="cpu")
    assert tc.reason == jc.reason == "measured"
    assert tc.value_dtype == jc.value_dtype == vd
    assert tc.bucket_floor in (8, 32)
    for req, kw in (("auto", {}), ("packed", {"store": None}),
                    ("dense", {})):
        jkw = dict(kw, store=kw.get("store", js))
        tkw = dict(kw, store=kw.get("store", ts))
        if req == "auto":
            jkw["store"] = tkw["store"] = None
        assert (t_autotune.choose_tile_format(
                    req, tp, measure=True, value_dtype=vd, device="cpu",
                    **tkw).as_dict()
                == j_autotune.choose_tile_format(
                    req, jp, measure=True, value_dtype=vd, **jkw).as_dict())
    with pytest.raises(ValueError):
        t_autotune.choose_tile_format("sparse", tp)


def test_measured_executor_equals_reference(monkeypatch):
    """TiledExecutor(autotune_measure=True): the choice is the measured
    one on both sides (dim from dim_hint), and the aggregate on an
    integer graph is the reference's whatever format was picked."""
    monkeypatch.setattr(j_autotune, "_MEASURED", {})
    monkeypatch.setattr(t_autotune, "_MEASURED", {})
    from repro.core import tiled as j_tiled
    from repro_torch.core import tiled as t_tiled
    g = j_generate.rmat_graph(200, 1500, seed=3)
    uniq = np.unique(np.stack([g.src, g.dst]), axis=1)
    g = t_format.COOGraph(200, uniq[0].astype(np.int32),
                          uniq[1].astype(np.int32),
                          np.ones(uniq.shape[1], np.float32))
    x = np.random.default_rng(0).integers(-3, 4, (200, 8)).astype(
        np.float32)
    kw = dict(tile=32, autotune_measure=True, dim_hint=8)
    je = j_tiled.TiledExecutor(g, **kw)
    te = t_tiled.TiledExecutor(g, device="cpu", **kw)
    assert te.format_choice.reason == je.format_choice.reason == "measured"
    assert t_autotune._fingerprint(te.packed, "tiled", 8) in \
        t_autotune._MEASURED
    np.testing.assert_array_equal(te.aggregate(x, "sum").numpy(),
                                  je.aggregate(x, "sum"))


# -- the grid partition, the tile schedule and the I/O replay (Table 3) ----------

@pytest.mark.parametrize("q", [1, 2, 3, 8])
@pytest.mark.parametrize("seed", [0, 4])
def test_grid_partition_equals_reference(q, seed):
    g = j_generate.rmat_graph(90, 700, seed=seed)
    jp = j_partition.grid_partition(g, q)
    tp = t_partition.grid_partition(g, q)
    assert type(tp).__name__ == "GridPartition"
    assert_same(tp, jp)
    assert sum(len(s) for s in tp.shard_edges) == g.num_edges


@pytest.mark.parametrize("order", ["column", "row"])
@pytest.mark.parametrize("s_shape", [False, True])
def test_schedule_tiles_equals_reference(order, s_shape):
    for q in range(1, 8):
        tiles = t_partition.schedule_tiles(q, order, s_shape)
        assert tiles == j_partition.schedule_tiles(q, order, s_shape)
        assert sorted(tiles) == [(i, j) for i in range(q) for j in range(q)]
    for mod in (j_partition, t_partition):
        with pytest.raises(ValueError):
            mod.schedule_tiles(3, "diagonal")


@pytest.mark.parametrize("order", ["column", "row"])
@pytest.mark.parametrize("s_shape", [False, True])
def test_simulated_io_bytes_equals_reference(order, s_shape):
    """The replay equals the reference's, and with the S-shape Table 3's
    closed form in interval units."""
    for q, f, h, interval, el in ((2, 5, 3, 1, 1), (5, 64, 16, 256, 4),
                                  (8, 7, 300, 33, 2)):
        got = t_partition.simulated_io_bytes(q, order, f, h, interval,
                                             bytes_per_el=el,
                                             s_shape=s_shape)
        assert got == j_partition.simulated_io_bytes(
            q, order, f, h, interval, bytes_per_el=el, s_shape=s_shape)
        if s_shape and interval == 1 and el == 1:
            assert got == t_partition.io_cost(order, q, f, h)


# -- DAVC, hub coverage, dataset statistics ---------------------------------------

@pytest.mark.parametrize("n,e,seed", [(5, 1, 0), (60, 400, 1),
                                      (300, 2500, 2), (2000, 20000, 3)])
@pytest.mark.parametrize("lines,frac", [(1, 0.0), (16, 0.5), (64, 1.0),
                                        (256, 0.25)])
def test_simulate_davc_equals_reference(n, e, seed, lines, frac):
    from repro.core import davc as j_davc
    from repro_torch.core import davc as t_davc
    g = j_generate.rmat_graph(n, e, seed=seed)
    got = t_davc.simulate_davc(g, lines, frac)
    assert got == j_davc.simulate_davc(g, lines, frac)
    if e <= 2500:
        assert t_davc.simulate_davc_reference(g, lines, frac) == \
            j_davc.simulate_davc_reference(g, lines, frac)
        assert got == pytest.approx(
            t_davc.simulate_davc_reference(g, lines, frac), abs=1e-12)


@pytest.mark.parametrize("frac", [0.05, 0.2, 1.0])
def test_hub_edge_coverage_equals_reference(frac):
    g = j_generate.rmat_graph(2000, 30000, seed=5)
    got = t_degree.hub_edge_coverage(g, frac)
    assert got == j_degree.hub_edge_coverage(g, frac)
    assert (got == 1.0) == (frac == 1.0)


def test_dataset_stats_equal_reference():
    import repro_torch.graphs as t_graphs
    assert t_graphs.dataset_stats is t_generate.dataset_stats
    assert set(t_generate.DATASET_STATS) == set(j_generate.DATASET_STATS)
    for name in j_generate.DATASET_STATS:
        assert t_generate.dataset_stats(name) == \
            j_generate.dataset_stats(name)
    assert t_generate.dataset_stats("cora") == (2708, 10556, 1433, 7)
    with pytest.raises(KeyError):
        t_generate.dataset_stats("nope")


@pytest.mark.parametrize("backend", ["segment", "blocked", "fused", "ring"])
@pytest.mark.parametrize("fmt", ["dense", "packed", "auto"])
@pytest.mark.parametrize("training", [False, True])
def test_dense_footprint_bytes(backend, fmt, training):
    for vd in ("fp32", "int8"):
        kw = dict(backend=backend, tile=64, tile_format=fmt,
                  training=training, value_dtype=vd, num_shards=4)
        assert (j_footprint(5000, 40000, 300, 16, **kw)
                == t_footprint(5000, 40000, 300, 16, **kw))


def test_dasr_decision():
    for args in ((100, 1000, 64, 16), (100, 1000, 16, 64),
                 (2708, 13264, 1433, 64)):
        assert (dataclasses.asdict(j_dasr.dasr_decide(*args))
                == dataclasses.asdict(t_dasr.dasr_decide(*args)))
        for base in ("fau", "afu"):
            assert (j_dasr.predicted_speedup(*args, base)
                    == t_dasr.predicted_speedup(*args, base))


# -- the A^T carriers of the backward -------------------------------------

@pytest.mark.parametrize("name,tile", [("cora", 16), ("aifb", 16),
                                       ("cora", 32)])
def test_transposed_stores_equal_reference(name, tile):
    (jg, _, _), (tg, _, _) = _pair(name, max_vertices=200)
    js = j_partition.build_tile_store(jg.gcn_normalized(), tile)
    ts = t_partition.build_tile_store(tg.gcn_normalized(), tile)
    jt, tt = (j_partition.transpose_tile_store(js),
              t_partition.transpose_tile_store(ts))
    assert_same(jt, tt, "transposed EdgeTileStore")
    assert_same(js, t_partition.transpose_tile_store(tt), "A^T^T")
    jp = j_partition.transpose_packed_store(j_partition.pack_tile_store(js))
    tp = t_partition.transpose_packed_store(t_partition.pack_tile_store(ts))
    assert_same(jp, tp, "transposed PackedTileStore")
    for floor in (1, 8):
        assert_same(j_gather.prepare_packed_groups(jp, floor),
                    t_gather.prepare_packed_groups(tp, floor))


@pytest.mark.parametrize("tile", [16, 32])
@pytest.mark.parametrize("n_src", [40, 96])
def test_transposed_dense_carrier_is_prepare_blocks_of_a_transpose(tile,
                                                                   n_src):
    """`transpose_blocks` lays A^T out as the reference's `prepare_blocks`
    lays out any carrier: tiles transposed, roles swapped, pads for the
    intervals that are no tile's source, one stable sort."""
    rng = np.random.default_rng(tile + n_src)
    src = rng.integers(0, n_src, 300).astype(np.int32)
    dst = rng.integers(0, 96, 300).astype(np.int32)
    g = t_format.COOGraph(96, src, dst,
                          rng.standard_normal(300).astype(np.float32))
    b = t_format.coo_to_blocked(g, tile)
    blocks, brow, bcol = t_spmm.prepare_blocks(b.blocks, b.block_row,
                                               b.block_col, b.q)
    got = t_partition.transpose_blocks(blocks, brow, bcol, b.q)
    want = j_spmm.prepare_blocks(blocks.transpose(0, 2, 1), bcol, brow, b.q)
    assert_same(tuple(got[:3]), tuple(want))
    tile_of = got[3]
    real = tile_of >= 0
    np.testing.assert_array_equal(got[0][real],
                                  blocks[tile_of[real]].transpose(0, 2, 1))
    assert not got[0][~real].any()
