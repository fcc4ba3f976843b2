"""The streamed `tiled` slice of the port against the reference, on the CPU.

Carriers (tile-store indexes, packed buckets, `ChunkQueue`, the fitted
plans) are exactly equal; the port's `TileQueue` equals the reference's
with its padded `(K, S)` entries stripped to the ragged real entries.
On integer graphs (small-integer weights and features: every fp32 sum
is exact in any order) the executor's outputs and its `TiledStats`
counters are exactly equal to the reference's; on real-valued inputs
sums agree to rtol=1e-4, atol=1e-5 (the frameworks reduce in different
orders) and maxima exactly.  The CUDA kernels run only on a card: the
`cuda`-marked tests skip without one.
"""
import _torch_cpu  # noqa: F401  (this worker's share of the cores)
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import engn as j_engn
from repro.core import models as j_models
from repro.core import tiled as j_tiled
from repro.graphs import partition as j_part
from repro.graphs.generate import make_dataset, random_features, rmat_graph
from repro.kernels.chunk_queue import ops as j_queue
from repro.kernels.rer_gather import ops as j_gather
import repro_torch as rt
from repro_torch.core import engn as t_engn
from repro_torch.core import tiled as t_tiled
from repro_torch.graphs import partition as t_part
from repro_torch.graphs.format import COOGraph
from repro_torch.interop import load_reference_params
from repro_torch.kernels.chunk_queue import ops as t_queue
from repro_torch.kernels.rer_gather import ops as t_gather

RTOL, ATOL = 1e-4, 1e-5


def _int_graph(n=60, e=400, seed=1):
    """Deduplicated graph with weights in {1, 2, 3}: float sums of small
    integers are exact in fp32 whatever the order, and without
    multi-edges the tiles' merge leaves max alone."""
    g = rmat_graph(n, e, seed=seed)
    uniq = np.unique(np.stack([g.src, g.dst]), axis=1)
    val = np.random.default_rng(seed).integers(1, 4, uniq.shape[1])
    return COOGraph(n, uniq[0].astype(np.int32), uniq[1].astype(np.int32),
                    val.astype(np.float32))


def _int_features(n, f, seed=0):
    return np.random.default_rng(seed + 17).integers(
        -3, 4, (n, f)).astype(np.float32)


def _real_graph(n=90, f=12, seed=0):
    """A GCN-normalised R-MAT graph with its multi-edges merged up front:
    the tiles merge them by summation before a max sees them (the
    reference's convention) and the segment backend does not, so only a
    merged graph holds a tiled max against segment."""
    g, _, _ = make_dataset("cora", seed=seed, max_vertices=n, feature_dim=f)
    g = g.gcn_normalized()
    key, val = t_part.merge_by_key(g.dst.astype(np.int64) * n + g.src,
                                   g.weights())
    g = COOGraph(n, (key % n).astype(np.int32), (key // n).astype(np.int32),
                 val)
    return g, random_features(n, f, seed=1)


def _stats(stats):
    return dataclasses.asdict(stats)


# -- carriers -------------------------------------------------------------

@pytest.mark.parametrize("tile", [8, 16])
def test_tile_store_methods_equal_reference(tile):
    g = _int_graph(seed=tile)
    js = j_part.build_tile_store(g, tile)
    ts = t_part.build_tile_store(g, tile)
    assert ts.nbytes() == js.nbytes()
    for i in range(js.q):
        np.testing.assert_array_equal(ts.row_tiles(i), js.row_tiles(i))
        np.testing.assert_array_equal(ts.col_tiles(i), js.col_tiles(i))
    tiles = np.arange(js.nnzb)[::3]
    want = js.densify(tiles, np.full((tiles.size + 1, tile, tile), 7.0,
                                     np.float32))
    got = ts.densify(tiles, np.full((tiles.size + 1, tile, tile), 7.0,
                                    np.float32))
    np.testing.assert_array_equal(got, want)
    jp, tp = j_part.pack_tile_store(js), t_part.pack_tile_store(ts)
    assert tp.nbytes() == jp.nbytes()
    for floor in (1, 8, 32):
        for idx in ([], [0], tiles, np.arange(jp.nnzb)):
            assert tp.bucket_of(idx, floor) == jp.bucket_of(idx, floor)


@pytest.mark.parametrize("snake", [False, True])
@pytest.mark.parametrize("chunk", [1, 3, 8])
def test_chunk_tile_row_equals_reference(snake, chunk):
    for tiles in ([], [4], list(range(11)), np.arange(5, 22, 2)):
        want = j_part.chunk_tile_row(tiles, chunk, snake=snake)
        got = t_part.chunk_tile_row(tiles, chunk, snake=snake)
        assert len(got) == len(want)
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)
            assert a.dtype == b.dtype


@pytest.mark.parametrize("slab", [None, 64, 1000])
def test_chunk_queue_equals_reference(slab):
    packed = t_part.pack_tile_store(t_part.build_tile_store(_int_graph(),
                                                            16))
    jq = j_queue.build_chunk_queue(packed, slab=slab)
    tq = t_queue.build_chunk_queue(packed, slab=slab, device="cpu")
    for name in ("n", "entries", "steps", "slab", "value_dtype"):
        assert getattr(tq, name) == getattr(jq, name), name
    for name in ("gsrc", "gdst", "vals", "scales"):
        got, want = getattr(tq, name).numpy(), np.asarray(getattr(jq, name))
        np.testing.assert_array_equal(got, want)
        assert got.dtype == want.dtype, name
    assert tq.device_bytes() == jq.device_bytes()
    assert tq.raw_value_bytes() == jq.raw_value_bytes()
    for m, s in ((0, 1), (1, 256), (1000, 256), (1000, 4096)):
        assert t_queue.queue_bytes(m, s) == j_queue.queue_bytes(m, s)


@pytest.mark.parametrize("n,tile,floor", [(60, 16, 8), (90, 8, 8),
                                          (40, 16, 64)])
def test_tile_queue_is_the_reference_stripped_of_padding(n, tile, floor):
    packed = t_part.pack_tile_store(t_part.build_tile_store(
        _int_graph(n=n, e=6 * n, seed=n), tile))
    jq = j_queue.build_tile_queue(packed, floor)
    tq = t_queue.build_tile_queue(packed, floor, device="cpu")
    for name in ("n", "tile", "q", "bucket"):
        assert getattr(tq, name) == getattr(jq, name), name
    for name in ("tile_ptr", "tile_src"):
        got, want = getattr(tq, name).numpy(), np.asarray(getattr(jq, name))
        np.testing.assert_array_equal(got, want)
        assert got.dtype == want.dtype
    ptr = tq.entry_ptr.numpy()
    nnz = np.diff(ptr)
    assert ptr[0] == 0 and nnz.sum() == packed.nnz
    for name in ("rows", "cols", "vals"):
        ragged, padded = getattr(tq, name).numpy(), np.asarray(getattr(jq,
                                                                       name))
        assert ragged.dtype == padded.dtype
        for c in range(nnz.size):
            np.testing.assert_array_equal(ragged[ptr[c]:ptr[c + 1]],
                                          padded[c, :nnz[c]])
            assert not padded[c, nnz[c]:].any()
    # the walker's copy: each interval's entries sorted by local row, a
    # row's entries in tile order, with their global source rows
    tile_of = np.repeat(np.arange(nnz.size), nnz)
    dst = np.repeat(np.arange(tq.q), np.diff(tq.tile_ptr.numpy()))[tile_of]
    order = np.lexsort((tq.rows.numpy(), dst))
    src = (tq.tile_src.numpy()[tile_of] * tile + tq.cols.numpy())
    np.testing.assert_array_equal(tq.wrows.numpy(), tq.rows.numpy()[order])
    np.testing.assert_array_equal(tq.wsrc.numpy(), src[order])
    np.testing.assert_array_equal(tq.wvals.numpy(), tq.vals.numpy()[order])
    for name, dtype in (("wrows", np.int32), ("wsrc", np.int32),
                        ("wvals", np.float32)):
        assert getattr(tq, name).numpy().dtype == dtype
    # 12 B per real entry beside the uniform pad the reference stages
    assert tq.device_bytes() < jq.device_bytes()


def _hub_store():
    """A packed store whose first interval (the hub) holds 600 entries,
    with an empty interval among the rest."""
    rng = np.random.default_rng(4)
    n, t = 96, 8
    hub_dst = rng.integers(0, t, 600)
    dst = np.concatenate([hub_dst, rng.integers(2 * t, n, 300)])
    src = rng.integers(0, n, dst.size)
    key = np.unique(dst.astype(np.int64) * n + src)
    g = COOGraph(n, (key % n).astype(np.int32), (key // n).astype(np.int32),
                 rng.integers(1, 4, key.size).astype(np.float32))
    return g, t_part.pack_tile_store(t_part.build_tile_store(g, t))


def _hub_queue(segment):
    g, packed = _hub_store()
    return g, _with_pieces(t_queue.build_tile_queue(packed, device="cpu"),
                           segment)


def _with_pieces(tq, segment):
    """The queue with its work table cut in pieces of at most `segment`
    entries (the walker's copy fits any cut)."""
    seg = t_queue.queue_segments(tq.tile_ptr.cpu().numpy(),
                                 tq.entry_ptr.cpu().numpy(), segment)
    return dataclasses.replace(
        tq, pieces=torch.from_numpy(seg).to(tq.pieces.device),
        n_split=t_queue.split_count(seg))


@pytest.mark.parametrize("segment", [1, 7, 64, 4096])
def test_queue_segments_cover_each_interval_once(segment):
    """The walker's work table: every interval's entry span is cut into
    pieces of at most `segment` entries that cover it exactly, in entry
    order; an empty interval keeps one empty piece (its block is still
    written); a split interval has a slot of its own and the count of its
    pieces; rows run longest first; the builder cuts at SEGMENT; rows
    ascend within each interval of the walker's copy."""
    _, tq = _hub_queue(segment)
    tile_ptr, entry_ptr = tq.tile_ptr.numpy(), tq.entry_ptr.numpy()
    seg = t_queue.queue_segments(tile_ptr, entry_ptr, segment)
    assert seg.dtype == np.int32 and seg.shape[1] == 5
    assert seg.flags["C_CONTIGUOUS"]
    np.testing.assert_array_equal(tq.pieces.numpy(), seg)
    built = t_queue.build_tile_queue(_hub_store()[1], device="cpu")
    np.testing.assert_array_equal(built.pieces.numpy(),
                                  t_queue.queue_segments(tile_ptr, entry_ptr))
    assert built.n_split == t_queue.split_count(built.pieces.numpy())
    size = seg[:, 2] - seg[:, 1]
    assert (np.diff(size) <= 0).all()                 # longest first
    bounds = entry_ptr[tile_ptr]
    slots = []
    for i in range(tq.q):
        mine = seg[seg[:, 0] == i]
        assert len(mine) >= 1
        assert mine[0, 1] == bounds[i] and mine[-1, 2] == bounds[i + 1]
        np.testing.assert_array_equal(mine[1:, 1], mine[:-1, 2])
        assert ((mine[:, 2] - mine[:, 1]) <= segment).all()
        assert (mine[:, 4] == len(mine)).all()
        if len(mine) > 1:
            assert len(set(mine[:, 3].tolist())) == 1 and mine[0, 3] >= 0
            slots.append(int(mine[0, 3]))
        else:
            assert mine[0, 3] == -1
    assert slots == list(range(len(slots))) and tq.n_split == len(slots)
    # every entry once; the hub split whenever it outgrows a piece; an
    # empty interval present
    covered = np.concatenate([np.arange(lo, hi) for _, lo, hi, _, _ in seg])
    np.testing.assert_array_equal(np.sort(covered),
                                  np.arange(entry_ptr[-1]))
    assert (np.diff(bounds) == 0).any()
    assert (seg[seg[:, 0] == 0, 4] > 1).all() == (bounds[1] > segment)
    # rows ascend within each interval of the walker's copy, so a piece
    # covers a contiguous range of rows
    wrows = tq.wrows.numpy()
    for i in range(tq.q):
        assert (np.diff(wrows[bounds[i]:bounds[i + 1]]) >= 0).all()


WARPS = 8                  # warps of a walker CTA (csrc/chunk_queue.cu)


def _walk_like_the_kernel(tq, x):
    """The CUDA walker's order of work in numpy: per piece, eight warps
    over contiguous runs of the row-sorted copy, each flushing a row's
    sum into the CTA's block when the row changes; an unsplit interval
    stores its block, a piece of a split interval adds only its own rows
    (first entry's to last entry's) into its slot's block, and the last
    piece to arrive stores the interval.  Exercises the host table the
    kernel runs on the card."""
    t, f = tq.tile, x.shape[1]
    wrows, wsrc = tq.wrows.numpy(), tq.wsrc.numpy()
    wvals = tq.wvals.numpy()
    y = np.full((tq.q * t, f), np.nan, np.float32)
    part = np.zeros((tq.n_split, t, f), np.float32)
    arrived = np.zeros(tq.n_split, np.int64)
    flushes = 0
    for dst, lo, hi, slot, count in tq.pieces.numpy():
        acc = np.zeros((t, f), np.float32)
        step = (-(-(hi - lo) // WARPS) + 31) // 32 * 32
        for w in range(WARPS):
            cur, run = -1, np.zeros(f, np.float32)
            for e in range(lo + w * step, min(hi, lo + (w + 1) * step)):
                if wrows[e] != cur:
                    if cur >= 0:
                        acc[cur] += run
                        flushes += 1
                    cur, run = wrows[e], np.zeros(f, np.float32)
                run += wvals[e] * x[wsrc[e]]
            if cur >= 0:
                acc[cur] += run
                flushes += 1
        if slot < 0:
            y[dst * t:(dst + 1) * t] = acc
            continue
        r_lo, r_hi = wrows[lo], wrows[hi - 1] + 1
        assert not acc[:r_lo].any() and not acc[r_hi:].any()
        part[slot, r_lo:r_hi] += acc[r_lo:r_hi]
        arrived[slot] += 1
        if arrived[slot] == count:
            y[dst * t:(dst + 1) * t] = part[slot]
    return y[:tq.n], flushes


@pytest.mark.parametrize("segment", [7, 64, 4096])
def test_queue_work_walk_matches_plain(segment):
    """Walking the work table as the kernel does (every piece and warp,
    a row flushed when it changes, split intervals merged over their
    pieces' row ranges) sums what `tile_queue_plain` sums and writes
    every row once, the hub split."""
    g, tq = _hub_queue(segment)
    x = _int_features(g.num_vertices, 5)
    got, flushes = _walk_like_the_kernel(tq, x)
    want = t_queue.tile_queue_plain(tq, torch.from_numpy(x)).numpy()
    assert not np.isnan(got).any()
    np.testing.assert_array_equal(got, want)
    # a warp flushes a row once per run: never more than once per
    # (tile, row) pair, as walking the tile order would
    runs = np.unique(np.repeat(np.arange(tq.entry_ptr.numel() - 1),
                               np.diff(tq.entry_ptr.numpy())) * tq.tile
                     + tq.rows.numpy()).size
    assert flushes <= runs


def test_queue_builders_default_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device works")
    packed = t_part.pack_tile_store(t_part.build_tile_store(_int_graph(),
                                                            16))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        t_queue.build_tile_queue(packed)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        t_queue.build_chunk_queue(packed)


def _fit(fit, budget, dim):
    try:
        return fit(budget, dim)
    except (j_tiled.DeviceBudgetExceeded, t_tiled.DeviceBudgetExceeded):
        return "raise"


def test_fit_tile_plan_equals_reference():
    for budget in (None, 10 ** 9, 200_000, 40_000, 5_000):
        for dim in (8, 64, 300):
            assert (_fit(t_tiled.fit_tile_plan, budget, dim)
                    == _fit(j_tiled.fit_tile_plan, budget, dim))
            assert (t_tiled._step_bytes(32, 4, dim, 2)
                    == j_tiled._step_bytes(32, 4, dim, 2))
    with pytest.raises(t_tiled.DeviceBudgetExceeded):
        t_tiled.fit_tile_plan(10, 300)


def _chunk(ex, d):
    try:
        return ex.effective_chunk(d)
    except (j_tiled.DeviceBudgetExceeded, t_tiled.DeviceBudgetExceeded):
        return "raise"


@pytest.mark.parametrize("budget", [None, 20_000, 40_000, 60_000, 400_000])
def test_effective_chunk_and_queue_plan_equal_reference(budget):
    g = _int_graph(n=100, e=600, seed=0)
    kw = dict(tile=32, chunk=4, budget_bytes=budget, dim_hint=8,
              tile_format="packed")
    je = j_tiled.TiledExecutor(g, **kw)
    te = t_tiled.TiledExecutor(g, device="cpu", **kw)
    assert (te.store.tile, te.chunk) == (je.store.tile, je.chunk)
    for d in (1, 8, 24, 64):
        assert _chunk(te, d) == _chunk(je, d), d
        jp, tp = je.queue_plan(d), te.queue_plan(d)
        assert (tp is None) == (jp is None)
        if jp is not None:
            assert dataclasses.asdict(tp) == dataclasses.asdict(jp)


# -- the plain versions ------------------------------------------------------

@pytest.mark.parametrize("op", ["sum", "max"])
@pytest.mark.parametrize("slab", [None, 50])
def test_queue_sweep_plain_matches_reference(op, slab):
    g, x = _real_graph()
    packed = t_part.pack_tile_store(t_part.build_tile_store(g, 16))
    jq = j_queue.build_chunk_queue(packed, slab=slab)
    tq = t_queue.build_chunk_queue(packed, slab=slab, device="cpu")
    want = np.asarray(j_queue.queue_sweep_xla(
        jq.gsrc, jq.gdst, jq.vals, jq.scales, jnp.asarray(x), n=jq.n, op=op))
    got = t_queue.queue_sweep_plain(tq.gsrc, tq.gdst, tq.vals, tq.scales,
                                    torch.from_numpy(x), n=tq.n, op=op)
    if op == "max":
        np.testing.assert_array_equal(got.numpy(), want)
    else:
        np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)
    # the dispatcher takes the plain sweep for CPU tensors
    via = t_queue.chunk_queue_aggregate(tq, torch.from_numpy(x), op=op)
    np.testing.assert_array_equal(via.numpy(), got.numpy())


@pytest.mark.parametrize("activation", [None, "relu"])
@pytest.mark.parametrize("f", [5, 13])
def test_tile_queue_plain_matches_pallas_interpret(activation, f):
    g, _ = _real_graph(n=70)
    x = np.random.default_rng(f).standard_normal((70, f)).astype(np.float32)
    packed = t_part.pack_tile_store(t_part.build_tile_store(g, 16))
    jq = j_queue.build_tile_queue(packed)
    tq = t_queue.build_tile_queue(packed, device="cpu")
    want = np.asarray(j_queue.tile_queue_aggregate(
        jq, jnp.asarray(x), feature_chunk=8, interpret=True,
        activation=activation))
    got = t_queue.tile_queue_plain(tq, torch.from_numpy(x), activation)
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)
    # the wrapper takes the plain version for CPU tensors
    via = t_queue.tile_queue_aggregate(tq, torch.from_numpy(x),
                                       activation=activation)
    np.testing.assert_array_equal(via.numpy(), got.numpy())


@pytest.mark.parametrize("op", ["sum", "max"])
@pytest.mark.parametrize("c", [1, 4])
def test_packed_tile_part_plain_matches_reference(op, c):
    g, _ = _real_graph()
    store = t_part.build_tile_store(g, 16)
    packed = t_part.pack_tile_store(store)
    rng = np.random.default_rng(c)
    tiles = store.row_tiles(0)[:c]
    bucket = packed.bucket_of(tiles)
    rows, cols, vals = packed.pack(tiles, c, bucket)
    xs = rng.standard_normal((c, 16, 7)).astype(np.float32)
    want = np.asarray(j_gather._packed_tile_part_xla(
        jnp.asarray(rows), jnp.asarray(cols), jnp.asarray(vals),
        jnp.asarray(xs), t=16, op=op))
    args = [torch.from_numpy(a) for a in (rows, cols, vals, xs)]
    got = t_gather.packed_tile_part_plain(*args, op=op).numpy()
    if op == "max":
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    np.testing.assert_array_equal(
        t_gather.packed_tile_part(*args, op=op).numpy(), got)


# -- the executor ------------------------------------------------------------

def _executor_cases():
    for fmt in ("dense", "packed"):
        for mode in ("callback", "auto"):
            if fmt == "dense" and mode == "auto":
                continue                 # no packed store: always streams
            for order in ("column", "row"):
                for op in ("sum", "max", "mean"):
                    yield fmt, mode, order, op


@pytest.mark.parametrize("fmt,mode,order,op", list(_executor_cases()))
@pytest.mark.parametrize("impls", [(None, None), ("xla", "plain"),
                                   ("pallas", "cuda")],
                         ids=["default", "plain", "kernel-route"])
def test_aggregate_and_stats_equal_reference(fmt, mode, order, op, impls):
    """Column and row order x dense and packed x callback loop and
    chunk queue x sum / max / mean: outputs and every counter exactly
    equal on an integer graph.  On the kernel route the port stages the
    ragged TileQueue where the reference stages its padded one, so only
    `queue_h2d_bytes` differs there, by exactly that layout."""
    g = _int_graph()
    x = _int_features(g.num_vertices, 6)
    jimpl, timpl = impls
    kw = dict(tile=16, chunk=2, tile_format=fmt, streaming_mode=mode)
    je = j_tiled.TiledExecutor(g, impl=jimpl, **kw)
    te = t_tiled.TiledExecutor(g, impl=timpl, device="cpu", **kw)
    want = je.aggregate(x, op, order=order)
    got = te.aggregate(torch.from_numpy(x), op, order=order)
    assert got.dtype == torch.float32 and got.device.type == "cpu"
    np.testing.assert_array_equal(got.numpy(), want)
    js, ts = _stats(je.stats), _stats(te.stats)
    if timpl == "cuda" and ts["queue_launches"] and op != "max":
        ragged = te._tq.device_bytes()
        padded = je._tq.device_bytes()
        assert ts.pop("queue_h2d_bytes") - ragged == (
            js.pop("queue_h2d_bytes") - padded)
    assert ts == js
    queued = mode == "auto" and fmt == "packed"
    assert (te.stats.queue_launches > 0) == queued
    assert (te.stats.steps == 0) == queued


@pytest.mark.parametrize("op", ["sum", "max", "mean"])
@pytest.mark.parametrize("mode", ["callback", "auto"])
def test_aggregate_with_extraction_matches_reference(op, mode):
    """The fau shape of a layer: extraction on each source interval as it
    streams in (a real-valued graph, so sums are allclose)."""
    g, x = _real_graph()
    w = np.random.default_rng(5).standard_normal((12, 5)).astype(np.float32)
    je = j_tiled.TiledExecutor(g, tile=16, chunk=3, streaming_mode=mode)
    te = t_tiled.TiledExecutor(g, tile=16, chunk=3, streaming_mode=mode,
                               device="cpu")
    wt = torch.from_numpy(w)
    for order in ("column", "row"):
        want = je.aggregate(x, op, order=order,
                            extract_fn=jax.jit(lambda a: a @ w),
                            extract_dim=5)
        got = te.aggregate(x, op, order=order, extract_fn=lambda a: a @ wt,
                           extract_dim=5)
        np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)
    assert _stats(te.stats) == _stats(je.stats)


@pytest.mark.parametrize("double_buffer", [True, False])
def test_stream_map_and_double_buffer_equal_reference(double_buffer):
    g = _int_graph(n=70, e=500, seed=2)
    x = _int_features(70, 4, 2)
    y = _int_features(70, 4, 3)
    je = j_tiled.TiledExecutor(g, tile=16, chunk=2,
                               double_buffer=double_buffer,
                               streaming_mode="callback")
    te = t_tiled.TiledExecutor(g, tile=16, chunk=2,
                               double_buffer=double_buffer,
                               streaming_mode="callback", device="cpu")
    for order in ("column", "row"):
        np.testing.assert_array_equal(
            te.aggregate(x, "sum", order=order).numpy(),
            je.aggregate(x, "sum", order=order))
    want = je.stream_map(jax.jit(lambda a, b: a * 2.0 + b), x, y)
    got = te.stream_map(lambda a, b: a * 2.0 + b, x, torch.from_numpy(y))
    np.testing.assert_array_equal(got.numpy(), want)
    assert _stats(te.stats) == _stats(je.stats)
    assert te.stats.x_reuse_hits > 0


def test_empty_rows_and_a_single_edge():
    g = COOGraph(10, np.array([0], np.int32), np.array([9], np.int32),
                 np.array([2.0], np.float32))
    x = _int_features(10, 4)
    for mode in ("callback", "auto"):
        je = j_tiled.TiledExecutor(g, tile=3, chunk=2, streaming_mode=mode)
        te = t_tiled.TiledExecutor(g, tile=3, chunk=2, streaming_mode=mode,
                                   device="cpu")
        for op in ("sum", "max", "mean"):
            np.testing.assert_array_equal(te.aggregate(x, op).numpy(),
                                          je.aggregate(x, op))


# -- layers, stacks and plans ---------------------------------------------------

def _stacks(model, dims, backend="tiled", fmt="auto", op=None, tile=16,
            budget=None):
    jl = j_models.make_gnn_stack(model, dims, backend=backend, tile=tile)
    tl = rt.make_gnn_stack(model, dims, backend=backend, tile=tile,
                           device="cpu")
    for a, b in zip(jl, tl):
        for cfg in (a.cfg, b.cfg):
            cfg.tile_format = fmt
            cfg.device_budget_bytes = budget
            if op is not None:
                cfg.aggregate_op = op
    jp = j_models.init_stack(jl, jax.random.key(0))
    load_reference_params(tl, [{k: np.asarray(v) for k, v in p.items()}
                               for p in jp])
    return jl, jp, tl


STACKS = [("gcn", [12, 16, 5]), ("gcn", [12, 4]), ("gs_pool", [12, 8, 5]),
          ("grn", [12, 12])]


@pytest.mark.parametrize("fmt", ["dense", "packed"])
@pytest.mark.parametrize("model,dims", STACKS,
                         ids=["gcn-afu-fau", "gcn-fau", "gs_pool", "grn"])
def test_tiled_stack_matches_reference(model, dims, fmt):
    """make_gnn_stack(backend="tiled") -> prepare_graph -> apply_stack:
    GCN afu (the queue) and fau (the callback loop), GS-Pool (max), GRN;
    the result is a CPU float32 tensor equal to the reference's."""
    g, x = _real_graph()
    jl, jp, tl = _stacks(model, dims, fmt=fmt)
    jplan = j_engn.prepare_graph(g, jl[0].cfg)
    want = np.asarray(j_models.apply_stack(jl, jp, jplan, x))
    plan = rt.prepare_graph(g, tl[0].cfg, device="cpu")
    assert plan.backend == "tiled" and plan.streaming_mode == \
        jplan.streaming_mode
    with torch.no_grad():
        got = rt.apply_stack(tl, plan, torch.from_numpy(x))
    assert got.dtype == torch.float32 and got.device.type == "cpu"
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)
    # and the segment reference on the same weights
    seg = j_models.make_gnn_stack(model, dims, backend="segment")
    ref = np.asarray(j_models.apply_stack(
        seg, jp, j_engn.prepare_graph(g, seg[0].cfg), jnp.asarray(x)))
    np.testing.assert_allclose(got.numpy(), ref, rtol=RTOL, atol=ATOL)
    ex = plan.carrier["tiled_exec"]
    jex = jplan.carrier["tiled_exec"]
    assert _stats(ex.stats) == _stats(jex.stats)


@pytest.mark.parametrize("backend,fmt", [("segment", "auto"),
                                         ("blocked", "dense"),
                                         ("blocked", "packed"),
                                         ("fused", "auto"),
                                         ("tiled", "auto")])
def test_budget_spill_plan_equals_reference(backend, fmt):
    """A budget the graph exceeds spills to "tiled" (auto_spill=True) and
    the plan equals the reference's; the spilled stack computes the
    reference's result."""
    g, x = _real_graph()
    jl, jp, tl = _stacks("gcn", [12, 16, 5], backend=backend, fmt=fmt,
                         budget=20_000)
    jplan = j_engn.prepare_graph(g, jl[0].cfg, out_dim=16)
    tplan = rt.prepare_graph(g, tl[0].cfg, out_dim=16, device="cpu")
    assert tplan.backend == jplan.backend == "tiled"
    for attr in ("n", "tile_format", "streaming_mode", "footprint_bytes"):
        assert getattr(tplan, attr) == getattr(jplan, attr), attr
    assert tplan.autotune.as_dict() == jplan.autotune.as_dict()
    tm = {k: v for k, v in tplan.meta.items() if k != "format_choice"}
    jm = {k: v for k, v in jplan.meta.items() if k != "format_choice"}
    assert tm == jm
    assert tplan.meta["trainable"] is True
    assert tplan.device == torch.device("cpu")
    want = np.asarray(j_models.apply_stack(jl, jp, jplan, x))
    with torch.no_grad():
        got = rt.apply_stack(tl, tplan, x).numpy()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


def test_packed_plan_spills_and_raises_like_the_reference():
    """Around the packed blocked plan's threshold, every budget spills,
    stays or raises (without auto_spill) exactly where the reference's
    does."""
    g, _ = _real_graph()
    seen = set()
    for budget in range(20_000, 40_001, 2_000):
        for spill in (True, False):
            outcome = []
            for engn, prep in ((j_engn, j_engn.prepare_graph),
                               (t_engn, lambda g, c: rt.prepare_graph(
                                   g, c, device="cpu"))):
                cfg = engn.EnGNConfig(12, 16, backend="blocked", tile=16,
                                      tile_format="packed",
                                      device_budget_bytes=budget,
                                      auto_spill=spill)
                try:
                    outcome.append(prep(g, cfg).backend)
                except (j_tiled.DeviceBudgetExceeded,
                        t_tiled.DeviceBudgetExceeded):
                    outcome.append("raise")
            assert outcome[0] == outcome[1], (budget, spill)
            seen.add(outcome[1])
    assert seen == {"tiled", "blocked", "raise"}


def test_strict_budget_raises_and_roomy_budget_stays():
    g, _ = _real_graph()
    for backend in ("segment", "blocked", "fused"):
        cfg = t_engn.EnGNConfig(12, 16, backend=backend, tile=16,
                                device_budget_bytes=20_000,
                                auto_spill=False)
        with pytest.raises(t_tiled.DeviceBudgetExceeded, match="auto_spill"):
            rt.prepare_graph(g, cfg, device="cpu")
        cfg.device_budget_bytes = 10 ** 9
        assert rt.prepare_graph(g, cfg, device="cpu").backend == backend


def test_the_executor_defaults_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device works")
    g, _ = _real_graph()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        t_tiled.TiledExecutor(g, tile=16)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        t_engn.prepare_tiled(g, t_engn.EnGNConfig(12, 5, tile=16))


# -- on the card -----------------------------------------------------------------

def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("activation", [None, "relu"])
@pytest.mark.parametrize("f", [3, 5, 50, 64, 70, 128])
def test_chunk_queue_kernel_matches_plain_on_card(activation, f):
    """Every width `lanes_for` maps differently, with the default pieces
    and with every long interval (the hub's first) split in pieces of 64
    entries, whose blocks meet in the scratch and get relu from the last
    piece to arrive."""
    dev = _card()
    g, _ = _real_graph(n=900)
    x = torch.from_numpy(np.random.default_rng(f).standard_normal(
        (900, f)).astype(np.float32)).to(dev)
    packed = t_part.pack_tile_store(t_part.build_tile_store(g, 64))
    built = t_queue.build_tile_queue(packed, device=dev)
    for segment in (t_queue.SEGMENT, 64):
        tq = _with_pieces(built, segment)
        assert (tq.n_split > 0) == (segment == 64)
        before = dict(t_queue.LAUNCHES)
        got = t_queue.tile_queue_aggregate(tq, x, activation=activation)
        want = t_queue.tile_queue_plain(tq, x, activation)
        torch.cuda.synchronize()
        key = "sum_relu" if activation else "sum"
        assert t_queue.LAUNCHES[key] == before[key] + 1
        np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(),
                                   rtol=RTOL, atol=ATOL)


@pytest.mark.cuda
@pytest.mark.parametrize("f", [33, 128])
def test_chunk_queue_tall_tile_on_card(f):
    """A 512-row interval at F = 128 takes passes of 64 features (a
    128-wide block would not fit a CTA's shared memory); at F = 33 one
    pass of the 16-lane mapping."""
    dev = _card()
    g, _ = _real_graph(n=1100)
    x = torch.from_numpy(np.random.default_rng(f).standard_normal(
        (1100, f)).astype(np.float32)).to(dev)
    tq = _with_pieces(t_queue.build_tile_queue(
        t_part.pack_tile_store(t_part.build_tile_store(g, 512)),
        device=dev), 256)
    got = t_queue.tile_queue_aggregate(tq, x, activation="relu")
    want = t_queue.tile_queue_plain(tq, x, "relu")
    torch.cuda.synchronize()
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(),
                               rtol=RTOL, atol=ATOL)


@pytest.mark.cuda
@pytest.mark.parametrize("op", ["sum", "max"])
@pytest.mark.parametrize("c", [1, 8])
def test_tile_part_kernel_matches_plain_on_card(op, c):
    dev = _card()
    g, _ = _real_graph(n=900)
    store = t_part.build_tile_store(g, 64)
    packed = t_part.pack_tile_store(store)
    tiles = store.row_tiles(0)[:c]
    rows, cols, vals = (torch.from_numpy(a).to(dev) for a in packed.pack(
        tiles, c, packed.bucket_of(tiles)))
    xs = torch.from_numpy(np.random.default_rng(c).standard_normal(
        (c, 64, 33)).astype(np.float32)).to(dev)
    before = t_gather.LAUNCHES["tile_part_" + op]
    got = t_gather.packed_tile_part(rows, cols, vals, xs, op=op)
    want = t_gather.packed_tile_part_plain(rows, cols, vals, xs, op=op)
    torch.cuda.synchronize()
    assert t_gather.LAUNCHES["tile_part_" + op] == before + 1
    if op == "max":
        assert torch.equal(got, want)
    else:
        np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(),
                                   rtol=RTOL, atol=ATOL)


@pytest.mark.cuda
@pytest.mark.parametrize("op", ["sum", "max"])
@pytest.mark.parametrize("c", [1, 8])
def test_tile_part_one_huge_tile_on_card(op, c):
    """A chunk holding one hub tile of thousands of entries (spread over
    many 64-slot slices), the rest small or all-pad tiles, ties in the
    max (integer weights and features)."""
    dev = _card()
    n, t = 1024, 64
    rng = np.random.default_rng(c)
    src = np.concatenate([rng.integers(0, n, 3000),
                          rng.integers(0, t, 6000)])
    dst = np.concatenate([rng.integers(0, n, 3000),
                          rng.integers(0, t, 6000)])
    key, val = t_part.merge_by_key(
        dst.astype(np.int64) * n + src,
        rng.integers(1, 3, src.size).astype(np.float32))
    g = COOGraph(n, (key % n).astype(np.int32), (key // n).astype(np.int32),
                 val)
    store = t_part.build_tile_store(g, t)
    packed = t_part.pack_tile_store(store)
    tiles = store.row_tiles(0)[:c]
    assert packed.tile_nnz()[tiles].max() > 1000
    rows, cols, vals = (torch.from_numpy(a).to(dev) for a in packed.pack(
        tiles, c, packed.bucket_of(tiles)))
    xs = torch.from_numpy(rng.integers(-2, 3, (c, t, 33)).astype(
        np.float32)).to(dev)
    before = t_gather.LAUNCHES["tile_part_" + op]
    got = t_gather.packed_tile_part(rows, cols, vals, xs, op=op)
    want = t_gather.packed_tile_part_plain(rows, cols, vals, xs, op=op)
    torch.cuda.synchronize()
    assert t_gather.LAUNCHES["tile_part_" + op] == before + 1
    if op == "max":
        assert torch.equal(got, want)
    else:
        np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(),
                                   rtol=RTOL, atol=ATOL)


@pytest.mark.cuda
@pytest.mark.parametrize("model,dims", STACKS[:3],
                         ids=["gcn-afu-fau", "gcn-fau", "gs_pool"])
def test_tiled_stack_on_card_matches_cpu(model, dims):
    """The default device: a stack built and prepared with no device
    argument streams to the card and matches the CPU run."""
    _card()
    g, x = _real_graph(n=600)
    _, _, cpu = _stacks(model, dims)
    _, _, card = _stacks(model, dims)
    card = [layer.cuda() for layer in card]
    with torch.no_grad():
        want = rt.apply_stack(cpu, rt.prepare_graph(g, cpu[0].cfg,
                                                    device="cpu"), x)
        got = rt.apply_stack(card, rt.prepare_graph(g, card[0].cfg), x)
    assert got.device.type == "cpu"
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=RTOL,
                               atol=ATOL)


@pytest.mark.cuda
@pytest.mark.parametrize("fmt,mode,impl", [
    ("packed", "auto", None), ("packed", "callback", None),
    ("dense", "callback", None), ("dense", "callback", "cuda")])
@pytest.mark.parametrize("op", ["sum", "max", "mean"])
def test_executor_on_card_matches_cpu(fmt, mode, impl, op):
    dev = _card()
    g = _int_graph(n=300, e=3000, seed=3)
    x = _int_features(300, 20, 3)
    kw = dict(tile=32, chunk=4, tile_format=fmt, streaming_mode=mode)
    cpu = t_tiled.TiledExecutor(g, device="cpu", **kw)
    card = t_tiled.TiledExecutor(g, impl=impl, device=dev, **kw)
    for order in ("column", "row"):
        want = cpu.aggregate(x, op, order=order)
        got = card.aggregate(torch.from_numpy(x).to(dev), op, order=order)
        assert got.device.type == "cpu"
        np.testing.assert_array_equal(got.numpy(), want.numpy())
