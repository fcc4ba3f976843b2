"""The port's kernel modules against the reference's dispatchers.

Each plain PyTorch version (what a wrapper runs for CPU tensors, and
what the CUDA kernel is held to on the card) is checked against the JAX
dispatcher with impl="xla" and with impl="pallas" (interpret mode on
the CPU), on ragged feature widths, missing destination intervals and
empty rows.  Max is exactly equal; sums agree to rtol=1e-4, atol=1e-5
(the two frameworks reduce in different orders).  The kernels
themselves run only on a card: the `cuda`-marked tests skip without one.
"""
import _torch_cpu  # noqa: F401  (this worker's share of the cores)
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.fused_engn import ops as j_fused
from repro.kernels.rer_gather import ops as j_gather
from repro.kernels.rer_spmm import ops as j_spmm
from repro_torch.graphs.format import COOGraph, coo_to_blocked
from repro_torch.graphs.generate import rmat_graph
from repro_torch.core.engn import upload_groups
from repro_torch.core.plan import PreparedPlan
from repro_torch.graphs.partition import (build_tile_store, merge_by_key,
                                          pack_tile_store,
                                          transpose_packed_store)
from repro_torch import tracing
from repro_torch.kernels import _build, _common
from repro_torch.kernels.chunk_queue import ops as t_queue
from repro_torch.kernels.feature_update import ops as t_update
from repro_torch.kernels.fused_engn import ops as t_fused
from repro_torch.kernels.rer_gather import ops as t_gather
from repro_torch.kernels.rer_gather_bwd import ops as t_gather_bwd
from repro_torch.kernels.rer_spmm import ops as t_spmm
from repro_torch.kernels.rer_spmm_bwd import ops as t_spmm_bwd

RTOL, ATOL = 1e-4, 1e-5


def _graph(n=100, live=70, e=500, seed=0, merge=False):
    """Edges only among the first `live` vertices: the trailing
    destination intervals are missing and their rows empty.  `merge`
    sums multi-edges up front (the packed store merges in float64, the
    dense tiles in float32, so only a merged graph is bitwise alike)."""
    g = rmat_graph(live, e, seed=seed)
    val = np.random.default_rng(seed + 1).standard_normal(
        g.num_edges).astype(np.float32)
    if merge:
        key, val = merge_by_key(g.dst.astype(np.int64) * n + g.src, val)
        return COOGraph(n, (key % n).astype(np.int32),
                        (key // n).astype(np.int32), val)
    return COOGraph(n, g.src, g.dst, val)


def _hub_graph(n=640, live=560, hub=16, seed=0, integer=False):
    """R-MAT edges among the first `live` vertices (the trailing
    intervals stay empty) plus `hub` rows fed from every live source:
    at T=16 the hub interval's span covers every live interval and its
    tiles hold up to T*T entries.  Multi-edges are merged; `integer`
    weights (1 or 2) make every product and sum exact, so maxima tie."""
    rng = np.random.default_rng(seed)
    g = rmat_graph(live, 6 * live, seed=seed)
    src = np.concatenate([g.src, rng.integers(0, live, hub * live // 2)])
    dst = np.concatenate([g.dst, np.repeat(np.arange(hub), live // 2)])
    val = (rng.integers(1, 3, src.size) if integer
           else rng.standard_normal(src.size)).astype(np.float32)
    key, val = merge_by_key(dst.astype(np.int64) * n + src, val)
    return COOGraph(n, (key % n).astype(np.int32),
                    (key // n).astype(np.int32), val)


def _check(got, want, op):
    got = np.asarray(got)
    want = np.asarray(want)
    if op == "max":
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


# -- rer_spmm -----------------------------------------------------------

@pytest.mark.parametrize("op", ["sum", "max"])
@pytest.mark.parametrize("f", [7, 13])
@pytest.mark.parametrize("tile", [16, 32])
@pytest.mark.parametrize("impl", ["xla", "pallas"])
def test_blocked_spmm_plain_matches_reference(op, f, tile, impl):
    b = coo_to_blocked(_graph(seed=tile + f), tile)
    blocks, brow, bcol = t_spmm.prepare_blocks(b.blocks, b.block_row,
                                               b.block_col, b.q)
    x = np.random.default_rng(f).standard_normal(
        (b.padded_vertices, f)).astype(np.float32)
    want = j_spmm.blocked_spmm(jnp.asarray(blocks), jnp.asarray(brow),
                               jnp.asarray(bcol), jnp.asarray(x), q=b.q,
                               op=op, feature_chunk=8, impl=impl)
    got = t_spmm.blocked_spmm_plain(_t(blocks), _t(brow), _t(bcol), _t(x),
                                    q=b.q, op=op)
    _check(got, want, op)
    # the wrapper takes the plain version for CPU tensors
    _check(t_spmm.blocked_spmm(_t(blocks), _t(brow), _t(bcol), _t(x),
                               q=b.q, op=op), got, "max")


@pytest.mark.parametrize("op", ["sum", "max"])
def test_blocked_spmm_plain_without_pad_tiles(op):
    """The kernel walks tile spans, so an interval with no tiles needs no
    pad tile: without pads the plain version still gives 0 there."""
    b = coo_to_blocked(_graph(), 16)
    blocks, brow, bcol = t_spmm.prepare_blocks(b.blocks, b.block_row,
                                               b.block_col, b.q)
    x = np.random.default_rng(2).standard_normal(
        (b.padded_vertices, 9)).astype(np.float32)
    want = j_spmm.blocked_spmm(jnp.asarray(blocks), jnp.asarray(brow),
                               jnp.asarray(bcol), jnp.asarray(x), q=b.q,
                               op=op, impl="xla")
    got = t_spmm.blocked_spmm_plain(_t(b.blocks), _t(b.block_row),
                                    _t(b.block_col), _t(x), q=b.q, op=op)
    _check(got, want, op)
    assert not np.asarray(got)[80:].any()     # empty rows are 0


def _dense_hub(tile, pads):
    """The hub graph's dense carrier at tile T, with pad tiles for the
    intervals that hold none (pads=True) or without them."""
    b = coo_to_blocked(_hub_graph(), tile)
    arrs = (t_spmm.prepare_blocks(b.blocks, b.block_row, b.block_col, b.q)
            if pads else (b.blocks, b.block_row, b.block_col))
    return b, arrs


@pytest.mark.parametrize("f", [3, 13])
@pytest.mark.parametrize("pads", [False, True])
@pytest.mark.parametrize("tile", [16, 18])
def test_blocked_spmm_t_plain_matches_vjp(f, pads, tile):
    """The sum backward over the forward tiles, dX = A^T G, against
    jax.vjp of the reference's `blocked_spmm_xla`: a hub interval whose
    span (32 to 35 tiles) is longer than PIECE_TILES, intervals that no
    tile names as source and, with pads=False, intervals without a tile
    (with pads=True an all-zero pad tile); T = 18 is not a multiple of 4.
    rtol 1e-5, and an absolute 1e-5 of the largest magnitude (sums of
    hundreds of products taken in another order).  The wrapper takes the
    plain version for CPU tensors."""
    b, arrs = _dense_hub(tile, pads)
    span = np.diff(np.searchsorted(arrs[1], np.arange(b.q + 1)))
    assert span.max() > t_spmm.PIECE_TILES and (span == 0).any() != pads
    g = np.random.default_rng(f + tile).standard_normal(
        (b.padded_vertices, f)).astype(np.float32)
    jarrs = [jnp.asarray(a) for a in arrs]
    _, vjp = jax.vjp(lambda xx: j_spmm.blocked_spmm_xla(*jarrs, xx, q=b.q),
                     jnp.zeros(g.shape, jnp.float32))
    want = np.asarray(vjp(jnp.asarray(g))[0])
    got = t_spmm.blocked_spmm_t_plain(*map(_t, arrs), _t(g), q=b.q).numpy()
    scale = float(np.abs(want).max())
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5 * scale)
    np.testing.assert_array_equal(
        t_spmm.blocked_spmm_t(*map(_t, arrs), _t(g), q=b.q).numpy(), got)


# -- rer_gather -----------------------------------------------------------

def _groups(tile=16, floor=8, seed=0, merge=False):
    ps = pack_tile_store(build_tile_store(_graph(seed=seed, merge=merge),
                                          tile))
    return ps, t_gather.prepare_packed_groups(ps, floor)


@pytest.mark.parametrize("op", ["sum", "max"])
@pytest.mark.parametrize("finish", [True, False])
@pytest.mark.parametrize("f", [5, 12])
@pytest.mark.parametrize("impl", ["xla", "pallas"])
def test_packed_spmm_plain_matches_reference(op, finish, f, impl):
    ps, groups = _groups(seed=f)
    x = np.random.default_rng(f).standard_normal(
        (ps.padded_vertices, f)).astype(np.float32)
    assert len(groups) > 1
    for gr in groups:
        args = (gr.rows, gr.cols, gr.vals, gr.block_row, gr.block_col, x)
        want = j_gather.packed_spmm(*(jnp.asarray(a) for a in args),
                                    q=ps.q, op=op, impl=impl, finish=finish)
        got = t_gather.packed_spmm_plain(*(_t(a) for a in args), q=ps.q,
                                         op=op, finish=finish)
        _check(got, want, op)
        _check(t_gather.packed_spmm(*(_t(a) for a in args), q=ps.q, op=op,
                                    finish=finish), got, "max")


@pytest.mark.parametrize("op", ["sum", "max"])
@pytest.mark.parametrize("finish", [True, False])
def test_packed_flat_plain_matches_reference(op, finish):
    ps, _ = _groups(tile=32)
    gsrc, gdst, gval = t_gather.flat_entries(ps)
    x = np.random.default_rng(4).standard_normal(
        (ps.padded_vertices, 11)).astype(np.float32)
    n = ps.padded_vertices
    want = j_gather.packed_flat_xla(jnp.asarray(gsrc), jnp.asarray(gdst),
                                    jnp.asarray(gval), jnp.asarray(x), n=n,
                                    op=op, finish=finish)
    got = t_gather.packed_flat_plain(_t(gsrc), _t(gdst), _t(gval), _t(x),
                                     n=n, op=op, finish=finish)
    _check(got, want, op)


@pytest.mark.parametrize("op", ["sum", "max"])
def test_packed_groups_merge_to_the_dense_aggregate(op):
    """Merging the bucket groups' raw partials (as `_aggregate` does on
    CUDA) gives the dense-tile aggregate of the same graph."""
    g = _graph(seed=5, merge=True)
    ps, groups = _groups(seed=5, merge=True)
    x = _t(np.random.default_rng(5).standard_normal(
        (ps.padded_vertices, 6)).astype(np.float32))
    y = None
    for gr in groups:
        part = t_gather.packed_spmm_plain(
            _t(gr.rows), _t(gr.cols), _t(gr.vals), _t(gr.block_row),
            _t(gr.block_col), x, q=ps.q, op=op, finish=False)
        y = part if y is None else (y + part if op == "sum"
                                    else torch.maximum(y, part))
    y = torch.where(torch.isneginf(y), 0.0, y)
    b = coo_to_blocked(g, 16)
    want = t_spmm.blocked_spmm_plain(_t(b.blocks), _t(b.block_row),
                                     _t(b.block_col), x, q=b.q, op=op)
    _check(y, want, op)


# -- the kernels' host tables ------------------------------------------------

@pytest.mark.parametrize("piece", [1, 3, 16])
def test_span_pieces_cover_each_span_once(piece):
    """rer_spmm's pieces: each interval's span cut into ceil(span /
    piece) consecutive pieces of at most `piece` tiles, in interval
    order; Y is filled first when an interval is split or empty."""
    b = coo_to_blocked(_hub_graph(), 16)
    ptr = np.searchsorted(b.block_row, np.arange(b.q + 1))
    table, fill = t_spmm.span_pieces(ptr, piece)
    assert (np.diff(table[:, 0]) >= 0).all()
    for i in range(b.q):
        own = table[table[:, 0] == i]
        span = ptr[i + 1] - ptr[i]
        assert len(own) == -(-span // piece)
        if span:
            assert own[0, 1] == ptr[i] and own[-1, 2] == ptr[i + 1]
            assert (own[1:, 1] == own[:-1, 2]).all()
            assert (own[:, 2] - own[:, 1] <= piece).all()
            assert (own[:, 2] > own[:, 1]).all()
            assert (own[:, 3] == (len(own) > 1)).all()
    assert fill                          # trailing intervals are empty
    assert (table[:, 3] == 1).any() == (np.diff(ptr).max() > piece)
    full = np.arange(0, 4 * b.q + 1, 4)  # every span 4 tiles, none split
    assert not t_spmm.span_pieces(full, 4)[1]


@pytest.mark.parametrize("hub", [False, True])
def test_column_table_covers_each_tile_once(hub):
    """fused_engn's walk: `order` is the carrier's tiles in column
    order, the tiles of one source interval in the carrier's own order;
    the pieces cover every position of `order` exactly once, each piece
    within one source interval's column span and at most PIECE_TILES
    long; the hub graph's long column spans are split, the small
    graph's are not."""
    g = _hub_graph() if hub else _graph()
    b = coo_to_blocked(g, 16)
    blocks, brow, bcol = t_spmm.prepare_blocks(b.blocks, b.block_row,
                                               b.block_col, b.q)
    order, pieces = t_fused.column_order(bcol, b.q)
    assert order.dtype == np.int32 and pieces.dtype == np.int32
    np.testing.assert_array_equal(np.sort(order), np.arange(bcol.size))
    key = bcol[order].astype(np.int64) * bcol.size + order
    assert (np.diff(key) > 0).all()       # by column, then carrier order
    seen = np.zeros(order.size, np.int64)
    for j, lo, hi, split in pieces.tolist():
        assert 0 < hi - lo <= t_spmm.PIECE_TILES
        assert (bcol[order[lo:hi]] == j).all()
        assert split == (np.count_nonzero(bcol == j) > t_spmm.PIECE_TILES)
        seen[lo:hi] += 1
    np.testing.assert_array_equal(seen, 1)
    assert (np.diff(pieces[:, 0]) >= 0).all()
    assert pieces[:, 3].any() == hub
    table = t_fused.column_table(bcol, b.q, torch.device("cpu"))
    np.testing.assert_array_equal(table.order.numpy(), order)
    np.testing.assert_array_equal(table.pieces.numpy(), pieces)
    assert table.nbytes == order.nbytes + pieces.nbytes


@pytest.mark.parametrize("tile", [16, 18])
def test_row_counts_equal_the_tile_store(tile):
    """rer_spmm_bwd's slab counts: the nonzeros of each destination row
    over its interval's dense tiles equal a count of the packed tile
    store's entries, so do the per-slab sums for every R, and the R the
    kernel gets is the largest whose fullest slab fits the list."""
    g = _hub_graph()
    b = coo_to_blocked(g, tile)
    counts = t_spmm_bwd.row_counts(b.blocks, b.block_row, b.q)
    gsrc, gdst, gval = t_gather.flat_entries(
        pack_tile_store(build_tile_store(g, tile)))
    want = np.bincount(gdst[gval != 0], minlength=b.padded_vertices)
    assert counts.dtype == np.int32
    np.testing.assert_array_equal(counts, want)
    for rows in (1, 2, 4, 8, 16):
        per = np.add.reduceat(want.reshape(b.q, tile),
                              np.arange(0, tile, rows), axis=1)
        assert t_spmm_bwd.slab_max(counts, tile, rows) == per.max()
    assert t_spmm_bwd.slab_rows(counts, tile) == 16   # 3,816 fit the list
    up = t_spmm_bwd.upload_row_counts(b.blocks, b.block_row, b.q,
                                      torch.device("cpu"))
    np.testing.assert_array_equal(up.dev.numpy(), counts)
    assert up.rows == 16 and up.nbytes == counts.nbytes
    cap = t_spmm_bwd.LIST_CAP
    dense_hub = np.zeros(4 * 16, np.int32)
    dense_hub[16:32] = cap // 12          # 16 rows over the list, 8 not
    assert t_spmm_bwd.slab_rows(dense_hub, 16) == 8
    star = np.zeros(4 * 16, np.int32)
    star[5] = cap + 1                     # one row over the list
    assert t_spmm_bwd.slab_rows(star, 16) == 1
    assert t_spmm_bwd.slab_rows(np.zeros(4 * 256, np.int32), 256) == 16


@pytest.mark.parametrize("transposed", [False, True])
@pytest.mark.parametrize("seg", [8, t_gather.SEG_ENTRIES])
def test_work_table_covers_each_real_entry_once(transposed, seg):
    """rer_gather's work table over bucket groups, forward and A^T: every
    real entry of the PackedTileStore is covered exactly once, no pad
    slot is, each segment holds at most `seg` entries, pieces run in
    destination order, and the hub tiles are cut across segments."""
    ps = pack_tile_store(build_tile_store(_hub_graph(), 16))
    store = transpose_packed_store(ps) if transposed else ps
    groups = t_gather.prepare_packed_groups(store)
    counts = [t_gather.real_counts(_t(gr.rows), _t(gr.cols),
                                   _t(gr.vals)).numpy() for gr in groups]
    assert sum(int(c.sum()) for c in counts) == store.nnz
    pieces, seg_ptr, poff = t_gather.work_table(
        counts, [gr.block_row for gr in groups],
        [gr.block_col for gr in groups], seg)
    seen = [np.zeros(gr.rows.shape, np.int64) for gr in groups]
    for grp, k, lo, hi, dst, src in pieces.tolist():
        gr = groups[grp]
        assert 0 <= lo < hi <= counts[grp][k] and hi - lo <= seg
        assert (dst, src) == (gr.block_row[k], gr.block_col[k])
        seen[grp][k, lo:hi] += 1
    t = store.tile
    got = []
    for gr, hit in zip(groups, seen):
        assert hit.max() <= 1
        k, e = np.nonzero(hit)
        got.append(np.stack([gr.block_col[k].astype(np.int64) * t
                             + gr.cols[k, e],
                             gr.block_row[k].astype(np.int64) * t
                             + gr.rows[k, e],
                             gr.vals[k, e].view(np.int32)], axis=1))
    got = np.concatenate(got)
    gsrc, gdst, gval = t_gather.flat_entries(store)
    want = np.stack([gsrc, gdst, gval.view(np.int32)], axis=1).astype(
        np.int64)
    assert got.shape == want.shape       # no pad slot, no entry missed
    np.testing.assert_array_equal(got[np.lexsort(got.T[::-1])],
                                  want[np.lexsort(want.T[::-1])])
    assert (np.diff(pieces[:, 4]) >= 0).all()
    assert seg_ptr[0] == 0 and seg_ptr[-1] == len(pieces)
    assert (np.diff(seg_ptr) > 0).all()
    size = pieces[:, 3] - pieces[:, 2]
    assert (np.add.reduceat(size, seg_ptr[:-1]) <= seg).all()
    for a, b in zip(seg_ptr[:-1], seg_ptr[1:]):   # one run of entries each
        assert poff[a] == 0
        np.testing.assert_array_equal(poff[a + 1:b],
                                      np.cumsum(size[a:b])[:-1])
    tiles = pieces[:, 0].astype(np.int64) * 1_000_000 + pieces[:, 1]
    assert np.unique(tiles, return_counts=True)[1].max() > 1


@pytest.mark.parametrize("transposed", [False, True])
def test_plan_groups_carry_the_table_a_read_back_builds(transposed):
    """A plan's groups carry the work table built from the host arrays
    as they are uploaded: the one a launch of a plain list of the same
    groups builds from the real counts read back.  A launch holds the
    table to x's grid."""
    ps = pack_tile_store(build_tile_store(_hub_graph(), 16))
    store = transpose_packed_store(ps) if transposed else ps
    cpu = torch.device("cpu")
    plan = upload_groups(t_gather.prepare_packed_groups(store), cpu)
    assert isinstance(plan, t_gather.PlanGroups)
    assert t_gather.groups_work(plan, store.q, store.tile, cpu) is plan.work
    built = t_gather.groups_work(list(plan), store.q, store.tile, cpu)
    for k in ("gtab", "pieces", "poff", "seg_ptr"):
        assert torch.equal(getattr(plan.work, k), getattr(built, k)), k
    assert plan.work.n_seg == built.n_seg
    assert plan.work.q <= store.q and plan.work.t <= store.tile
    with pytest.raises(ValueError, match="intervals"):
        t_gather.groups_work(plan, plan.work.q - 1, store.tile, cpu)


def _source_case(g, piece=None, dev=torch.device("cpu")):
    """A plan's groups on `dev` with B2^T's source table: the plan's own
    (pieces of `source_piece` entries) or, with `piece`, one rebuilt at
    that size; (store, host groups, plan groups, real counts)."""
    store = pack_tile_store(build_tile_store(g, 16))
    host = t_gather.prepare_packed_groups(store)
    plan = upload_groups(host, dev, source=True)
    counts = [t_gather.real_counts(_t(gr.rows), _t(gr.cols),
                                   _t(gr.vals)).numpy() for gr in host]
    if piece is not None:
        plan.source = t_gather._build_source(
            counts, [gr.block_row for gr in host],
            [gr.block_col for gr in host], plan.source.q, dev, piece)
    return store, host, plan, counts


@pytest.mark.parametrize("hub", [False, True])
@pytest.mark.parametrize("piece", [64, None])
def test_source_table_covers_each_real_entry_once(hub, piece):
    """B2^T's source-order table over the bucket groups: the entries of
    its pieces, found as the kernel finds them (an offset's tile by the
    staged offsets, slot tile * S + offset - ptr[tile]), are every real
    entry of the work table exactly once; a piece lies within one source
    interval, within its span of tiles, and holds at most a piece's
    entries; an interval with no entry keeps one empty piece; the split
    flags are the intervals with more entries than a piece (at the
    plan's size the hub graph's hub intervals, none of the small
    graph's), and the zero span runs from the first split interval to
    the last.  Tiles run by (source, destination), pieces longest
    first; the table copies no entry."""
    store, host, plan, counts = _source_case(
        _hub_graph() if hub else _graph(), piece)
    src = plan.source
    pieces, ptr, tiles = (a.numpy() for a in (src.pieces, src.ptr,
                                              src.tiles))
    size = piece or src.piece
    t = store.tile
    assert src.entries == store.nnz == ptr[-1]
    assert src.piece == (pieces[:, 2] - pieces[:, 1]).max() <= size
    assert src.tiles_max == (pieces[:, 5] - pieces[:, 4]).max()
    assert tiles.shape == (ptr.size - 1, 3)       # per tile, not per entry
    tsrc = np.array([host[gi].block_col[k] for gi, k, _ in tiles.tolist()])
    np.testing.assert_array_equal(np.lexsort((tiles[:, 2], tsrc)),
                                  np.arange(tiles.shape[0]))
    per = np.zeros(store.q, np.int64)
    npieces = np.zeros(store.q, np.int64)
    got = []
    for s, lo, hi, split, first, end in pieces.tolist():
        per[s] += hi - lo
        npieces[s] += 1
        assert 0 <= lo <= hi and hi - lo <= size
        if hi == lo:
            assert first == end
            continue
        assert first < end and ptr[first] <= lo < ptr[first + 1]
        assert ptr[end - 1] < hi <= ptr[end]
        for e in range(lo, hi):
            j = int(np.searchsorted(ptr[first:end + 1], e, "right")) - 1
            gi, k, dst = tiles[first + j]
            gr, slot = host[gi], e - ptr[first + j]
            assert (gr.block_col[k], gr.block_row[k]) == (s, dst)
            assert slot < counts[gi][k]
            got.append((s * t + gr.cols[k, slot], dst * t + gr.rows[k, slot],
                        gr.vals[k, slot].view(np.int32)))
    assert (np.diff(pieces[:, 2] - pieces[:, 1]) <= 0).all()
    got = np.asarray(got, np.int64)
    gsrc, gdst, gval = t_gather.flat_entries(store)
    want = np.stack([gsrc, gdst, gval.view(np.int32)], axis=1).astype(
        np.int64)
    assert got.shape == want.shape           # no pad slot, no entry missed
    np.testing.assert_array_equal(got[np.lexsort(got.T[::-1])],
                                  want[np.lexsort(want.T[::-1])])
    assert (npieces >= 1).all()
    assert (npieces[per == 0] == 1).all()
    split = per > size
    for s, *_, sp, _, _ in pieces.tolist():
        assert sp == split[s]
    assert (npieces > 1).tolist() == split.tolist()
    if piece is None:
        assert split.any() == hub
        if hub:
            assert split[0]                   # the hub rows' interval
    hit = np.flatnonzero(split)
    assert src.zero == ((hit[0], hit[-1] + 1) if hit.size else (0, 0))


def test_plan_holds_the_source_table_only_where_asked():
    """A sum plan's groups hold B2^T's table beside the work table, and
    `held_bytes` counts it; groups uploaded without it (a max plan's)
    hold none.  It is per tile and per piece: well under the groups'
    own bytes."""
    store = pack_tile_store(build_tile_store(_hub_graph(), 16))
    host = t_gather.prepare_packed_groups(store)
    cpu = torch.device("cpu")
    sums = upload_groups(host, cpu, source=True)
    maxs = upload_groups(host, cpu)
    assert maxs.source is None and sums.source is not None
    table = sum(a.numel() * a.element_size()
                for a in (sums.source.pieces, sums.source.ptr,
                          sums.source.tiles))
    held = [PreparedPlan("blocked", store.num_vertices,
                         {"packed_groups": p}).held_bytes()
            for p in (sums, maxs)]
    assert held[0] - held[1] == table > 0
    assert table < sum(gr.nbytes() for gr in host) / 4


# -- fused_engn -----------------------------------------------------------

@pytest.mark.parametrize("f,h", [(12, 6), (20, 7), (8, 24)])
@pytest.mark.parametrize("impl", ["xla", "pallas"])
def test_fused_engn_plain_matches_reference(f, h, impl):
    b = coo_to_blocked(_graph(seed=f), 16)
    blocks, brow, bcol = t_spmm.prepare_blocks(b.blocks, b.block_row,
                                               b.block_col, b.q)
    rng = np.random.default_rng(h)
    x = rng.standard_normal((b.padded_vertices, f)).astype(np.float32)
    w = (rng.standard_normal((f, h)) * 0.2).astype(np.float32)
    want = j_fused.fused_engn_layer(jnp.asarray(blocks), jnp.asarray(brow),
                                    jnp.asarray(bcol), jnp.asarray(x),
                                    jnp.asarray(w), q=b.q, h_chunk=8,
                                    impl=impl)
    got = t_fused.fused_engn_plain(_t(blocks), _t(brow), _t(bcol), _t(x),
                                   _t(w), q=b.q)
    _check(got, want, "sum")
    _check(t_fused.fused_engn_layer(_t(blocks), _t(brow), _t(bcol), _t(x),
                                    _t(w), q=b.q), got, "max")


# -- what the wrappers share -----------------------------------------------

def test_tile_ptr_spans_and_memo():
    brow = torch.tensor([0, 0, 2, 2, 2, 4], dtype=torch.int32)
    ptr = _common.tile_ptr(brow, 6)
    assert ptr.tolist() == np.searchsorted(brow.numpy(),
                                           np.arange(7)).tolist()
    assert _common.tile_ptr(brow, 6) is ptr          # checked once
    brow[5] = 5                                      # in place: re-derived
    assert _common.tile_ptr(brow, 6).tolist()[-2:] == [5, 6]
    with pytest.raises(ValueError, match="non-decreasing"):
        _common.tile_ptr(torch.tensor([1, 0], dtype=torch.int32), 2)
    with pytest.raises(ValueError, match="outside"):
        _common.tile_ptr(torch.tensor([0, 3], dtype=torch.int32), 2)


def test_check_range_is_checked_once_per_carrier():
    cols = torch.tensor([[0, 5], [3, 1]], dtype=torch.int32)
    _common.check_range(cols, 6, "cols")
    assert ("range", 6) in _common._memo(cols)
    with pytest.raises(ValueError, match=r"cols holds values outside \[0, 5\)"):
        _common.check_range(cols, 5, "cols")
    cols[0, 1] = -1                                  # in place: re-checked
    with pytest.raises(ValueError, match="outside"):
        _common.check_range(cols, 6, "cols")


def test_check_tensor_rejects_bad_arguments():
    cpu = torch.device("cpu")
    good = torch.zeros((4, 3))
    _common.check_tensor(good, "x", torch.float32, cpu, 2)
    with pytest.raises(TypeError):
        _common.check_tensor(good.int(), "x", torch.float32, cpu, 2)
    with pytest.raises(ValueError, match="contiguous"):
        _common.check_tensor(good.t(), "x", torch.float32, cpu, 2)
    with pytest.raises(ValueError, match="2-D"):
        _common.check_tensor(good[0], "x", torch.float32, cpu, 2)
    with pytest.raises(ValueError, match="meta"):
        _common.check_tensor(good, "x", torch.float32, torch.device("meta"),
                             2)
    with pytest.raises(NotImplementedError, match="k has no backward; run"):
        _common.refuse_grad("k", torch.zeros(2, requires_grad=True),
                            why="has no backward")
    with torch.no_grad():
        _common.refuse_grad("k", torch.zeros(2, requires_grad=True),
                            why="has no backward")
    # the refusals that remain: B4 is forward only (its reference is an
    # entry point), and B5's relu epilogue has no backward
    with pytest.raises(NotImplementedError, match="forward only"):
        t_update.fused_linear_act(torch.zeros((2, 3), requires_grad=True),
                                  torch.zeros((3, 2)))
    tq = t_queue.build_tile_queue(
        pack_tile_store(build_tile_store(_graph(), 16)), device="cpu")
    with pytest.raises(NotImplementedError, match="relu epilogue"):
        t_queue.tile_queue_aggregate(
            tq, torch.zeros((tq.n, 3), requires_grad=True),
            activation="relu")


def test_wrappers_refuse_other_devices():
    x = torch.zeros((32, 4), device="meta")
    with pytest.raises(ValueError, match="no rer_spmm"):
        t_spmm.blocked_spmm(None, None, None, x, q=2)
    with pytest.raises(ValueError, match="no rer_gather"):
        t_gather.packed_spmm(None, None, None, None, None, x, q=2)
    with pytest.raises(ValueError, match="no fused_engn"):
        t_fused.fused_engn_layer(None, None, None, x, None, q=2)


def test_build_dir_is_keyed_by_the_sources():
    d = _build.build_dir()
    assert d == _build.build_dir()
    assert d.parent == _build.BUILD_ROOT
    assert d.parent.parts[-2:] == ("build", "repro_torch")
    assert sorted(p.stem for p in _build.CSRC.glob("*.cu")) == sorted(
        _build.KERNELS)


# -- on the card -----------------------------------------------------------

def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("op", ["sum", "max"])
@pytest.mark.parametrize("f", [3, 20, 32])
def test_rer_spmm_kernel_matches_plain_on_card(op, f):
    dev = _card()
    b = coo_to_blocked(_graph(seed=f), 32)
    x = torch.randn((b.padded_vertices, f), device=dev)
    args = [_t(a).to(dev) for a in (b.blocks, b.block_row, b.block_col)]
    got = t_spmm.blocked_spmm(*args, x, q=b.q, op=op)
    want = t_spmm.blocked_spmm_plain(*args, x, q=b.q, op=op)
    _check(got.cpu(), want.cpu(), op)


@pytest.mark.cuda
@pytest.mark.parametrize("op", ["sum", "max"])
@pytest.mark.parametrize("finish", [True, False])
def test_rer_gather_kernel_matches_plain_on_card(op, finish):
    dev = _card()
    ps, groups = _groups(tile=32)
    x = torch.randn((ps.padded_vertices, 20), device=dev)
    for gr in groups:
        args = [_t(a).to(dev) for a in (gr.rows, gr.cols, gr.vals,
                                        gr.block_row, gr.block_col)]
        got = t_gather.packed_spmm(*args, x, q=ps.q, op=op, finish=finish)
        want = t_gather.packed_spmm_plain(*args, x, q=ps.q, op=op,
                                          finish=finish)
        _check(got.cpu(), want.cpu(), op)


def _check_hub(got, want, op):
    """The hub cases' outputs reach magnitudes of ~100 (hub rows sum
    hundreds of products), where fp32 rounding of a sum taken in another
    order is ~1e-7 of the magnitude: sums are held to rtol=1e-4 with an
    absolute tolerance of 1e-5 times the output's largest magnitude (the
    smoke's convention for its training-shape sums); max stays exact."""
    got, want = np.asarray(got), np.asarray(want)
    if op == "max":
        np.testing.assert_array_equal(got, want)
    else:
        scale = max(1.0, float(np.abs(want).max()))
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL * scale)


def _hub_x(rows, f, op, seed):
    """Features for the hub cases: integer-valued for max (products tie
    within and across pieces and segments), normal for sum."""
    rng = np.random.default_rng(seed)
    x = (rng.integers(-2, 3, (rows, f)) if op == "max"
         else rng.standard_normal((rows, f)))
    return x.astype(np.float32)


@pytest.mark.cuda
@pytest.mark.parametrize("op", ["sum", "max"])
@pytest.mark.parametrize("f", [3, 64, 100])
@pytest.mark.parametrize("pads", [False, True])
@pytest.mark.parametrize("tile", [16, 18])
def test_rer_spmm_split_spans_on_card(op, f, pads, tile):
    """A hub interval whose 32- to 35-tile span is cut into pieces merged
    by atomics, intervals with no tile (pads=False) or with an all-zero
    pad tile (pads=True), ties straddling the pieces; T = 18 takes the
    4-byte copies (a tile row is not a multiple of 16 bytes)."""
    dev = _card()
    b = coo_to_blocked(_hub_graph(integer=op == "max"), tile)
    arrs = (t_spmm.prepare_blocks(b.blocks, b.block_row, b.block_col, b.q)
            if pads else (b.blocks, b.block_row, b.block_col))
    args = [_t(a).to(dev) for a in arrs]
    assert (t_spmm._pieces(args[1], b.q)[0][:, 3] == 1).any()
    x = _t(_hub_x(b.padded_vertices, f, op, f)).to(dev)
    before = t_spmm.LAUNCHES[op]
    got = t_spmm.blocked_spmm(*args, x, q=b.q, op=op)
    want = t_spmm.blocked_spmm_plain(*args, x, q=b.q, op=op)
    torch.cuda.synchronize()
    assert t_spmm.LAUNCHES[op] == before + 1
    _check_hub(got.cpu(), want.cpu(), op)


@pytest.mark.cuda
@pytest.mark.parametrize("f", [3, 64, 100])
@pytest.mark.parametrize("pads", [False, True])
@pytest.mark.parametrize("tile", [16, 18])
def test_rer_spmm_t_split_spans_on_card(f, pads, tile):
    """B1^T, dX = A^T G over the forward tiles, on the hub graph: a
    32- to 35-tile span cut into pieces, intervals with no tile or an
    all-zero pad tile, intervals no tile names as source; F = 3 takes
    scalar atomics, 64 and 100 float4 ones; T = 18 the 4-byte copies.
    One launch a call, within 1e-5 of the largest magnitude."""
    dev = _card()
    b, arrs = _dense_hub(tile, pads)
    args = [_t(a).to(dev) for a in arrs]
    assert (t_spmm._pieces(args[1], b.q)[0][:, 3] == 1).any()
    g = _t(_hub_x(b.padded_vertices, f, "sum", f + 1)).to(dev)
    before = t_spmm.LAUNCHES["sum_t"]
    got = t_spmm.blocked_spmm_t(*args, g, q=b.q)
    want = t_spmm.blocked_spmm_t_plain(*args, g, q=b.q)
    torch.cuda.synchronize()
    assert t_spmm.LAUNCHES["sum_t"] == before + 1
    scale = float(want.abs().max())
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(),
                               rtol=1e-5, atol=1e-5 * scale)


def _hub_groups(dev, transposed=False, integer=False):
    ps = pack_tile_store(build_tile_store(_hub_graph(integer=integer), 16))
    store = transpose_packed_store(ps) if transposed else ps
    groups = upload_groups(t_gather.prepare_packed_groups(store), dev)
    flat = [_t(a).to(dev) for a in t_gather.flat_entries(store)]
    return store, groups, flat


@pytest.mark.cuda
@pytest.mark.parametrize("op", ["sum", "max"])
@pytest.mark.parametrize("f", [3, 64, 100])
@pytest.mark.parametrize("transposed", [False, True])
def test_rer_gather_one_launch_per_aggregate_on_card(op, f, transposed):
    """Every bucket group in one launch: hub tiles of up to 256 entries
    cut across segments, all-pad tiles, empty intervals, ties straddling
    the segments; the store's groups and the transposed store's (whose
    entries come in (col, row) order)."""
    dev = _card()
    store, groups, flat = _hub_groups(dev, transposed, op == "max")
    assert len(groups) > 1
    x = _t(_hub_x(store.padded_vertices, f, op, f)).to(dev)
    before = dict(t_gather.LAUNCHES)
    got = t_gather.packed_groups_spmm(groups, x, q=store.q, op=op)
    want = t_gather.packed_flat_plain(*flat, x, n=x.shape[0], op=op)
    torch.cuda.synchronize()
    assert t_gather.LAUNCHES[op] == before[op] + 1
    assert sum(t_gather.LAUNCHES.values()) == sum(before.values()) + 1
    _check_hub(got.cpu(), want.cpu(), op)


@pytest.mark.cuda
@pytest.mark.parametrize("op", ["sum", "max"])
@pytest.mark.parametrize("f", [3, 64, 100])
def test_rer_gather_bwd_one_launch_per_aggregate_on_card(op, f):
    """The packed backward over the forward groups' work table, on the
    hub graph, whose hub rows are split across segments and bucket
    groups: the sum's A^T G in one launch; the max's words (equal to
    the plain ones) and each pass of its backward in one launch, with
    integer-valued x and weights, so maxima tie across segments and
    groups."""
    dev = _card()
    store, groups, flat = _hub_groups(dev, integer=op == "max")
    assert len(groups) > 1
    n = store.padded_vertices
    x = _t(_hub_x(n, f, op, f)).to(dev)
    g = _t(_hub_x(n, f, "sum", f + 7)).to(dev)
    before = {**{"rer_gather_" + k: v for k, v in t_gather.LAUNCHES.items()},
              **{"bwd_" + k: v for k, v in t_gather_bwd.LAUNCHES.items()}}
    if op == "sum":
        got = t_gather_bwd.packed_groups_t(groups, g, q=store.q)
        want = t_gather_bwd.packed_groups_t_plain(groups, g, q=store.q)
        torch.cuda.synchronize()
        assert t_gather.LAUNCHES["sum_t"] == before["rer_gather_sum_t"] + 1
    else:
        y = t_gather.packed_flat_plain(*flat, x, n=n, op="max")
        words = t_gather_bwd.packed_max_words(groups, x, y, q=store.q)
        assert torch.equal(words, t_gather_bwd.packed_max_words_plain(
            groups, x, y, q=store.q))
        cnt = t_gather_bwd.packed_max_count_plain(groups, x, y, q=store.q)
        assert int(cnt.max()) > 1                       # ties
        got = t_gather_bwd.packed_max_backward(groups, x, y, g, q=store.q)
        want = t_gather_bwd.packed_max_scatter_plain(groups, x, y, g, cnt,
                                                     q=store.q)
        torch.cuda.synchronize()
        assert t_gather_bwd.LAUNCHES["count"] == before["bwd_count"] + 2
        assert t_gather_bwd.LAUNCHES["resolve"] == before["bwd_resolve"] + 1
        assert t_gather_bwd.LAUNCHES["max"] == before["bwd_max"] + 1
    after = sum(t_gather.LAUNCHES.values()) + sum(
        t_gather_bwd.LAUNCHES.values())
    assert after == sum(before.values()) + (1 if op == "sum" else 4)
    scale = float(want.abs().max())
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(),
                               rtol=1e-5, atol=1e-5 * scale)


@pytest.mark.cuda
@pytest.mark.parametrize("f", [1, 3, 41, 64, 128, 256])
def test_rer_gather_bwd_sum_source_stationary_on_card(f):
    """B2^T over a plan's source table against the plain version at every
    lane mapping (F = 1 and 3: a lane a feature; 41 and 64: sixteen lanes
    of four; 128: thirty-two of four; 256: two passes; 41 and a g off
    16-byte alignment: one float at a time): on the hub graph at pieces
    of 64 entries (most intervals split) and at the plan's own (the hub
    intervals split), and on the small graph (none split).  The empty
    source intervals' dX rows are exactly 0; each call is one launch;
    under a profiler the kernel's merged rows equal the table's count,
    and the entries the store's."""
    dev = _card()
    cpu_prof = [torch.profiler.ProfilerActivity.CPU]
    for graph, piece, splits in ((_hub_graph(), 64, True),
                                 (_hub_graph(), None, True),
                                 (_graph(), None, False)):
        store, _, groups, _ = _source_case(graph, piece, dev)
        src = groups.source
        n, t = store.padded_vertices, store.tile
        pieces = src.pieces.cpu().numpy()
        empty = np.ones(store.q, bool)
        empty[pieces[pieces[:, 2] > pieces[:, 1], 0]] = False
        assert empty.any()
        rows = torch.from_numpy(np.repeat(empty, t)).to(dev)
        gg = _t(_hub_x(n, f, "sum", f + 7)).to(dev)
        off = torch.empty(n * f + 1, device=dev)[1:].view(n, f).copy_(gg)
        want = t_gather_bwd.packed_groups_t_plain(groups, gg, q=store.q)
        merged = t_gather_bwd.source_merged_rows(src, groups, t)
        assert bool(pieces[:, 3].any()) == (merged > 0) == splits
        for g in (gg, off):
            before = t_gather.LAUNCHES["sum_t"]
            tracing.reset()
            with torch.profiler.profile(activities=cpu_prof):
                got = t_gather_bwd.packed_groups_t(groups, g, q=store.q)
            rep = tracing.report()
            assert t_gather.LAUNCHES["sum_t"] == before + 1
            _check_hub(got.cpu(), want.cpu(), "sum")
            assert (got[rows] == 0).all()
            assert rep["sum_t.entries"]["calls"] == store.nnz
            assert rep.get("sum_t.merged_rows",
                           {"calls": 0})["calls"] == merged
        tracing.reset()


@pytest.mark.cuda
def test_card_sum_plan_holds_the_source_table():
    """On a card `prepare_graph` gives a packed sum plan's groups B2^T's
    table and a max plan's none (its backward walks the work table)."""
    import dataclasses
    import repro_torch as rt
    dev = _card()
    layers = rt.make_gnn_stack("gcn", [8, 4], backend="blocked", tile=16,
                               device=dev)
    cfg = dataclasses.replace(layers[0].cfg, tile_format="packed")
    sums = rt.prepare_graph(_hub_graph(), cfg, device=dev)
    maxs = rt.prepare_graph(_hub_graph(), dataclasses.replace(
        cfg, aggregate_op="max"), device=dev)
    assert sums.carrier["packed_groups"].source is not None
    assert maxs.carrier["packed_groups"].source is None


@pytest.mark.cuda
@pytest.mark.parametrize("op", ["sum", "max"])
def test_rer_gather_raw_group_keeps_neg_inf_on_card(op):
    """The single-group raw form with finish=False: uncovered max rows
    stay -inf, so partials still merge by maximum."""
    dev = _card()
    store, groups, _ = _hub_groups(dev, integer=op == "max")
    x = _t(_hub_x(store.padded_vertices, 64, op, 3)).to(dev)
    for gr in groups:
        args = [gr[k] for k in ("rows", "cols", "vals", "block_row",
                                "block_col")]
        got = t_gather.packed_spmm(*args, x, q=store.q, op=op, finish=False)
        want = t_gather.packed_spmm_plain(*args, x, q=store.q, op=op,
                                          finish=False)
        if op == "max":
            assert torch.isneginf(want).any()
            assert torch.equal(got, want)
        else:
            _check_hub(got.cpu(), want.cpu(), op)


def _star_graph(hubs, fan, seed=0):
    """`hubs` destination rows (0, 1, ..) each fed from sources 0 ..
    fan-1, over R-MAT edges among the first 200 vertices; integer
    weights (1 or 2, merged), so products tie within and across tiles."""
    n = fan + 16
    rng = np.random.default_rng(seed)
    bg = rmat_graph(200, 1200, seed=seed)
    src = np.concatenate([bg.src, np.tile(np.arange(fan), hubs)])
    dst = np.concatenate([bg.dst, np.repeat(np.arange(hubs), fan)])
    val = rng.integers(1, 3, src.size).astype(np.float32)
    key, val = merge_by_key(dst.astype(np.int64) * n + src, val)
    return COOGraph(n, (key % n).astype(np.int32),
                    (key // n).astype(np.int32), val)


@pytest.mark.cuda
@pytest.mark.parametrize("fmt", ["dense", "packed"])
def test_max_backward_after_split_forward_on_card(fmt):
    """The max backward kernels read only the finished forward output:
    after a forward whose ties straddle pieces (dense) or segments
    (packed), the card's gradient equals the CPU's plain one.  The dense
    backward walks the forward tiles, also on two graphs whose slabs
    overflow the kernel's shared list: 16 rows of 300 in-edges (R drops
    to 8) and one star row of 4,200 in-edges (R = 1; that slab walks its
    span twice).  The packed backward is one count and one scatter
    launch over the forward groups."""
    dev = _card()
    cases = [(_hub_graph(integer=True), None)]
    if fmt == "dense":
        cases += [(_star_graph(16, 300), 8), (_star_graph(1, 4200), 1)]
    for g, rows in cases:
        grads = []
        for d in ("cpu", dev):
            if fmt == "dense":
                b = coo_to_blocked(g, 16)
                host = t_spmm.prepare_blocks(b.blocks, b.block_row,
                                             b.block_col, b.q)
                arrs = [_t(a).to(d) for a in host]
                q, n = b.q, b.padded_vertices

                def run(x, arrs=arrs, q=q):
                    return t_spmm.blocked_spmm(*arrs, x, q=q, op="max")
            else:
                ps = pack_tile_store(build_tile_store(g, 16))
                groups = upload_groups(t_gather.prepare_packed_groups(ps), d)
                q, n = ps.q, ps.padded_vertices

                def run(x, groups=groups, q=q):
                    return t_gather.packed_groups_spmm(groups, x, q=q,
                                                       op="max")
            x = _t(_hub_x(n, 24, "max", 5)).to(d).requires_grad_(True)
            gy = _t(np.random.default_rng(6).standard_normal(
                (n, 24)).astype(np.float32)).to(d)
            before = (t_spmm_bwd.LAUNCHES["max"],
                      dict(t_gather_bwd.LAUNCHES))
            (run(x) * gy).sum().backward()
            if d != "cpu":
                torch.cuda.synchronize()
                if fmt == "dense":
                    assert t_spmm_bwd.LAUNCHES["max"] == before[0] + 1
                else:
                    assert t_gather_bwd.LAUNCHES == {
                        k: v + 1 for k, v in before[1].items()}
            grads.append(x.grad.cpu())
        if rows is not None:
            counts = t_spmm_bwd.row_counts(host[0], host[1], q)
            assert t_spmm_bwd.slab_rows(counts, 16) == rows
        np.testing.assert_allclose(grads[1].numpy(), grads[0].numpy(),
                                   rtol=1e-5, atol=1e-6)


@pytest.mark.cuda
@pytest.mark.parametrize("f", [20, 300])
@pytest.mark.parametrize("tile", [16, 18])
@pytest.mark.parametrize("h", [3, 7, 64, 300])
def test_fused_engn_split_columns_on_card(h, tile, f):
    """B3 on the hub graph, whose column spans are cut into pieces merged
    in Y by atomics: H = 3 and 7 take scalar atomics, 64 float4 ones, 300
    two output chunks; T = 18 the 4-byte copies; F = 300 a reduction
    over ten stages.  The plan's column table and one built for the call
    give the same Y, and each call is one launch."""
    dev = _card()
    b = coo_to_blocked(_hub_graph(), tile)
    host = t_spmm.prepare_blocks(b.blocks, b.block_row, b.block_col, b.q)
    args = [_t(a).to(dev) for a in host]
    assert t_fused.column_order(host[2], b.q)[1][:, 3].any()
    rng = np.random.default_rng(h + f)
    x = _t(rng.standard_normal((b.padded_vertices, f)).astype(
        np.float32)).to(dev)
    w = _t((rng.standard_normal((f, h)) / np.sqrt(f)).astype(
        np.float32)).to(dev)
    before = t_fused.LAUNCHES["sum"]
    got = t_fused.fused_engn_layer(
        *args, x, w, q=b.q, columns=t_fused.column_table(host[2], b.q, dev))
    again = t_fused.fused_engn_layer(*args, x, w, q=b.q)
    want = t_fused.fused_engn_plain(*args, x, w, q=b.q)
    torch.cuda.synchronize()
    assert t_fused.LAUNCHES["sum"] == before + 2
    _check_hub(got.cpu(), want.cpu(), "sum")
    _check_hub(again.cpu(), want.cpu(), "sum")


@pytest.mark.cuda
@pytest.mark.parametrize("h", [7, 64])
def test_fused_engn_large_grid_on_card(h):
    """A grid of more than one wave (over 528 column pieces at T = 16)
    takes the kernel's full-height source slabs; the smaller grids above
    take the half-height ones."""
    dev = _card()
    b = coo_to_blocked(_graph(n=9600, live=9600, e=48000, seed=h), 16)
    host = t_spmm.prepare_blocks(b.blocks, b.block_row, b.block_col, b.q)
    assert len(t_fused.column_order(host[2], b.q)[1]) >= 4 * 132
    args = [_t(a).to(dev) for a in host]
    rng = np.random.default_rng(h)
    x = _t(rng.standard_normal((b.padded_vertices, 40)).astype(
        np.float32)).to(dev)
    w = _t((rng.standard_normal((40, h)) / 8).astype(np.float32)).to(dev)
    _check_hub(t_fused.fused_engn_layer(*args, x, w, q=b.q).cpu(),
               t_fused.fused_engn_plain(*args, x, w, q=b.q).cpu(), "sum")


@pytest.mark.cuda
@pytest.mark.parametrize("f,h", [(32, 7), (20, 32)])
def test_fused_engn_kernel_matches_plain_on_card(f, h):
    dev = _card()
    b = coo_to_blocked(_graph(seed=h), 32)
    x = torch.randn((b.padded_vertices, f), device=dev)
    w = torch.randn((f, h), device=dev) * 0.2
    args = [_t(a).to(dev) for a in (b.blocks, b.block_row, b.block_col)]
    _check(t_fused.fused_engn_layer(*args, x, w, q=b.q).cpu(),
           t_fused.fused_engn_plain(*args, x, w, q=b.q).cpu(), "sum")
