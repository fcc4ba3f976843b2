"""The port's kernel modules against the reference's dispatchers.

Each plain PyTorch version (what a wrapper runs for CPU tensors, and
what the CUDA kernel is held to on the card) is checked against the JAX
dispatcher with impl="xla" and with impl="pallas" (interpret mode on
the CPU), on ragged feature widths, missing destination intervals and
empty rows.  Max is exactly equal; sums agree to rtol=1e-4, atol=1e-5
(the two frameworks reduce in different orders).  The kernels
themselves run only on a card: the `cuda`-marked tests skip without one.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.fused_engn import ops as j_fused
from repro.kernels.rer_gather import ops as j_gather
from repro.kernels.rer_spmm import ops as j_spmm
from repro_torch.graphs.format import COOGraph, coo_to_blocked
from repro_torch.graphs.generate import rmat_graph
from repro_torch.graphs.partition import (build_tile_store, merge_by_key,
                                          pack_tile_store)
from repro_torch.kernels import _build, _common
from repro_torch.kernels.fused_engn import ops as t_fused
from repro_torch.kernels.rer_gather import ops as t_gather
from repro_torch.kernels.rer_spmm import ops as t_spmm

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
                               q=b.q, op=op, transposed=None), got, "max")


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
                                    _t(w), q=b.q, transposed=None), got,
           "max")


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
    with pytest.raises(NotImplementedError, match="ROADMAP A5"):
        _common.refuse_grad("k", torch.zeros(2, requires_grad=True))
    with torch.no_grad():
        _common.refuse_grad("k", torch.zeros(2, requires_grad=True))


def test_wrappers_refuse_other_devices():
    x = torch.zeros((32, 4), device="meta")
    with pytest.raises(ValueError, match="no rer_spmm"):
        t_spmm.blocked_spmm(None, None, None, x, q=2, transposed=None)
    with pytest.raises(ValueError, match="no rer_gather"):
        t_gather.packed_spmm(None, None, None, None, None, x, q=2)
    with pytest.raises(ValueError, match="no fused_engn"):
        t_fused.fused_engn_layer(None, None, None, x, None, q=2,
                                 transposed=None)


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
    got = t_spmm.blocked_spmm(*args, x, q=b.q, op=op, transposed=None)
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


@pytest.mark.cuda
@pytest.mark.parametrize("f,h", [(32, 7), (20, 32)])
def test_fused_engn_kernel_matches_plain_on_card(f, h):
    dev = _card()
    b = coo_to_blocked(_graph(seed=h), 32)
    x = torch.randn((b.padded_vertices, f), device=dev)
    w = torch.randn((f, h), device=dev) * 0.2
    args = [_t(a).to(dev) for a in (b.blocks, b.block_row, b.block_col)]
    _check(t_fused.fused_engn_layer(*args, x, w, q=b.q,
                                    transposed=None).cpu(),
           t_fused.fused_engn_plain(*args, x, w, q=b.q).cpu(), "sum")
