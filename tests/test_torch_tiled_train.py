"""Streamed training on the port's `tiled` backend against the reference.

The port's gradients through the streamed aggregate (sum, mean, max),
R-GCN's typed sum and Gated-GCN's gated sum are held against `jax.grad`
through the reference's streamed custom_vjp on the same numpy inputs, on
both routes (the per-chunk callback loop and a chunk queue that fits)
and both tile formats.  Tolerances: sum and mean gradients
allclose(rtol=1e-5, atol=1e-6) (the frameworks reduce in different
orders); max gradients exactly equal on integer-valued inputs (the
cotangent a multiple of every tie count, so each share is an integer)
and allclose(rtol=1e-5, atol=1e-6) on random ones; loss trajectories
rtol=1e-3, atol=1e-4 (the reference's); `TiledStats` field for field
equal, the backward's `bwd_*` counters included.  The queue kernel's
backward (B5^T) runs through its plain version here and against it on
the card (`cuda`-marked tests, which skip without one).
"""
import argparse
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import engn as j_engn
from repro.core import models as j_models
from repro.core import tiled as j_tiled
from repro.graphs.generate import random_features, rmat_graph
from repro.graphs import partition as j_part
from repro.kernels.chunk_queue import ops as j_queue
from repro.kernels.chunk_queue.ops import queue_bytes
import repro_torch as rt
from repro_torch.core import engn as t_engn
from repro_torch.core import tiled as t_tiled
from repro_torch.core.models import stack_params
from repro_torch.graphs import partition as t_part
from repro_torch.graphs.format import COOGraph
from repro_torch.interop import load_reference_params
from repro_torch.kernels import launch_counts
from repro_torch.kernels.chunk_queue import ops as t_queue
from repro_torch.launch import elastic_gnn as t_elastic
from repro_torch.launch import train as t_train

RTOL, ATOL = 1e-5, 1e-6            # sum and mean gradients, random max
TRAIN_RTOL, TRAIN_ATOL = 1e-3, 1e-4
RELS = 3


def _int_graph(n, e, seed):
    """Deduplicated R-MAT graph with weights in {1, 2, 3}."""
    g = rmat_graph(n, e, seed=seed)
    uniq = np.unique(np.stack([g.src, g.dst]), axis=1)
    val = np.random.default_rng(seed).integers(1, 4, uniq.shape[1])
    return COOGraph(n, uniq[0].astype(np.int32), uniq[1].astype(np.int32),
                    val.astype(np.float32))


def _int_features(n, f, seed):
    return np.random.default_rng(seed + 17).integers(
        -3, 4, (n, f)).astype(np.float32)


def _float_graph(n, e, seed):
    return rmat_graph(n, e, seed=seed).gcn_normalized()


def _typed_float_graph(n, e, seed):
    g = rmat_graph(n, e, seed=seed)
    val = np.random.default_rng(seed + 31).uniform(
        0.5, 1.5, g.num_edges).astype(np.float32)
    rel = ((g.src.astype(np.int64) + g.dst) % RELS).astype(np.int32)
    return COOGraph(n, g.src, g.dst, val, rel, RELS)


def _uniform(shape, seed, lo=-1.0, hi=1.0):
    return np.random.default_rng(seed).uniform(lo, hi, shape).astype(
        np.float32)


def _stats(stats):
    return dataclasses.asdict(stats)


def _tie_multiple(g, x, tile, fmt):
    """The least common multiple of the max's tie counts on (g, x): a
    cotangent that is a multiple of it splits into integer shares."""
    ex = j_tiled.TiledExecutor(g, tile=tile, tile_format=fmt)
    _, cnt = ex.aggregate_max_forward(x)
    return float(np.lcm.reduce(np.unique(np.maximum(cnt, 1)).astype(
        np.int64)))


def _port_grad(fn, x, coef):
    xx = torch.from_numpy(x).requires_grad_(True)
    y = fn(xx)
    (y * torch.from_numpy(coef)).sum().backward()
    return y.detach().numpy(), xx.grad.numpy()


def _ref_grad(fn, x, coef):
    y, vjp = jax.vjp(fn, jnp.asarray(x))
    (gx,) = vjp(jnp.asarray(coef))
    return np.asarray(y), np.asarray(gx)


def _hold(got, want, exact):
    if exact:
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


# -- the streamed aggregate against the reference's custom_vjp -------------------

@pytest.mark.parametrize("mode", ["callback", "auto"])
@pytest.mark.parametrize("op", ["sum", "mean", "max"])
@pytest.mark.parametrize("fmt", ["dense", "packed"])
def test_streamed_grads_and_stats_equal_reference(fmt, op, mode):
    """Integer graph and features: the output and x's gradient (exactly
    equal for max), and every `TiledStats` counter, forward and
    backward.  mode="auto" with packed tiles is the queue route (the
    slab sweep on the CPU); everything else the callback loop."""
    n, d = 150, 6
    g = _int_graph(n, 900, seed=2)
    x = _int_features(n, d, seed=2)
    coef = _int_features(n, d, seed=3)
    if op == "max":
        coef = coef * _tie_multiple(g, x, 16, fmt)
    kw = dict(tile=16, chunk=3, tile_format=fmt, streaming_mode=mode)
    je = j_tiled.TiledExecutor(g, **kw)
    te = t_tiled.TiledExecutor(g, device="cpu", **kw)
    queued = te.queue_plan(d, "max" if op == "max" else "sum") is not None
    assert queued == (mode == "auto" and fmt == "packed")
    want_y, want = _ref_grad(j_tiled.make_streamed_aggregate(je, op), x,
                             coef)
    got_y, got = _port_grad(t_tiled.make_streamed_aggregate(te, op), x,
                            coef)
    _hold(got_y, want_y, op == "max")
    _hold(got, want, op == "max")
    assert _stats(te.stats) == _stats(je.stats)
    assert (te.stats.bwd_tiles > 0) == (not queued)
    assert (te.stats.queue_builds > 0) == queued


@pytest.mark.parametrize("op", ["sum", "mean", "max"])
@pytest.mark.parametrize("fmt", ["dense", "packed"])
def test_streamed_vjp_matches_fd_and_reference(fmt, op):
    """Real-valued inputs through the callback route: directional finite
    differences (the reference's check) and the reference's gradient."""
    g = _float_graph(60, 400, seed=7)
    rng = np.random.default_rng(8)
    x = rng.uniform(0.5, 1.5, (60, 4)).astype(np.float32)
    coef = rng.uniform(-1, 1, (60, 4)).astype(np.float32)
    kw = dict(tile=16, chunk=3, tile_format=fmt)
    fn = t_tiled.make_streamed_aggregate(
        t_tiled.TiledExecutor(g, device="cpu", **kw), op)
    _, got = _port_grad(fn, x, coef)
    _, want = _ref_grad(j_tiled.make_streamed_aggregate(
        j_tiled.TiledExecutor(g, **kw), op), x, coef)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    c = torch.from_numpy(coef)

    def loss(xx):
        with torch.no_grad():
            return float((fn(xx) * c).sum())
    dirs = np.random.default_rng(9).standard_normal((4,) + x.shape)
    eps = 1e-3
    for v in dirs.astype(np.float32):
        fd = (loss(torch.from_numpy(x + eps * v))
              - loss(torch.from_numpy(x - eps * v))) / (2 * eps)
        np.testing.assert_allclose(fd, float((got * v).sum()), rtol=5e-2,
                                   atol=0.05)


@pytest.mark.parametrize("op", ["sum", "mean", "max"])
def test_streamed_vjp_of_a_budget_spill_matches_reference(op):
    """A blocked training plan over its budget spills to "tiled" in both
    packages; the spilled executor's gradient is the reference's."""
    n, d = 300, 6
    g = _int_graph(n, 2500, seed=0)
    x = _int_features(n, d, 0)
    coef = _int_features(n, d, 99)
    if op == "max":
        coef = coef * _tie_multiple(g, x, 32, "auto")
    budget = 50_000
    cfg = dict(in_dim=d, out_dim=d, aggregate_op=op, backend="blocked",
               tile=32, training=True, device_budget_bytes=budget)
    jplan = j_engn.prepare_graph(g, j_engn.EnGNConfig(**cfg))
    tplan = rt.prepare_graph(g, t_engn.EnGNConfig(**cfg), device="cpu")
    assert tplan.backend == jplan.backend == "tiled"
    _, want = _ref_grad(j_tiled.make_streamed_aggregate(
        jplan.carrier["tiled_exec"], op), x, coef)
    te = tplan.carrier["tiled_exec"]
    _, got = _port_grad(t_tiled.make_streamed_aggregate(te, op), x, coef)
    _hold(got, want, op == "max")
    assert _stats(te.stats) == _stats(jplan.carrier["tiled_exec"].stats)


@pytest.mark.parametrize("fmt", ["dense", "packed"])
def test_streamed_max_tie_convention(fmt):
    """A two-way tie splits the cotangent evenly (the reference's
    `segment_max` convention): 0.5 of 4 on each winner."""
    g = COOGraph(5, np.array([0, 1, 3], np.int32),
                 np.array([2, 2, 4], np.int32), np.ones(3, np.float32))
    x = np.array([[2.0], [2.0], [0.0], [7.0], [0.0]], np.float32)
    coef = np.array([[0.0], [0.0], [4.0], [0.0], [8.0]], np.float32)
    ex = t_tiled.TiledExecutor(g, tile=2, chunk=2, tile_format=fmt,
                               device="cpu")
    _, got = _port_grad(t_tiled.make_streamed_aggregate(ex, "max"), x, coef)
    _, want = _ref_grad(j_tiled.make_streamed_aggregate(
        j_tiled.TiledExecutor(g, tile=2, chunk=2, tile_format=fmt), "max"),
        x, coef)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got[:2, 0], [2.0, 2.0])


def test_streamed_backward_stats_and_transposed_sharing():
    """The backward's re-stream lands in `bwd_*` (as the reference's), and
    the transposed executor is a cached zero-copy view of the forward's
    host arrays with its own stats and no device queue."""
    g = _int_graph(120, 800, seed=2)
    x = _int_features(120, 5, 2)
    kw = dict(tile=16, chunk=2, streaming_mode="callback")
    ex = t_tiled.TiledExecutor(g, device="cpu", **kw)
    je = j_tiled.TiledExecutor(g, **kw)
    ones = np.ones((120, 5), np.float32)
    _port_grad(t_tiled.make_streamed_aggregate(ex, "sum"), x, ones)
    _ref_grad(j_tiled.make_streamed_aggregate(je, "sum"), x, ones)
    s = ex.stats
    assert s.bwd_steps > 0 and s.bwd_tiles > 0 and s.tiles > 0
    assert s.bwd_h2d_tile_bytes > 0 and s.bwd_d2h_bytes > 0
    assert _stats(s) == _stats(je.stats)
    tex = ex.transposed()
    assert tex is ex.transposed()
    assert tex.store.edge_w is ex.store.edge_w
    assert tex.store.edge_li is ex.store.edge_lj
    assert tex.packed.val is ex.packed.val
    assert tex.stats is not ex.stats and tex._queue_cache == {}
    assert t_tiled.make_streamed_aggregate(ex, "sum") is \
        t_tiled.make_streamed_aggregate(ex, "sum")


def test_streamed_vjp_respects_budget():
    """A max gradient (the widest backward stream) under the budget the
    training-priced gate fitted: it runs, and equals the reference's."""
    n, d = 400, 8
    g = _int_graph(n, 3000, seed=3)
    x = _int_features(n, d, 3)
    coef = np.ones((n, d), np.float32) * _tie_multiple(g, x, 256, "auto")
    cfg = dict(in_dim=d, out_dim=d, aggregate_op="max", backend="segment",
               device_budget_bytes=120_000, training=True)
    tplan = rt.prepare_graph(g, t_engn.EnGNConfig(**cfg), device="cpu")
    jplan = j_engn.prepare_graph(g, j_engn.EnGNConfig(**cfg))
    assert tplan.backend == "tiled"
    te = tplan.carrier["tiled_exec"]
    assert (te.store.tile, te.chunk) == (jplan.meta["tile"],
                                         jplan.meta["chunk"])
    _, got = _port_grad(t_tiled.make_streamed_aggregate(te, "max"), x, coef)
    _, want = _ref_grad(j_tiled.make_streamed_aggregate(
        jplan.carrier["tiled_exec"], "max"), x, coef)
    assert np.isfinite(got).all()
    np.testing.assert_array_equal(got, want)


# -- whole layers: parameters and input -------------------------------------------

def _distinct(g):
    """`g` with each (src, dst) pair once, in key order, at its first
    copy's weight: the neighbour sets a max plan of the port holds,
    drawn here with numpy (the reference's carriers merge repeats by
    summing)."""
    key = g.dst.astype(np.int64) * g.num_vertices + g.src
    _, first = np.unique(key, return_index=True)
    return type(g)(g.num_vertices, g.src[first], g.dst[first],
                   None if g.val is None else g.val[first])


def _layer_pair(model, f, h, g, mode="auto", fmt="auto", budget=None,
                seed=0):
    jl = j_models.make_gnn(model, f, h, backend="tiled", tile=32,
                           num_relations=RELS)
    tl = rt.make_gnn(model, f, h, backend="tiled", tile=32,
                     num_relations=RELS, device="cpu")
    for cfg in (jl.cfg, tl.cfg):
        cfg.training = True
        cfg.streaming_mode, cfg.tile_format = mode, fmt
        cfg.device_budget_bytes = budget
    params = jl.init(jax.random.key(seed))
    load_reference_params([tl], [{k: np.asarray(v)
                                  for k, v in params.items()}])
    # a max plan streams the distinct edges: the reference is handed them
    jg = _distinct(g) if tl.cfg.aggregate_op == "max" else g
    return (jl, params, j_engn.prepare_graph(jg, jl.cfg), tl,
            rt.prepare_graph(g, tl.cfg, device="cpu"))


def _layer_grads(jl, params, jplan, tl, tplan, x, r):
    jg = jax.grad(lambda p, xx: jnp.sum(jl.apply(p, jplan, xx)
                                        * jnp.asarray(r)),
                  argnums=(0, 1))(params, jnp.asarray(x))
    ps = {k: v.detach().clone().requires_grad_(True)
          for k, v in stack_params([tl])[0].items()}
    xx = torch.from_numpy(x).requires_grad_(True)
    y = torch.func.functional_call(tl, ps, (tplan, xx))
    assert y.device.type == "cpu" and y.requires_grad
    (y * torch.from_numpy(r)).sum().backward()
    for k, v in ps.items():
        np.testing.assert_allclose(v.grad.numpy(), np.asarray(jg[0][k]),
                                   rtol=RTOL, atol=ATOL, err_msg=k)
    np.testing.assert_allclose(xx.grad.numpy(), np.asarray(jg[1]),
                               rtol=RTOL, atol=ATOL)
    return tplan.carrier["tiled_exec"], jplan.carrier["tiled_exec"]


@pytest.mark.parametrize("mode", ["callback", "auto"])
@pytest.mark.parametrize("model", ["gcn", "gs_pool", "grn"])
def test_streamed_layer_grads_match_reference(model, mode):
    """A tiled layer under autograd routes through the differentiable
    streamed path (extraction and update are ordinary autograd ops) and
    its parameter and input gradients are the reference's."""
    n, f = 150, 6
    h = f if model == "grn" else 4
    g = _float_graph(n, 900, seed=1)
    x = _uniform((n, f), seed=1)
    r = _uniform((n, h), seed=5)
    pair = _layer_pair(model, f, h, g, mode=mode)
    te, je = _layer_grads(*pair, x, r)
    assert _stats(te.stats) == _stats(je.stats)


@pytest.mark.parametrize("fmt", ["dense", "packed"])
def test_streamed_typed_grads_match_reference(fmt):
    """R-GCN on "tiled": the typed VJP (each tile's partial added into
    its relation's block of the payload's cotangent) gives the
    reference's w0, wr and input gradients, and its stats."""
    n, f, h = 150, 6, 4
    g = _typed_float_graph(n, 1000, seed=11)
    x = _uniform((n, f), seed=12)
    r = _uniform((n, h), seed=13)
    te, je = _layer_grads(*_layer_pair("rgcn", f, h, g, fmt=fmt, seed=4),
                          x, r)
    assert te.stats.bwd_tiles > 0
    assert _stats(te.stats) == _stats(je.stats)


def test_streamed_typed_rgcn_grads_fd():
    """The reference's FD case: a graph over its budget, positive inputs
    and weights (ReLU stays smooth), the wr and x gradients against
    directional differences and the reference's."""
    n, f, h = 180, 6, 5
    g = _typed_float_graph(n, 1400, seed=7)
    x = _uniform((n, f), seed=8, lo=0.1, hi=1.0)
    r = _uniform((n, h), seed=9)
    jl, params, jplan, tl, tplan = _layer_pair("rgcn", f, h, g,
                                               budget=40_000, seed=2)
    assert tplan.backend == "tiled"
    for key, seed in (("w0", 12), ("wr", 13)):
        params[key] = jnp.asarray(_uniform(params[key].shape, seed=seed,
                                           lo=0.1, hi=1.0))
    load_reference_params([tl], [{k: np.asarray(v)
                                  for k, v in params.items()}])
    _layer_grads(jl, params, jplan, tl, tplan, x, r)
    rt_ = torch.from_numpy(r)

    def loss(xx):
        with torch.no_grad():
            return float((tl(tplan, xx) * rt_).sum())
    xx = torch.from_numpy(x).requires_grad_(True)
    (tl(tplan, xx) * rt_).sum().backward()
    eps = 1e-3
    for v in np.random.default_rng(4).standard_normal((3, n, f)).astype(
            np.float32):
        fd = (loss(torch.from_numpy(x + eps * v))
              - loss(torch.from_numpy(x - eps * v))) / (2 * eps)
        np.testing.assert_allclose(fd, float((xx.grad.numpy() * v).sum()),
                                   rtol=5e-2, atol=0.05)


@pytest.mark.parametrize("fmt", ["dense", "packed"])
def test_streamed_gated_grads_match_reference(fmt):
    """Gated-GCN on "tiled" over its budget: the gated VJP (a dst-side
    recompute sweep and a transposed src-side one) gives the reference's
    w_h, w_c, w and input gradients, and its stats."""
    n, f, h = 160, 6, 4
    g = _typed_float_graph(n, 1200, seed=17)
    g = COOGraph(n, g.src, g.dst, g.val)
    x = _uniform((n, f), seed=18)
    r = _uniform((n, h), seed=19)
    pair = _layer_pair("gated_gcn", f, h, g, fmt=fmt, budget=40_000,
                       seed=6)
    assert pair[4].backend == "tiled"
    te, je = _layer_grads(*pair, x, r)
    assert te.stats.bwd_steps > 0
    assert _stats(te.stats) == _stats(je.stats)


# -- the chunk queue's differentiable routes --------------------------------------

def _packed_pair(g, tile=32, **kw):
    kw = dict(tile=tile, chunk=4, tile_format="packed", **kw)
    return j_tiled.TiledExecutor(g, **kw), t_tiled.TiledExecutor(
        g, device="cpu", **kw)


@pytest.mark.parametrize("op", ["sum", "mean", "max"])
def test_traced_queue_grads_match_reference(op):
    """The queue route on the CPU (the slab sweep differentiated by
    autograd) against the reference's traced queue: integer inputs."""
    g = _int_graph(120, 700, seed=3)
    x = _int_features(120, 8, seed=3)
    coef = np.random.default_rng(4).integers(1, 3, (120, 8)).astype(
        np.float32)
    if op == "max":
        coef = coef * _tie_multiple(g, x, 32, "packed")
    je, te = _packed_pair(g)
    assert te.queue_plan(8, op) is not None
    want_y, want = _ref_grad(j_tiled.make_streamed_aggregate(je, op), x,
                             coef)
    got_y, got = _port_grad(t_tiled.make_streamed_aggregate(te, op), x,
                            coef)
    _hold(got_y, want_y, op == "max")
    _hold(got, want, op == "max")
    assert te.stats.steps == 0 and te.stats.bwd_steps == 0
    assert _stats(te.stats) == _stats(je.stats)


def _multi_slab(g, d, slab, tile=32):
    je, te = _packed_pair(g, tile=tile)
    n = g.num_vertices
    work = 4 * d * (slab + 2 * (n + 1)) + 4 * n * d
    for ex in (je, te):
        ex.budget_bytes = queue_bytes(ex.packed.nnz, slab) + work + 64
    plan = te.queue_plan(d, "max")
    assert plan is not None and plan.steps > 1
    assert dataclasses.asdict(plan) == dataclasses.asdict(
        je.queue_plan(d, "max"))
    return je, te


def test_multi_slab_max_grads_match_reference_with_cross_slab_ties():
    """Every row's four tied winners sit in four tiles (and slabs): the
    cross-slab tie counts give each g/4, exactly the reference's."""
    n, d, t = 256, 8, 64
    dst = np.repeat(np.arange(n, dtype=np.int32), 4)
    src = (dst + t * np.tile(np.arange(4, dtype=np.int32), n)) % n
    g = COOGraph(n, src.astype(np.int32), dst, np.ones(src.size, np.float32))
    je, te = _multi_slab(g, d, 256, tile=t)
    rng = np.random.default_rng(7)
    x = np.broadcast_to((2.0 ** rng.integers(0, 3, (1, d))).astype(
        np.float32), (n, d)).copy()
    w = (2.0 ** rng.integers(0, 2, (n, d))).astype(np.float32)
    want_y, want = _ref_grad(j_tiled.make_streamed_aggregate(je, "max"), x,
                             w)
    got_y, got = _port_grad(t_tiled.make_streamed_aggregate(te, "max"), x,
                            w)
    np.testing.assert_array_equal(got_y, want_y)
    np.testing.assert_array_equal(got, want)
    assert te.stats.steps == 0 and te.stats.bwd_steps == 0


def test_multi_slab_max_grads_equal_reference_on_random_integer_data():
    """The randomised twin: an R-MAT graph with integer weights and
    features over several slabs, the cotangent a multiple of the tie
    counts, so the shares are exact."""
    d = 8
    g = _int_graph(256, 2000, seed=5)
    je, te = _multi_slab(g, d, 512)
    x = _int_features(256, d, seed=11)
    coef = np.ones((256, d), np.float32) * _tie_multiple(g, x, 32, "packed")
    _, want = _ref_grad(j_tiled.make_streamed_aggregate(je, "max"), x, coef)
    _, got = _port_grad(t_tiled.make_streamed_aggregate(te, "max"), x, coef)
    np.testing.assert_array_equal(got, want)


# -- B5^T's plain version, the queue Function and its pricing ---------------------

def _with_piece(tq, piece):
    """`tq` with B5^T's table rebuilt at `piece` entries a piece, as
    `build_tile_queue` builds it at `source_piece`'s."""
    tpieces, tsrc_ptr, tsrc_tiles, tile_dst, t_split = (
        t_queue.queue_src_work(tq.tile_ptr.cpu().numpy(),
                               tq.tile_src.cpu().numpy(),
                               tq.entry_ptr.cpu().numpy(), piece))
    dev = tq.tpieces.device
    return dataclasses.replace(
        tq, tpieces=torch.from_numpy(tpieces).to(dev),
        tsrc_ptr=torch.from_numpy(tsrc_ptr).to(dev),
        tsrc_tiles=torch.from_numpy(tsrc_tiles).to(dev),
        tile_dst=torch.from_numpy(tile_dst).to(dev), t_split=t_split,
        t_piece=piece)


def _queue(n=300, e=2500, tile=32, seed=1, segment=None, piece=None,
           gap=False, device="cpu"):
    """An integer R-MAT graph's tile queue; `gap` drops every edge out of
    source interval 2, so it has no tile; `piece` rebuilds B5^T's table
    at that many entries a piece."""
    g = _int_graph(n, e, seed)
    if gap:
        keep = (g.src < 2 * tile) | (g.src >= 3 * tile)
        g = COOGraph(n, g.src[keep], g.dst[keep], g.val[keep])
    packed = t_part.pack_tile_store(t_part.build_tile_store(g, tile))
    tq = t_queue.build_tile_queue(packed, device=device)
    if piece is not None:
        tq = _with_piece(tq, piece)
    if segment is not None:
        pieces = t_queue.queue_segments(tq.tile_ptr.numpy(),
                                        tq.entry_ptr.numpy(), segment)
        tq = dataclasses.replace(tq, pieces=torch.from_numpy(pieces).to(
            device), n_split=t_queue.split_count(pieces))
    return g, packed, tq


def _last_le(ptr, lo, hi, v):
    while lo < hi:
        mid = (lo + hi + 1) >> 1
        if ptr[mid] <= v:
            lo = mid
        else:
            hi = mid - 1
    return lo


def _lane_groups(f):
    """Lane groups per warp of B5^T at width f (`queue_lanes`: fp lanes
    over the features, 32 / fp groups)."""
    if f > 32:
        return 32 // (16 if f <= 64 else 32)
    fp = 4
    while fp < f:
        fp *= 2
    return 32 // fp


def _b5t_walk(tq, gg, warps=8):
    """B5^T's order of work in numpy, as `chunk_queue_t_kernel` does it.
    Per piece: its span of source-ordered tiles (the row's last two
    columns) staged, each entry's tile found by a search of the staged
    offsets; the piece sorted by source column and cut evenly into one
    run per lane group; a column wholly in a run written once by its
    group, a column a cut falls inside written once from the runs'
    partials; an unsplit interval's rows stored once (a row with no entry
    as zero), a split one merged and stored by the last of its pieces to
    arrive; every row below n stored exactly once."""
    t, n, f = tq.tile, tq.n, gg.shape[1]
    sp, st = tq.tsrc_ptr.numpy(), tq.tsrc_tiles.numpy()
    td, ep = tq.tile_dst.numpy(), tq.entry_ptr.numpy()
    rows, cols, vals = tq.rows.numpy(), tq.cols.numpy(), tq.vals.numpy()
    nk = warps * _lane_groups(f)
    dx = np.full((n, f), np.nan, np.float32)
    part = np.zeros((tq.t_split, t, f), np.float32)
    arrived = np.zeros(tq.t_split, np.int64)
    for src, lo, hi, slot, count, jb, je in tq.tpieces.numpy():
        ne = hi - lo
        assert ne <= tq.t_piece and je - jb <= ne
        s_ptr = sp[jb:je + 1]
        e_of = np.empty(ne, np.int64)
        for i in range(ne):
            jl = _last_le(s_ptr, 0, je - jb - 1, lo + i)
            assert s_ptr[jl] <= lo + i < s_ptr[jl + 1]
            assert tq.tile_src.numpy()[st[jb + jl]] == src
            e_of[i] = ep[st[jb + jl]] + lo + i - s_ptr[jl]
        tile_of = np.searchsorted(ep, e_of, side="right") - 1
        c, v = cols[e_of], vals[e_of]
        grow = td[tile_of] * t + rows[e_of]
        base = np.concatenate([[0], np.cumsum(np.bincount(c, minlength=t))])
        order = np.argsort(c, kind="stable")
        cuts = [ne * k // nk for k in range(nk + 1)]
        # a column a cut falls inside gathers the runs' partials; every
        # other column lies in one run
        shared = {c[order[cuts[k]]] for k in range(1, nk)
                  if cuts[k] < ne and base[c[order[cuts[k]]]] < cuts[k]}
        row0, nrows = src * t, min(t, n - src * t)
        block = np.zeros((t, f), np.float32)
        written = np.zeros(t, bool)
        for rb, re in zip(cuts[:-1], cuts[1:]):
            run = order[rb:re]
            for col in np.unique(c[run]):
                mine = run[c[run] == col]
                block[col] += (v[mine, None] * gg[grow[mine]]).sum(0)
                if col not in shared:
                    assert (c == col).sum() == mine.size
                    assert not written[col]
                    written[col] = True
        written[list(shared)] = True
        assert (written == (np.diff(base) > 0)).all()
        out = dx[row0:row0 + nrows]
        if slot < 0:
            assert np.isnan(out).all()
            out[:] = block[:nrows]        # rows with no entry: zero
            continue
        part[slot] += block
        arrived[slot] += 1
        if arrived[slot] == count:
            assert np.isnan(out).all()
            out[:] = part[slot, :nrows]
    assert not np.isnan(dx).any()
    return dx


def _one_per_tile_queue(device="cpu"):
    """T = 4, every tile one entry; source intervals 0-3 hold 300 tiles
    each (one piece of 300 entries and 300 tiles), the other 296 none;
    n = 1199."""
    a, b = np.meshgrid(np.arange(300), np.arange(4), indexing="ij")
    g = COOGraph(1199, (4 * b.ravel() + a.ravel() % 4).astype(np.int32),
                 (4 * a.ravel()).astype(np.int32),
                 (1 + a.ravel() % 3).astype(np.float32))
    packed = t_part.pack_tile_store(t_part.build_tile_store(g, 4))
    tq = _with_piece(t_queue.build_tile_queue(packed, device=device), 1024)
    assert (np.diff(tq.entry_ptr.cpu().numpy()) == 1).all()
    assert tq.tpieces.shape[0] == tq.q and tq.t_split == 0
    return g, tq


@pytest.mark.parametrize("gap", [False, True])
@pytest.mark.parametrize("piece", [1, 7, 64, None])
def test_source_table_covers_each_tile_once(piece, gap):
    """B5^T's work table: `tsrc_tiles` holds every tile with entries
    once, stably sorted by source interval; `tsrc_ptr` their entry
    offsets in that order; `tile_dst` each tile's destination interval;
    the pieces partition each source interval's entries in at most
    `piece` entries (None: `source_piece`, the floor at this size),
    every source interval has one (an interval with no tile an empty
    one), a split interval has a slot of its own, rows run longest
    first; the pricing counts its splits."""
    g, packed, tq = _queue(piece=piece, gap=gap)
    tile_src = tq.tile_src.numpy()
    lens = np.diff(tq.entry_ptr.numpy())
    st, sp = tq.tsrc_tiles.numpy(), tq.tsrc_ptr.numpy()
    assert piece is not None or tq.t_piece == t_queue.PIECE_FLOOR
    assert tq.t_piece == (piece or t_queue.PIECE_FLOOR)
    np.testing.assert_array_equal(np.sort(st), np.flatnonzero(lens > 0))
    np.testing.assert_array_equal(
        st, np.flatnonzero(lens > 0)[np.argsort(tile_src[lens > 0],
                                                kind="stable")])
    np.testing.assert_array_equal(sp, np.concatenate([[0], np.cumsum(
        lens[st])]))
    np.testing.assert_array_equal(
        tq.tile_dst.numpy(), np.repeat(np.arange(tq.q),
                                       np.diff(tq.tile_ptr.numpy())))
    tp = tq.tpieces.numpy()
    assert tp.dtype == np.int32 and tp.shape[1] == 7
    assert (np.diff(tp[:, 2] - tp[:, 1]) <= 0).all()
    for _, lo, hi, _, _, jb, je in tp:        # the tiles holding the piece
        if hi == lo:
            assert jb == je
        else:
            assert sp[jb] <= lo < sp[jb + 1] and sp[je - 1] < hi <= sp[je]
    slots = []
    for s in range(tq.q):
        mine = tp[tp[:, 0] == s]
        assert len(mine) >= 1
        span = np.flatnonzero(tile_src[st] == s)
        first = sp[span[0]] if span.size else None
        end = sp[span[-1] + 1] if span.size else None
        if span.size:
            assert mine[0, 1] == first and mine[-1, 2] == end
        else:
            assert len(mine) == 1 and mine[0, 1] == mine[0, 2]
        np.testing.assert_array_equal(mine[1:, 1], mine[:-1, 2])
        assert ((mine[:, 2] - mine[:, 1]) <= tq.t_piece).all()
        assert (mine[:, 4] == len(mine)).all()
        if len(mine) > 1:
            assert len(set(mine[:, 3].tolist())) == 1
            slots.append(int(mine[0, 3]))
        else:
            assert mine[0, 3] == -1
    assert slots == list(range(len(slots))) and tq.t_split == len(slots)
    src_lens = np.bincount(tile_src[:lens.size], weights=lens,
                           minlength=tq.q)
    assert tq.t_split == int((src_lens > tq.t_piece).sum())
    if gap:
        assert not (tile_src[st] == 2).any()
    if piece is None:
        assert t_queue.tile_queue_bytes(packed)[2] == tq.t_split


@pytest.mark.parametrize("f", [3, 16, 70])
@pytest.mark.parametrize("piece,gap,tile", [(64, False, 32),
                                            (None, False, 32),
                                            (64, True, 32), (None, False, 4)])
def test_source_walk_matches_plain_and_vjp(piece, gap, tile, f):
    """A plain walk of the source table in the kernel's order
    (`_b5t_walk`) gives `tile_queue_t_plain` and `jax.vjp` of the
    reference's `queue_sweep_xla` on the same numpy inputs (integer
    graph and cotangent: every sum exact in fp32, so the tolerance is
    RTOL/ATOL only for the frameworks' reduction orders).  At T = 4 every
    tile holds one entry and four source intervals of 300 the rest none:
    a piece spans as many tiles as it has entries, the most the kernel
    stages."""
    if tile == 4:
        g, tq = _one_per_tile_queue()
    else:
        g, packed, tq = _queue(piece=piece, gap=gap)
        assert tq.t_split > 0
    gg = _int_features(tq.n, f, seed=f)
    plain = t_queue.tile_queue_t_plain(tq, torch.from_numpy(gg)).numpy()
    got = _b5t_walk(tq, gg)
    np.testing.assert_allclose(got, plain, rtol=RTOL, atol=ATOL)
    cq = j_queue.build_chunk_queue(j_part.pack_tile_store(
        j_part.build_tile_store(g, tile)))
    _, vjp = jax.vjp(lambda x: j_queue.queue_sweep_xla(
        cq.gsrc, cq.gdst, cq.vals, cq.scales, x, n=tq.n),
        jnp.zeros((tq.n, f), jnp.float32))
    (want,) = vjp(jnp.asarray(gg))
    np.testing.assert_allclose(got, np.asarray(want), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("f", [3, 50])
def test_tile_queue_t_plain_is_the_transpose(f):
    """B5^T's plain version is A^T g over the forward queue, against the
    dense matrix of the graph."""
    g, _, tq = _queue()
    a = np.zeros((g.num_vertices, g.num_vertices), np.float64)
    np.add.at(a, (g.dst, g.src), g.val)
    gg = np.random.default_rng(f).standard_normal(
        (g.num_vertices, f)).astype(np.float32)
    got = t_queue.tile_queue_t_plain(tq, torch.from_numpy(gg)).numpy()
    np.testing.assert_allclose(got, a.T @ gg, rtol=1e-5, atol=1e-5)


def test_tile_queue_autograd_is_b5_and_b5t():
    """Under grad the queue sum is the autograd Function (B5 forward, B5^T
    backward; their plain versions on the CPU): the same output and
    gradient as autograd through the plain forward itself; a relu
    epilogue under grad is refused."""
    _, _, tq = _queue(segment=64)
    assert tq.n_split > 0
    rng = np.random.default_rng(2)
    x = torch.from_numpy(rng.standard_normal((tq.n, 5)).astype(np.float32))
    coef = torch.from_numpy(rng.standard_normal((tq.n, 5)).astype(
        np.float32))
    xa = x.clone().requires_grad_(True)
    ya = t_queue.tile_queue_aggregate(tq, xa)
    assert ya.grad_fn is not None and "TileQueueSum" in type(
        ya.grad_fn).__name__
    (ya * coef).sum().backward()
    xb = x.clone().requires_grad_(True)
    yb = t_queue.tile_queue_plain(tq, xb)
    (yb * coef).sum().backward()
    np.testing.assert_allclose(ya.detach().numpy(), yb.detach().numpy(),
                               rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(xa.grad.numpy(), xb.grad.numpy(), rtol=RTOL,
                               atol=ATOL)
    with pytest.raises(NotImplementedError, match="relu epilogue"):
        t_queue.tile_queue_aggregate(tq, xa, activation="relu")


@pytest.mark.parametrize("piece", [None, 64])
@pytest.mark.parametrize("segment", [None, 64])
def test_tile_queue_bytes_price_the_built_queue(segment, piece):
    """The price is the built queue's bytes and splits; with B5^T's
    table rebuilt at `piece` entries (split source intervals), the
    table's bytes move by 28 B a piece, one piece per `piece` entries of
    a source interval (at least one)."""
    _, packed, tq = _queue(segment=segment)
    kw = {} if segment is None else {"segment": segment}
    price = t_queue.tile_queue_bytes(packed, **kw)
    assert price == (tq.device_bytes(), tq.n_split, tq.t_split)
    if piece is None:
        return
    rebuilt = _with_piece(tq, piece)
    src_lens = np.bincount(packed.block_col, weights=packed.tile_nnz(),
                           minlength=tq.q).astype(np.int64)
    want = np.maximum(1, -(-src_lens // piece))
    assert rebuilt.t_split == int((want > 1).sum()) > 0
    assert rebuilt.tpieces.shape[0] == int(want.sum())
    assert rebuilt.device_bytes() == price[0] + 28 * (
        rebuilt.tpieces.shape[0] - tq.tpieces.shape[0])


def _held(obj) -> int:
    return rt.PreparedPlan(backend="tiled", n=0,
                           carrier={"obj": obj}).held_bytes()


@pytest.mark.parametrize("op", ["sum", "mean"])
def test_kernel_queue_route_stays_in_its_budget(op):
    """The kernel route's queue (impl="cuda"; its plain versions on the
    CPU) is priced at what it holds: an executor admitted at exactly the
    training price takes the queue, builds only the forward queues (no
    transposed one, before or after the backward) and holds them with
    the route's working set within the budget; its gradient is B5^T's."""
    d = 16
    g, _, _ = _queue()
    n = g.num_vertices
    kw = dict(tile=32, tile_format="packed", impl="cuda", device="cpu")
    price = t_tiled.TiledExecutor(g, **kw).queue_plan(
        d, op, training=True).device_bytes
    ex = t_tiled.TiledExecutor(g, budget_bytes=price, dim_hint=d, **kw)
    x = torch.from_numpy(_int_features(n, d, 1)).requires_grad_(True)
    y = t_tiled.make_streamed_aggregate(ex, op)(x)
    held = _held(ex)                  # the queues (and a mean's counts)
    cot = torch.ones_like(y)
    y.backward(cot)
    assert ex.stats.queue_launches == 1 and ex.stats.steps == 0
    assert ex._transposed is None and _held(ex) == held
    # x, y, G and dX, and a mean's two quotients
    live = 4 * n * d * (6 if op == "mean" else 4)
    scratch = 4 * ex._tq.n_split * (32 * d + d)
    assert held + live + scratch <= price
    xb = x.detach().clone().requires_grad_(True)
    yb = t_queue.tile_queue_plain(ex._tq, xb)
    if op == "mean":
        yb = yb / ex._counts_col()
    yb.backward(cot)
    np.testing.assert_allclose(x.grad.numpy(), xb.grad.numpy(), rtol=RTOL,
                               atol=ATOL)
    over = t_tiled.TiledExecutor(g, budget_bytes=price - 1, dim_hint=d, **kw)
    assert over.queue_plan(d, op, training=True) is None
    assert over.queue_plan(d, op) is not None


# -- the typed dense plan's price (ROADMAP C2) ------------------------------------

def _typed_graph(name):
    """Scaled-down stand-ins: AIFB's many relations over few vertices,
    and pubmed's R-MAT coloured with three relations."""
    if name == "aifb":
        n, e, r = 600, 3000, 45
        g = rmat_graph(n, e, seed=3)
        rel = np.random.default_rng(3).integers(0, r, g.num_edges)
    else:
        n, e, r = 900, 4000, RELS
        g = rmat_graph(n, e, seed=4)
        rel = (g.src.astype(np.int64) + g.dst) % r
    return COOGraph(n, g.src, g.dst, g.weights(), rel.astype(np.int32), r)


@pytest.mark.parametrize("name", ["aifb", "pubmed3"])
def test_typed_dense_plan_is_priced_at_what_it_holds(name):
    """The gate prices a typed dense plan at its typed keys and pads, so
    the plan it admits holds no more (the closed form of untyped tiles
    under-prices it), stays resident at that budget, trains a step
    within it, and spills to "tiled" one byte below it."""
    g = _typed_graph(name)
    dims = [8, 8, 4]
    (layer,) = rt.make_gnn_stack("rgcn", dims[:2], backend="blocked",
                                 tile=64, num_relations=g.num_relations,
                                 device="cpu")
    cfg = layer.cfg
    cfg.tile_format, cfg.training = "dense", True
    price = t_engn.typed_dense_bytes(g, 64, cfg.in_dim, cfg.out_dim, True)
    assert t_engn.gate_bytes(g, cfg, cfg.out_dim) == price
    closed = t_tiled.dense_footprint_bytes(
        g.num_vertices, g.num_edges, cfg.in_dim, cfg.out_dim, "blocked",
        tile=64, tile_format="dense", training=True)
    cfg.device_budget_bytes = price
    plan = rt.prepare_graph(g, cfg, device="cpu")
    assert plan.backend == "blocked"
    held = plan.held_bytes()
    assert held <= price
    assert closed < held or name == "pubmed3"
    x = torch.from_numpy(random_features(g.num_vertices, dims[0], seed=2))
    ps = {k: v.clone().requires_grad_(True)
          for k, v in stack_params([layer])[0].items()}
    torch.func.functional_call(layer, ps, (plan, x)).sum().backward()
    assert all(p.grad is not None for p in ps.values())
    assert plan.held_bytes() == held
    cfg.device_budget_bytes = price - 1
    assert rt.prepare_graph(g, cfg, device="cpu").backend == "tiled"


# -- the entry points train on "tiled" ----------------------------------------------

def _gnn_kw(steps, model="gcn"):
    return dict(model=model, dataset="pubmed", steps=steps, hidden=8,
                batch=64, max_vertices=300, max_edges=2000)


def _reference_run(backend, **kw):
    from repro.launch.train import build_gnn as j_build_gnn
    step, state, data, gd, aux = j_build_gnn(backend=backend, **kw)
    f, classes = aux["x"].shape[1], aux["num_classes"]
    teacher = j_models.init_stack(
        j_models.make_gnn_stack("gcn", [f, 16, classes]), jax.random.key(42))
    refs = {"student": [{k: np.asarray(v) for k, v in p.items()}
                        for p in state["params"]],
            "teacher": [{k: np.asarray(v) for k, v in p.items()}
                        for p in teacher]}
    losses, ps, opt = [], state["params"], state["opt"]
    for _ in range(kw["steps"]):
        ps, opt, m = step(ps, opt, next(data))
        losses.append(float(m["loss"]))
    return losses, gd, refs


def _port_run(backend, **kw):
    step, state, data, gd, aux = t_train.build_gnn(backend=backend,
                                                   device="cpu", **kw)
    losses, ps, opt = [], state["params"], state["opt"]
    for _ in range(kw["steps"]):
        ps, opt, m = step(ps, opt, next(data))
        losses.append(float(m["loss"]))
    return losses, gd


@pytest.mark.parametrize("model", ["gcn", "gs_pool", "rgcn", "gated_gcn"])
def test_gnn_training_trajectory_tiled_matches_reference(model):
    """A `build_gnn` run spilled to "tiled" by its budget follows the
    reference's spilled run from the reference's initial weights."""
    kw = dict(model=model, dataset="pubmed", steps=6, hidden=16, batch=64,
              max_vertices=300, max_edges=2500, device_budget_bytes=300_000)
    want, jgd, refs = _reference_run("blocked", **kw)
    got, tgd = _port_run("blocked", reference_params=refs, **kw)
    assert tgd.backend == jgd.backend == "tiled"
    assert tgd.meta["trainable"] is True
    np.testing.assert_allclose(got, want, rtol=TRAIN_RTOL, atol=TRAIN_ATOL)
    st, jst = (p.carrier["tiled_exec"].stats for p in (tgd, jgd))
    assert (st.bwd_tiles > 0, st.queue_builds) == (jst.bwd_tiles > 0,
                                                   jst.queue_builds)


def test_launcher_budget_spill_trains_streamed():
    """A blocked run whose budget the plan exceeds spills to "tiled" and
    trains along the segment run from the same weights (the reference's
    launcher case spills a ring; the port's ring spill is held in
    `tests/test_torch_ring_train.py`)."""
    kw = _gnn_kw(3)
    seg, _, refs = _reference_run("segment", **kw)
    spill, gd = _port_run("blocked", reference_params=refs,
                          device_budget_bytes=50_000, **kw)
    assert gd.backend == "tiled" and gd.meta["trainable"] is True
    assert all(np.isfinite(spill))
    np.testing.assert_allclose(spill, seg, rtol=TRAIN_RTOL, atol=TRAIN_ATOL)
    st = gd.carrier["tiled_exec"].stats
    assert st.bwd_tiles > 0 or st.queue_builds > 0


@pytest.mark.parametrize("case", ["tiled", "spill", "run_gnn", "rebuild",
                                  "apply_stack", "rgcn", "gated_gcn"])
def test_tiled_training_paths_run(case, tmp_path):
    """Every way a user reaches streamed training trains: `build_gnn` on
    "tiled" and by a spill, `run_gnn`, `ElasticGNNTrainer.rebuild`, a
    stack under autograd (a device tensor out) and the staged models."""
    if case == "run_gnn":
        args = argparse.Namespace(
            gnn="gcn", gnn_backend="tiled", gnn_shards=None, gnn_hidden=8,
            dataset="cora", device_budget=0, steps=2, batch=32,
            ckpt_dir=str(tmp_path), ckpt_every=2, chaos_seed=None,
            device="cpu")
        out = t_train.run_gnn(args)
        assert out["steps"] == 2 and all(np.isfinite(out["losses"]))
        return
    if case == "apply_stack":
        g = _float_graph(90, 500, seed=0)
        layers = rt.make_gnn_stack("gcn", [12, 8, 5], backend="tiled",
                                   tile=16, device="cpu")
        plan = rt.prepare_graph(g, layers[0].cfg, device="cpu")
        x = torch.from_numpy(random_features(90, 12, seed=1))
        y = rt.apply_stack(layers, plan, x)
        assert y.requires_grad
        y.sum().backward()
        assert all(p.grad is not None for ly in layers
                   for p in ly.parameters())
        return
    model = case if case in ("rgcn", "gated_gcn") else "gcn"
    backend = "blocked" if case == "spill" else "tiled"
    budget = 50_000 if case == "spill" else None
    step, state, data, gd, aux = t_train.build_gnn(
        backend=backend, device="cpu", device_budget_bytes=budget,
        **_gnn_kw(3, model))
    assert gd.backend == "tiled" and gd.meta["trainable"] is True
    if case == "rebuild":
        tr = aux["trainer"]
        assert isinstance(tr, t_elastic.ElasticGNNTrainer)
        gd = tr.rebuild()
        assert gd.backend == "tiled" and gd is tr.plan
    ps, opt, losses = state["params"], state["opt"], []
    for _ in range(3):
        ps, opt, m = step(ps, opt, next(data))
        losses.append(float(m["loss"]))
    assert all(np.isfinite(losses))
    st = gd.carrier["tiled_exec"].stats
    assert st.bwd_tiles > 0 or st.queue_builds > 0


# -- on the card ---------------------------------------------------------------------

def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("f", [3, 16, 50, 64, 70, 128])
@pytest.mark.parametrize("case", ["whole", "split", "long_split", "gap",
                                  "tall", "one_per_tile"])
def test_b5t_matches_plain_on_card(f, case):
    """B5^T at every lane mapping: whole source intervals of 1,000-2,000
    entries (a piece each), split ones (pieces of 64 entries, merged by
    the last to arrive; of 1,536), a source interval with no tile (its
    rows still stored), n not a multiple of T, a tall tile (T = 512, split
    at the default piece) and one-entry tiles (a piece's span of tiles as
    long as its entries); allclose, as the merges' atomics run in no fixed
    order."""
    dev = _card()
    tile = {"tall": 512, "one_per_tile": 4}.get(case, 64)
    if case == "one_per_tile":
        _, tq = _one_per_tile_queue(dev)
    else:
        _, _, tq = _queue(n=1500 if case == "tall" else 900,
                          e={"whole": 20000, "long_split": 30000}.get(
                              case, 9000), tile=tile,
                          piece={"whole": 4096, "long_split": 1536,
                                 "tall": None}.get(case, 64),
                          gap=case == "gap", device=dev)
    assert tq.n % tile != 0
    assert (tq.t_split > 0) == (case in ("split", "long_split", "gap",
                                         "tall"))
    g = torch.from_numpy(np.random.default_rng(f).standard_normal(
        (tq.n, f)).astype(np.float32)).to(dev)
    before = t_queue.LAUNCHES["sum_t"]
    got = t_queue.tile_queue_t(tq, g)
    want = t_queue.tile_queue_t_plain(tq, g)
    torch.cuda.synchronize()
    assert t_queue.LAUNCHES["sum_t"] == before + 1
    scale = float(want.abs().max())
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(),
                               rtol=RTOL, atol=RTOL * scale)


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["callback", "auto"])
@pytest.mark.parametrize("op", ["sum", "mean", "max"])
def test_card_streamed_grads_match_cpu(op, mode):
    """The card's streamed gradient (B5 and B5^T on the queue route for a
    sum and mean, the callback route otherwise) against the CPU's."""
    dev = _card()
    g = _float_graph(600, 6000, seed=3)
    x = _uniform((600, 24), seed=4)
    coef = _uniform((600, 24), seed=5)
    outs = []
    for d in ("cpu", dev):
        ex = t_tiled.TiledExecutor(g, tile=64, tile_format="packed",
                                   streaming_mode=mode, device=d)
        before = launch_counts()
        xx = torch.from_numpy(x).to(d).requires_grad_(True)
        y = t_tiled.make_streamed_aggregate(ex, op)(xx)
        (y * torch.from_numpy(coef).to(d)).sum().backward()
        grew = {k: v - before[k] for k, v in launch_counts().items()}
        outs.append((y.detach().cpu().numpy(), xx.grad.cpu().numpy()))
        if d != "cpu":
            queued = mode == "auto" and op != "max"
            assert (grew["chunk_queue_sum_t"] == 1) == queued
            assert (ex.stats.bwd_tiles > 0) == (not queued)
    for a, b in zip(*outs):
        np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-5)


@pytest.mark.cuda
def test_card_kernel_queue_route_stays_in_budget():
    """On the card an executor admitted at the queue route's training
    price keeps what it allocates over one forward and backward within
    that budget."""
    dev = _card()
    d = 64
    g = _float_graph(4096, 60000, seed=1)
    probe = t_tiled.TiledExecutor(g, tile=256, tile_format="packed",
                                  device=dev)
    price = probe.queue_plan(d, "sum", training=True).device_bytes
    del probe
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    ex = t_tiled.TiledExecutor(g, tile=256, tile_format="packed",
                               budget_bytes=price, dim_hint=d, device=dev)
    x = torch.from_numpy(_uniform((4096, d), seed=2)).to(dev)
    x.requires_grad_(True)
    y = t_tiled.make_streamed_aggregate(ex, "sum")(x)
    y.backward(torch.ones_like(y))
    torch.cuda.synchronize()
    assert ex.stats.queue_launches == 1 and ex._transposed is None
    assert torch.cuda.max_memory_allocated() - base <= price


@pytest.mark.cuda
@pytest.mark.parametrize("model", ["gcn", "gs_pool", "rgcn", "gated_gcn"])
def test_card_tiled_trajectory_matches_cpu(model):
    _card()
    losses = []
    for d in ("cpu", None):
        step, state, data, gd, _ = t_train.build_gnn(
            backend="tiled", device=d, **_gnn_kw(6, model))
        assert gd.backend == "tiled"
        ps, opt, out = state["params"], state["opt"], []
        for _ in range(6):
            ps, opt, m = step(ps, opt, next(data))
            out.append(float(m["loss"]))
        losses.append(out)
    np.testing.assert_allclose(losses[1], losses[0], rtol=TRAIN_RTOL,
                               atol=TRAIN_ATOL)
