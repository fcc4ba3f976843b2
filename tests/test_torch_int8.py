"""int8 tile values on the port against the reference, and the queue
kernels' interval limit (fault C3), on the CPU.

The quantisation is host numpy in both packages, so every quantised
array, scale and error-feedback residual is exactly equal: the
`quantize_*_np` outputs, `pack_quantized`, the int8 `ChunkQueue`, the
executors' `StreamingTileQuantizer.err` after two streamed aggregates
(the second sweep folds in the first's residual) and after a training
step (the transposed executor has its own), the resident plan's int8
flat values.  `TiledStats` are equal field for field.  The dequantised
values are the same floats on both sides, so a max is exactly equal;
sums, means, gradients and the tensor twins (`quantize_int8`,
`dequantize_int8`, `make_error_feedback_transform`) agree to fp32
allclose (rtol=1e-4, atol=1e-5; gradients 1e-5 / 1e-6), the frameworks
reducing in different orders.  The int8 envelope against fp32 (mean
relative error < 0.015, max < 0.15) is the reference's
(`tests/test_compression.py`).  The `cuda`-marked tests run on a card
only and skip here.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import engn as j_engn
from repro.core import models as j_models
from repro.core import tiled as j_tiled
from repro.distributed import compression as j_comp
from repro.graphs import partition as j_part
from repro.graphs.generate import make_dataset, random_features, rmat_graph
from repro.kernels.chunk_queue import ops as j_queue
import repro_torch as rt
from repro_torch.core import tiled as t_tiled
from repro_torch.distributed import compression as t_comp
from repro_torch.graphs import partition as t_part
from repro_torch.graphs.format import COOGraph
from repro_torch.interop import load_reference_params
from repro_torch.kernels import launch_counts
from repro_torch.kernels.chunk_queue import ops as t_queue

RTOL, ATOL = 1e-4, 1e-5             # sums, means, layer outputs
G_RTOL, G_ATOL = 1e-5, 1e-6         # gradients
ENVELOPE_MEAN, ENVELOPE_MAX = 0.015, 0.15


def _graph(n=200, e=1500, seed=7):
    """Deduplicated R-MAT graph with real-valued weights in [0.1, 2): the
    values int8 rounds (integer weights would quantise almost exactly)."""
    g = rmat_graph(n, e, seed=seed)
    uniq = np.unique(np.stack([g.src, g.dst]), axis=1)
    val = np.random.default_rng(seed).uniform(0.1, 2.0, uniq.shape[1])
    return COOGraph(n, uniq[0].astype(np.int32), uniq[1].astype(np.int32),
                    val.astype(np.float32))


def _x(n, f, seed=8):
    return np.random.default_rng(seed).normal(0, 1, (n, f)).astype(
        np.float32)


def _stats(stats):
    return dataclasses.asdict(stats)


def _err(ex):
    return None if ex.quantizer is None else ex.quantizer.err.copy()


def _same(got, want):
    assert got.dtype == want.dtype, (got.dtype, want.dtype)
    np.testing.assert_array_equal(got, want)


def _rel_err(got, want):
    rel = np.abs(got - want) / np.maximum(np.abs(want), 1.0)
    return float(rel.mean()), float(rel.max())


# -- the host quantisers -------------------------------------------------------

@pytest.mark.parametrize("case", ["normal", "zeros", "empty", "feedback"])
def test_quantize_int8_np_equals_reference(case):
    rng = np.random.default_rng(0)
    x = {"normal": rng.normal(0, 3.0, 4096), "zeros": np.zeros(8),
         "empty": np.zeros(0), "feedback": rng.uniform(-1, 1, 300)}[case]
    x = x.astype(np.float32)
    err = (rng.uniform(-0.01, 0.01, x.size).astype(np.float32)
           if case == "feedback" else None)
    jq, js, je = j_comp.quantize_int8_np(x, err)
    tq, ts, te = t_comp.quantize_int8_np(x, err)
    _same(tq, jq)
    assert ts == js
    _same(te, je)


@pytest.mark.parametrize("offset", [0, 5])
def test_streaming_quantizer_and_stream_equal_reference(offset):
    """Entry ranges quantised twice (the residual feeds the second pass),
    then a (steps, slab) stream whose last row pads past the buffer."""
    rng = np.random.default_rng(2)
    m, slab, steps = 700, 256, 3
    flat = rng.uniform(-2, 2, m).astype(np.float32)
    jqz = j_comp.StreamingTileQuantizer(m + offset)
    tqz = t_comp.StreamingTileQuantizer(m + offset)
    for lo, hi in ((0, 100), (100, 700), (0, 100)):
        jq, js = jqz.quantize_range(flat[lo:hi], lo, hi)
        tq, ts = tqz.quantize_range(flat[lo:hi], lo, hi)
        _same(tq, jq)
        assert ts == js
    _same(tqz.err, jqz.err)
    padded = np.zeros(steps * slab, np.float32)
    padded[:m] = flat
    v2d = padded.reshape(steps, slab)
    for jz, tz in ((None, None), (jqz, tqz)):
        jq, js = j_comp.quantize_stream_np(v2d, jz, entry_offset=offset)
        tq, ts = t_comp.quantize_stream_np(v2d, tz, entry_offset=offset)
        _same(tq, jq)
        _same(ts, js)
    _same(tqz.err, jqz.err)
    tqz.reset()
    assert not tqz.err.any()


def test_tensor_twins_match_reference():
    """quantize_int8 / dequantize_int8 and three steps of the
    error-feedback transform over a dict and a list of gradients."""
    rng = np.random.default_rng(3)
    x = rng.normal(0, 2, (64, 33)).astype(np.float32)
    jq, js = j_comp.quantize_int8(jnp.asarray(x))
    tq, ts = t_comp.quantize_int8(torch.from_numpy(x))
    assert tq.dtype == torch.int8
    _same(tq.numpy(), np.asarray(jq))
    np.testing.assert_allclose(float(ts), float(js), rtol=1e-6)
    np.testing.assert_allclose(
        t_comp.dequantize_int8(tq, ts).numpy(),
        np.asarray(j_comp.dequantize_int8(jq, js)), rtol=RTOL, atol=ATOL)
    shapes = {"w": (12, 7), "b": (7,), "v": (3, 4, 5)}
    for kind in ("dict", "list"):
        jt, jinit = j_comp.make_error_feedback_transform()
        tt, tinit = t_comp.make_error_feedback_transform()
        grads = [{k: rng.normal(0, 1, s).astype(np.float32)
                  for k, s in shapes.items()} for _ in range(3)]
        if kind == "list":
            grads = [list(gr.values()) for gr in grads]

        def as_t(tree):
            if isinstance(tree, dict):
                return {k: torch.from_numpy(v) for k, v in tree.items()}
            return [torch.from_numpy(v) for v in tree]

        def leaves(tree):
            return ([tree[k] for k in sorted(tree)]
                    if isinstance(tree, dict) else list(tree))

        jerr = jinit(jax.tree.map(jnp.asarray, grads[0]))
        terr = tinit(as_t(grads[0]))
        assert type(terr) is type(grads[0])
        for gr in grads:
            jout, jerr = jt(jax.tree.map(jnp.asarray, gr), jerr)
            tout, terr = tt(as_t(gr), terr)
            for a, b in zip(leaves(tout) + leaves(terr),
                            leaves(jout) + leaves(jerr)):
                np.testing.assert_allclose(a.numpy(), np.asarray(b),
                                           rtol=RTOL, atol=ATOL)
        assert t_comp.compression_ratio(as_t(grads[0])) == \
            j_comp.compression_ratio(jax.tree.map(jnp.asarray, grads[0]))


# -- carriers --------------------------------------------------------------------

@pytest.mark.parametrize("floor", [1, 8])
@pytest.mark.parametrize("feedback", [False, True])
def test_pack_quantized_equals_reference(floor, feedback):
    """Staged groups with an empty tile slot (-1) and spare width, twice
    over the same tiles: with a quantiser the second staging differs (the
    residual is folded in), and its buffer is the reference's."""
    g = _graph()
    jp = j_part.pack_tile_store(j_part.build_tile_store(g, 32))
    tp = t_part.pack_tile_store(t_part.build_tile_store(g, 32))
    jqz = j_comp.StreamingTileQuantizer(jp.nnz) if feedback else None
    tqz = t_comp.StreamingTileQuantizer(tp.nnz) if feedback else None
    groups = [np.arange(tp.nnzb)[::3], np.array([0, -1, 2]), np.array([])]
    for tiles in groups + groups[:1]:
        width = max(len(tiles), 1) + 1
        bucket = tp.bucket_of(tiles, floor)
        want = jp.pack_quantized(tiles, width, bucket, jqz)
        got = tp.pack_quantized(tiles, width, bucket, tqz)
        for a, b in zip(got, want):
            _same(a, b)
        if feedback:
            _same(tqz.err, jqz.err)
    if feedback:
        assert tqz.err.any()


@pytest.mark.parametrize("slab", [None, 64, 1000])
def test_int8_chunk_queue_equals_reference(slab):
    """Two builds with one quantiser (the rebuild folds the residual in):
    slabs, scales and residuals exactly equal; the sweep allclose."""
    packed = t_part.pack_tile_store(t_part.build_tile_store(_graph(), 16))
    jqz = j_comp.StreamingTileQuantizer(packed.nnz)
    tqz = t_comp.StreamingTileQuantizer(packed.nnz)
    x = _x(packed.num_vertices, 6)
    for _ in range(2):
        jq = j_queue.build_chunk_queue(packed, slab=slab, value_dtype="int8",
                                       quantizer=jqz)
        tq = t_queue.build_chunk_queue(packed, slab=slab, value_dtype="int8",
                                       quantizer=tqz, device="cpu")
        for name in ("n", "entries", "steps", "slab", "value_dtype"):
            assert getattr(tq, name) == getattr(jq, name), name
        for name in ("gsrc", "gdst", "vals", "scales"):
            _same(getattr(tq, name).numpy(), np.asarray(getattr(jq, name)))
        assert tq.vals.dtype == torch.int8
        assert tq.device_bytes() == jq.device_bytes()
        assert tq.raw_value_bytes() == jq.raw_value_bytes()
        _same(tqz.err, jqz.err)
        for op in ("sum", "max"):
            want = np.asarray(j_queue.queue_sweep_xla(
                jq.gsrc, jq.gdst, jq.vals, jq.scales, jnp.asarray(x),
                n=jq.n, op=op))
            got = t_queue.queue_sweep_plain(tq.gsrc, tq.gdst, tq.vals,
                                            tq.scales, torch.from_numpy(x),
                                            n=tq.n, op=op).numpy()
            if op == "max":
                _same(got, want)
            else:
                np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    with pytest.raises(ValueError):
        t_queue.build_chunk_queue(packed, value_dtype="bf16", device="cpu")


# -- the executor ------------------------------------------------------------------

def _executor_cases():
    for mode in ("callback", "auto"):
        for order in ("column", "row"):
            for op in ("sum", "max", "mean"):
                yield mode, order, op


@pytest.mark.parametrize("mode,order,op", list(_executor_cases()))
@pytest.mark.parametrize("impls", [(None, None), ("pallas", "cuda")],
                         ids=["default", "kernel-route"])
def test_int8_aggregate_stats_and_feedback_equal_reference(mode, order, op,
                                                           impls):
    """Two consecutive aggregates on each route: outputs (max exactly),
    every `TiledStats` counter (the quantised and raw value bytes among
    them) and the quantiser's residuals after each, exactly.  On the
    kernel route an int8 queue builds no TileQueue, on either side."""
    g = _graph()
    x = _x(g.num_vertices, 6)
    jimpl, timpl = impls
    kw = dict(tile=32, chunk=3, tile_format="packed", streaming_mode=mode,
              value_dtype="int8")
    je = j_tiled.TiledExecutor(g, impl=jimpl, **kw)
    te = t_tiled.TiledExecutor(g, impl=timpl, device="cpu", **kw)
    for _ in range(2):
        want = je.aggregate(x, op, order=order)
        got = te.aggregate(torch.from_numpy(x), op, order=order).numpy()
        if op == "max":
            _same(got, want)
        else:
            np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
        assert _stats(te.stats) == _stats(je.stats)
        _same(_err(te), _err(je))
    assert te._tq is None and je._tq is None
    assert (te.stats.queue_launches > 0) == (mode == "auto")
    assert te.stats.value_compression() < 0.3
    assert te.quantizer.err.any()


def test_int8_envelope_against_fp32_and_segment():
    """The reference's documented int8 tolerance, both routes, against
    the fp32 executor and the segment sum."""
    g = _graph(300, 1500, seed=7)
    x = _x(g.num_vertices, 16)
    ref = np.zeros_like(x)
    np.add.at(ref, g.dst, x[g.src] * g.val[:, None])
    for mode in ("callback", "auto"):
        kw = dict(tile=64, chunk=4, tile_format="packed",
                  streaming_mode=mode, device="cpu")
        fp32 = t_tiled.TiledExecutor(g, **kw).aggregate(x, "sum").numpy()
        ex = t_tiled.TiledExecutor(g, value_dtype="int8", **kw)
        out = ex.aggregate(x, "sum").numpy()
        for want in (fp32, ref):
            mean, worst = _rel_err(out, want)
            assert mean < ENVELOPE_MEAN and worst < ENVELOPE_MAX, (mode,
                                                                  mean, worst)
        assert ex.stats.value_compression() < 0.3


def test_int8_needs_a_packed_store():
    g = _graph(100, 400, seed=9)
    for mod, kw in ((j_tiled, {}), (t_tiled, {"device": "cpu"})):
        with pytest.raises(ValueError, match="int8"):
            mod.TiledExecutor(g, tile=64, tile_format="dense",
                              value_dtype="int8", **kw)
    ex = t_tiled.TiledExecutor(g, tile=64, value_dtype="int8", device="cpu")
    assert ex.quantizer is not None and ex.quantizer.err.size == \
        ex.packed.nnz


def _port_grad(fn, x, coef):
    xx = torch.from_numpy(x).requires_grad_(True)
    y = fn(xx)
    (y * torch.from_numpy(coef)).sum().backward()
    return y.detach().numpy(), xx.grad.numpy()


def _ref_grad(fn, x, coef):
    y, vjp = jax.vjp(fn, jnp.asarray(x))
    (gx,) = vjp(jnp.asarray(coef))
    return np.asarray(y), np.asarray(gx)


@pytest.mark.parametrize("mode", ["callback", "auto"])
@pytest.mark.parametrize("op", ["sum", "mean", "max"])
def test_int8_streamed_grads_and_feedback_equal_reference(op, mode):
    """One training step's aggregate through the differentiable streamed
    wrappers: output and gradient allclose (a max's output exactly), the
    forward's and the backward's `TiledStats` and the forward and
    transposed executors' residuals exactly equal.  mode "auto" is the
    queue route (the int8 slab sweep, differentiated by autograd, on
    either side); "callback" re-streams the transposed executor's
    quantised tiles."""
    n, d = 150, 6
    g = _graph(n, 900, seed=2)
    x = _x(n, d, seed=2)
    coef = _x(n, d, seed=3)
    kw = dict(tile=16, chunk=3, tile_format="packed", streaming_mode=mode,
              value_dtype="int8")
    je = j_tiled.TiledExecutor(g, **kw)
    te = t_tiled.TiledExecutor(g, device="cpu", **kw)
    want_y, want = _ref_grad(j_tiled.make_streamed_aggregate(je, op), x,
                             coef)
    got_y, got = _port_grad(t_tiled.make_streamed_aggregate(te, op), x,
                            coef)
    if op == "max":
        _same(got_y, want_y)
    else:
        np.testing.assert_allclose(got_y, want_y, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(got, want, rtol=G_RTOL, atol=G_ATOL)
    assert _stats(te.stats) == _stats(je.stats)
    _same(_err(te), _err(je))
    queued = mode == "auto"          # a max too: the slab sweep on the CPU
    assert (te.stats.bwd_tiles > 0) == (not queued)
    if not queued:
        _same(_err(te.transposed()), _err(je.transposed()))
        assert te.transposed().quantizer is not te.quantizer


@pytest.mark.parametrize("mode", ["callback", "auto"])
def test_int8_tiled_training_step_matches_reference(mode):
    """A GCN layer on `tiled` with int8 values under autograd: the loss
    gradient of every parameter and the input against `jax.grad` through
    the reference's layer on the same weights and plan."""
    g = _graph(120, 800, seed=4)
    x = _x(120, 8, seed=4)
    coef = _x(120, 5, seed=5)
    jl = j_models.make_gnn_stack("gcn", [8, 5], backend="tiled", tile=16)
    tl = rt.make_gnn_stack("gcn", [8, 5], backend="tiled", tile=16,
                           device="cpu")
    for cfg in (jl[0].cfg, tl[0].cfg):
        cfg.tile_format, cfg.tile_value_dtype = "packed", "int8"
        cfg.streaming_mode, cfg.training = mode, True
    jp = j_models.init_stack(jl, jax.random.key(0))
    load_reference_params(tl, [{k: np.asarray(v) for k, v in p.items()}
                               for p in jp])
    jplan = j_engn.prepare_graph(g, jl[0].cfg)
    tplan = rt.prepare_graph(g, tl[0].cfg, device="cpu")
    assert tplan.carrier["tiled_exec"].value_dtype == "int8"

    def jloss(params, xx):
        return jnp.sum(j_models.apply_stack(jl, params, jplan, xx)
                       * jnp.asarray(coef))

    jgp, jgx = jax.grad(jloss, argnums=(0, 1))(jp, jnp.asarray(x))
    xx = torch.from_numpy(x).requires_grad_(True)
    (rt.apply_stack(tl, tplan, xx) * torch.from_numpy(coef)).sum().backward()
    np.testing.assert_allclose(xx.grad.numpy(), np.asarray(jgx),
                               rtol=1e-4, atol=1e-5)
    for name, p in tl[0].named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), np.asarray(jgp[0][name]),
                                   rtol=1e-4, atol=1e-5)
    tex, jex = tplan.carrier["tiled_exec"], jplan.carrier["tiled_exec"]
    assert _stats(tex.stats) == _stats(jex.stats)
    _same(_err(tex), _err(jex))


def test_int8_queue_plan_prices_no_walker():
    """On the kernel route an int8 queue never takes the walker, so its
    price is the reference's slab queue alone: the same plans under every
    budget, where the fp32 kernel route (TileQueue and working set
    priced) declines sooner."""
    g = _graph(300, 2500, seed=1)
    kw = dict(tile=32, tile_format="packed", dim_hint=16)
    seen_fp32_decline = False
    for budget in (None, 60_000, 90_000, 150_000, 400_000):
        je = j_tiled.TiledExecutor(g, budget_bytes=budget,
                                   value_dtype="int8", **kw)
        te = t_tiled.TiledExecutor(g, budget_bytes=budget, impl="cuda",
                                   value_dtype="int8", device="cpu", **kw)
        fp = t_tiled.TiledExecutor(g, budget_bytes=budget, impl="cuda",
                                   device="cpu", **kw)
        for d in (4, 16):
            jp, tp = je.queue_plan(d), te.queue_plan(d)
            assert (tp is None) == (jp is None), (budget, d)
            if jp is not None:
                assert dataclasses.asdict(tp) == dataclasses.asdict(jp)
                seen_fp32_decline |= fp.queue_plan(d) is None
    assert seen_fp32_decline


# -- the resident plan -------------------------------------------------------------

def _stack(backend, fmt, vd, contract_model="gcn", dims=(12, 6)):
    jl = j_models.make_gnn_stack(contract_model, list(dims), backend=backend,
                                 tile=16)
    tl = rt.make_gnn_stack(contract_model, list(dims), backend=backend,
                           tile=16, device="cpu")
    for a, b in zip(jl, tl):
        for cfg in (a.cfg, b.cfg):
            cfg.tile_format, cfg.tile_value_dtype = fmt, vd
    jp = j_models.init_stack(jl, jax.random.key(0))
    load_reference_params(tl, [{k: np.asarray(v) for k, v in p.items()}
                               for p in jp])
    return jl, jp, tl


def _distinct(g):
    """`g` with each (src, dst) pair once, in key order, at its first
    copy's weight: the neighbour sets a max plan of the port holds,
    drawn here with numpy (the reference's carriers merge repeats by
    summing)."""
    key = g.dst.astype(np.int64) * g.num_vertices + g.src
    _, first = np.unique(key, return_index=True)
    return type(g)(g.num_vertices, g.src[first], g.dst[first],
                   None if g.val is None else g.val[first])


def _real_graph(n=120, f=12, seed=0):
    g, _, _ = make_dataset("cora", seed=seed, max_vertices=n, feature_dim=f)
    return g.gcn_normalized(), random_features(n, f, seed=1)


@pytest.mark.parametrize("model", ["gcn", "gs_pool", "gated_gcn"])
def test_int8_resident_plan_equals_reference(model):
    """A blocked packed plan with int8 values on the CPU: the flat route
    holds int8 values and one scale (the gated contract keeps fp32, as
    the reference's does), its carrier and `blocks_meta` (with
    `value_dtype` and `device_bytes`) equal the reference's, and the
    layer stack agrees with the reference's."""
    g, x = _real_graph()
    jl, jp, tl = _stack("blocked", "packed", "int8", model, (12, 6))
    # a max plan holds the distinct edges: the reference is handed them
    jg = _distinct(g) if model == "gs_pool" else g
    jplan = j_engn.prepare_graph(jg, jl[0].cfg)
    tplan = rt.prepare_graph(g, tl[0].cfg, device="cpu")
    jc, tc = jplan.carrier, tplan.carrier
    assert set(tc) - {"device"} == set(jc)
    assert tc["blocks_meta"]["value_dtype"] == (
        "fp32" if model == "gated_gcn" else "int8")
    jm = {k: v for k, v in jc["blocks_meta"].items() if k != "format_choice"}
    tm = {k: v for k, v in tc["blocks_meta"].items() if k != "format_choice"}
    assert tm == jm
    for a, b in zip(tc["packed_flat"], jc["packed_flat"]):
        _same(a.numpy(), np.asarray(b))
    assert tc.get("packed_val_scale") == jc.get("packed_val_scale")
    want = np.asarray(j_models.apply_stack(jl, jp, jplan, jnp.asarray(x)))
    with torch.no_grad():
        got = rt.apply_stack(tl, tplan, torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


def test_int8_resident_aggregate_within_the_envelope():
    """The int8 flat aggregate against the fp32 plan's: dequantised by the
    one scale, within the reference's envelope; a max exactly equal to
    the reference's."""
    g, _ = _real_graph(seed=2)
    feat = _x(g.num_vertices, 6, seed=3)
    for op in ("sum", "max"):
        jl, _, tl = _stack("blocked", "packed", "int8")
        _, _, tf = _stack("blocked", "packed", "fp32")
        for cfg in (jl[0].cfg, tl[0].cfg, tf[0].cfg):
            cfg.aggregate_op = op
        got = tl[0]._aggregate(rt.prepare_graph(g, tl[0].cfg, device="cpu"),
                               torch.from_numpy(feat)).numpy()
        fp32 = tf[0]._aggregate(rt.prepare_graph(g, tf[0].cfg, device="cpu"),
                                torch.from_numpy(feat)).numpy()
        jg = _distinct(g) if op == "max" else g
        want = np.asarray(jl[0]._aggregate(j_engn.prepare_graph(jg,
                                                                jl[0].cfg),
                                           jnp.asarray(feat)))
        if op == "max":
            _same(got, want)
        else:
            np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
        mean, worst = _rel_err(got, fp32)
        assert mean < ENVELOPE_MEAN and worst < ENVELOPE_MAX


def test_int8_tiled_plan_meta_equals_reference():
    g, _ = _real_graph()
    jl, _, tl = _stack("tiled", "packed", "int8")
    jm = j_engn.prepare_graph(g, jl[0].cfg).carrier["tiled_meta"]
    tm = rt.prepare_graph(g, tl[0].cfg, device="cpu").carrier["tiled_meta"]
    assert tm["value_dtype"] == "int8"
    for key in ("q", "tile", "chunk", "order", "host_bytes", "tile_format",
                "streaming_mode", "value_dtype", "queue_plan"):
        assert tm[key] == jm[key], key
    assert tm["format_choice"].as_dict() == jm["format_choice"].as_dict()


# -- fault C3: the queue kernels' interval limit ----------------------------------

def test_feature_chunk_and_the_shared_predicate():
    fc = t_queue.feature_chunk
    assert fc(2048, 64) == 16 and fc(32768, 64) == 1
    assert (fc(256, 64), fc(256, 50), fc(256, 3), fc(256, 128)) == (64, 64,
                                                                     4, 128)
    assert fc(1024, 64) == 32 and fc(512, 128) == 64
    for t in (64, 256, 1816, 2048, 4096, 14520, 32768):
        for f in (1, 3, 16, 33, 64, 200):
            c = fc(t, f)
            assert c >= 1 and c & (c - 1) == 0
            assert t * min(c, f) * 4 <= t_queue._SMEM_MAX
            if c < 128 and c < f:       # the widest that fits
                assert t * min(2 * c, f) * 4 > t_queue._SMEM_MAX
    assert t_queue.queue_kernels_take(2048)
    assert t_queue.queue_kernels_take(t_queue.TILE_MAX)
    assert not t_queue.queue_kernels_take(t_queue.TILE_MAX + 1)
    assert not t_queue.queue_kernels_take(65536)


@pytest.mark.parametrize("tile", [2048, 65536])
def test_queue_plan_on_the_kernel_route_follows_the_predicate(tile):
    """impl="cuda" on a CPU executor (the kernels' plain versions): at
    T = 2048 the kernel route keeps the queue (B5 then takes 16 features a
    pass at F = 64); past TILE_MAX it declines it (the callback loop runs,
    the result unchanged) or, under streaming_mode="chunk_queue", raises.
    The plain route, fp32 or int8, keeps the reference's plan."""
    g = _graph(3000, 6000, seed=5)
    x = _x(3000, 64)
    d = 64
    je = j_tiled.TiledExecutor(g, tile=tile, tile_format="packed")
    jplan = je.queue_plan(d)
    assert jplan is not None
    kernel = t_tiled.TiledExecutor(g, tile=tile, tile_format="packed",
                                   impl="cuda", device="cpu")
    takes = t_queue.queue_kernels_take(tile)
    assert (kernel.queue_plan(d) is not None) == takes
    assert (kernel.queue_plan(d, training=True) is not None) == takes
    for vd in ("fp32", "int8"):
        plain = t_tiled.TiledExecutor(g, tile=tile, tile_format="packed",
                                      value_dtype=vd, device="cpu")
        want = j_tiled.TiledExecutor(g, tile=tile, tile_format="packed",
                                     value_dtype=vd).queue_plan(d)
        assert dataclasses.asdict(plain.queue_plan(d)) == \
            dataclasses.asdict(want)
    int8_kernel = t_tiled.TiledExecutor(g, tile=tile, tile_format="packed",
                                        impl="cuda", value_dtype="int8",
                                        device="cpu")
    assert int8_kernel.queue_plan(d) is not None
    strict = t_tiled.TiledExecutor(g, tile=tile, tile_format="packed",
                                   impl="cuda", streaming_mode="chunk_queue",
                                   device="cpu")
    if takes:
        assert strict.queue_plan(d) is not None
    else:
        with pytest.raises(t_tiled.DeviceBudgetExceeded, match="32768"):
            strict.queue_plan(d)
    got = kernel.aggregate(x, "sum").numpy()
    np.testing.assert_allclose(got, je.aggregate(x, "sum"), rtol=RTOL,
                               atol=ATOL)
    assert (kernel.stats.queue_launches > 0) == takes
    assert (kernel.stats.steps > 0) == (not takes)


def test_the_streamed_gcn_sum_at_tile_2048_runs_the_queue_route():
    """The C3 configuration on the CPU with the kernels' plain versions:
    a packed tiled GCN plan at T = 2048, no budget, streaming_mode
    "auto", F = 64, forward and backward on the queue route (B5 and B5^T
    through their plain versions), against segment."""
    g = _graph(3000, 6000, seed=6)
    x = _x(3000, 64)
    coef = _x(3000, 64, seed=9)
    ex = t_tiled.TiledExecutor(g, tile=2048, tile_format="packed",
                               impl="cuda", device="cpu")
    before = launch_counts()
    got_y, got = _port_grad(t_tiled.make_streamed_aggregate(ex, "sum"), x,
                            coef)
    assert ex.stats.queue_launches == 1 and ex.stats.bwd_tiles == 0
    assert ex._tq is not None and ex._tq.tile == 2048
    assert launch_counts() == before         # plain versions on the CPU
    ref = np.zeros_like(x)
    np.add.at(ref, g.dst, x[g.src] * g.val[:, None])
    gref = np.zeros_like(x)
    np.add.at(gref, g.src, coef[g.dst] * g.val[:, None])
    np.testing.assert_allclose(got_y, ref, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(got, gref, rtol=RTOL, atol=ATOL)


# -- on the card -------------------------------------------------------------------

def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("tile,f", [(2048, 64), (2048, 3), (4096, 64),
                                    (4096, 50), (32768, 5)])
def test_b5_and_b5t_at_tall_tiles_on_card(tile, f):
    """B5 takes `feature_chunk(T, F)` features a pass (16 at T = 2048 and
    F = 64; one lane per feature at T = 32,768) and B5^T its source
    walk, each against its plain version; whole intervals and intervals
    split in pieces of 512 entries."""
    dev = _card()
    n = max(3 * tile // 2, 6000)
    g = _graph(n, 4 * n, seed=tile % 97)
    x = torch.from_numpy(_x(n, f)).to(dev)
    built = t_queue.build_tile_queue(
        t_part.pack_tile_store(t_part.build_tile_store(g, tile)), device=dev)
    for segment in (t_queue.SEGMENT, 512):
        tq = built if segment == t_queue.SEGMENT else dataclasses.replace(
            built, **dict(zip(("pieces", "wrows", "wsrc", "wvals", "n_split"),
                              _pieces(built, segment, dev))))
        before = dict(t_queue.LAUNCHES)
        got = t_queue.tile_queue_aggregate(tq, x)
        gt = t_queue.tile_queue_t(tq, x)
        torch.cuda.synchronize()
        assert t_queue.LAUNCHES["sum"] == before["sum"] + 1
        assert t_queue.LAUNCHES["sum_t"] == before["sum_t"] + 1
        # sums in another order (atomics in none): within 1e-5 of the
        # output's largest magnitude, the B5^T tests' convention
        for y, want in ((got, t_queue.tile_queue_plain(tq, x)),
                        (gt, t_queue.tile_queue_t_plain(tq, x))):
            scale = float(want.abs().max())
            np.testing.assert_allclose(y.cpu().numpy(), want.cpu().numpy(),
                                       rtol=RTOL, atol=G_RTOL * scale)


def _pieces(tq, segment, dev):
    """B5's work table rebuilt at `segment` entries a piece."""
    host = [a.cpu().numpy() for a in (tq.tile_ptr, tq.tile_src,
                                      tq.entry_ptr, tq.rows, tq.cols,
                                      tq.vals)]
    pieces = t_queue.queue_segments(host[0], host[2].astype(np.int64),
                                    segment)
    _, wrows, wsrc, wvals, _ = t_queue.queue_work(
        host[0], host[1], host[2].astype(np.int64), *host[3:], tq.tile)
    return (torch.from_numpy(pieces).to(dev), torch.from_numpy(wrows).to(dev),
            torch.from_numpy(wsrc).to(dev), torch.from_numpy(wvals).to(dev),
            t_queue.split_count(pieces))


@pytest.mark.cuda
def test_the_streamed_gcn_sum_at_tile_2048_on_card():
    """Fault C3 on the card: the packed tiled GCN sum at T = 2048, no
    budget, streaming_mode "auto", F = 64 takes the queue route, forward
    B5 and backward B5^T, and agrees with the plain queue and the CPU's
    segment sum."""
    dev = _card()
    g = _graph(5000, 30000, seed=6)
    x = _x(5000, 64)
    coef = _x(5000, 64, seed=9)
    layers = rt.make_gnn_stack("gcn", [64, 64], backend="tiled", tile=2048)
    cfg = layers[0].cfg
    cfg.tile_format, cfg.streaming_mode = "packed", "auto"
    ex = rt.prepare_graph(g, cfg).carrier["tiled_exec"]
    assert ex.store.tile == 2048 and ex.device.type == "cuda"
    before = launch_counts()
    xx = torch.from_numpy(x).to(dev).requires_grad_(True)
    y = t_tiled.make_streamed_aggregate(ex, "sum")(xx)
    (y * torch.from_numpy(coef).to(dev)).sum().backward()
    torch.cuda.synchronize()
    after = launch_counts()
    assert after["chunk_queue_sum"] == before["chunk_queue_sum"] + 1
    assert after["chunk_queue_sum_t"] == before["chunk_queue_sum_t"] + 1
    assert ex.stats.bwd_tiles == 0
    np.testing.assert_allclose(
        y.detach().cpu().numpy(),
        t_queue.tile_queue_plain(ex._tq, xx.detach()).cpu().numpy(),
        rtol=RTOL, atol=ATOL)
    ref = np.zeros_like(x)
    np.add.at(ref, g.dst, x[g.src] * g.val[:, None])
    gref = np.zeros_like(x)
    np.add.at(gref, g.src, coef[g.dst] * g.val[:, None])
    np.testing.assert_allclose(y.detach().cpu().numpy(), ref, rtol=RTOL,
                               atol=ATOL)
    np.testing.assert_allclose(xx.grad.cpu().numpy(), gref, rtol=RTOL,
                               atol=ATOL)


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["callback", "auto"])
@pytest.mark.parametrize("op", ["sum", "max", "mean"])
def test_int8_routes_on_card_match_cpu(mode, op):
    """The int8 executor on the card against the CPU port on the route
    the card takes: `TiledStats` and the residuals equal, outputs
    allclose (a max exactly), over two aggregates.  A sum or mean on the
    queue route is the slab sweep on the card; a max there streams (the
    callback loop, divergence 2), so its twin is the CPU's callback
    loop: the int8 values are quantised per tile there, per slab on a
    queue."""
    dev = _card()
    g = _graph(600, 5000, seed=3)
    x = _x(600, 20, seed=3)
    kw = dict(tile=64, chunk=4, tile_format="packed", value_dtype="int8")
    card = t_tiled.TiledExecutor(g, device=dev, streaming_mode=mode, **kw)
    # a max on the card streams: its CPU twin is the callback loop
    cpu = t_tiled.TiledExecutor(
        g, device="cpu", streaming_mode="callback" if op == "max" else mode,
        **kw)
    for order in ("column", "row"):
        want = cpu.aggregate(x, op, order=order).numpy()
        got = card.aggregate(torch.from_numpy(x).to(dev), op,
                             order=order).numpy()
        if op == "max":
            _same(got, want)
        else:
            np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
        _same(_err(card), _err(cpu))
    assert _stats(card.stats) == _stats(cpu.stats)
    assert card._tq is None


@pytest.mark.cuda
@pytest.mark.parametrize("model", ["gcn", "gs_pool"])
def test_int8_blocked_plan_on_card_keeps_fp32_groups(model):
    """A CUDA plan's bucket groups stay fp32 under tile_value_dtype="int8"
    (the reference's TPU groups do): the groups equal the fp32 plan's,
    and so does the aggregate (exactly for a max, which B2 takes in any
    order; a sum to the atomics' rounding)."""
    dev = _card()
    g, _ = _real_graph(n=600)
    feat = torch.from_numpy(_x(600, 12, seed=4)).to(dev)
    outs, plans = [], []
    for vd in ("fp32", "int8"):
        layers = rt.make_gnn_stack(model, [12, 6], backend="blocked",
                                   tile=64)
        layers[0].cfg.tile_format = "packed"
        layers[0].cfg.tile_value_dtype = vd
        plan = rt.prepare_graph(g, layers[0].cfg)
        assert plan.carrier["blocks_meta"]["value_dtype"] == "fp32"
        assert "packed_groups" in plan.carrier
        plans.append(plan)
        with torch.no_grad():
            outs.append(layers[0]._aggregate(plan, feat))
    for a, b in zip(plans[0].carrier["packed_groups"],
                    plans[1].carrier["packed_groups"]):
        for k in ("rows", "cols", "vals", "block_row", "block_col"):
            assert torch.equal(a[k], b[k])
    if model == "gs_pool":
        assert torch.equal(outs[0], outs[1])
    else:
        np.testing.assert_allclose(outs[0].cpu().numpy(),
                                   outs[1].cpu().numpy(), rtol=RTOL,
                                   atol=ATOL)


@pytest.mark.cuda
def test_measured_choice_on_card():
    """TiledExecutor(autotune_measure=True) on the card times B2's tile
    part (its launches counted) against the einsum and caches the choice
    per graph fingerprint."""
    from repro_torch.kernels import autotune
    dev = _card()
    g = _graph(2000, 20000, seed=1)
    autotune._MEASURED.clear()
    before = launch_counts()["rer_gather_tile_part_sum"]
    ex = t_tiled.TiledExecutor(g, tile=128, autotune_measure=True,
                               dim_hint=32, device=dev)
    assert ex.format_choice.reason == "measured"
    assert launch_counts()["rer_gather_tile_part_sum"] > before
    key = autotune._fingerprint(ex.packed, "tiled", 32)
    assert autotune._MEASURED[key].fmt == ex.format_choice.fmt
    again = launch_counts()["rer_gather_tile_part_sum"]
    t_tiled.TiledExecutor(g, tile=128, autotune_measure=True, dim_hint=32,
                          device=dev)
    assert launch_counts()["rer_gather_tile_part_sum"] == again
