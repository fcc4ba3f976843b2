"""The sharded ring backend on the port (`core/dataflow.py`,
`distributed/sharding.py`, `prepare_ring`, serving's ring gate) against
the reference, on the CPU.

The JAX side runs in this process under conftest's forced 8-device view
with P = min(len(jax.devices()), 4) shards, plus a P = 3 ring on an
uneven 93-vertex graph at tile 4 (`tests/test_ring_dataflow.py`'s
`_SUBPROC_TILED` graph).  The port co-locates its P shards on the CPU.

- The host carriers (`RingTileShards`, `PackedRingShards`), `RingStats`,
  `ring_stripe_bytes` and `shard_adjacency_for_ring` are exactly equal.
- Aggregates on integer-valued inputs: sum and max bit-equal, mean
  within 1e-6 (its divide runs inside the body); float inputs (the gated
  body, the layers) within rtol=1e-5 / 1e-4.
- P = 1 equals the port's `blocked` bit for bit.
- The hop accounting: `RingHop` calls and bytes per aggregate equal
  `RingStats`, and no tensor with all P * n_loc rows forms before the
  result is assembled (the features rotate, never gather).
- The per-shard budget spills and raises as the reference's; bad inputs
  give the reference's errors; serving's ring gate routes and counts as
  the reference's engine.
The `cuda`-marked twins run on a card only and skip here.
"""
import _torch_cpu  # noqa: F401  (this worker's share of the cores)
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro.core import dataflow as j_df
from repro.core import engn as j_engn
from repro.core import models as j_models
from repro.distributed.sharding import ring_mesh as j_ring_mesh
from repro.graphs import format as j_format
from repro.graphs.generate import rmat_graph
from repro.serving import engine as j_engine
import repro_torch as rt
from repro_torch.core import dataflow as t_df
from repro_torch.core import engn as t_engn
from repro_torch.core.tiled import DeviceBudgetExceeded
from repro_torch.distributed.sharding import RingMesh, ring_mesh
from repro_torch.graphs.format import COOGraph
from repro_torch.interop import load_reference_params
from repro_torch.serving import GNNServingEngine, ServingConfig

RTOL, ATOL = 1e-4, 1e-5
RELS = 3


def _p():
    return min(len(jax.devices()), 4)


# -- graphs -------------------------------------------------------------------

def _int_graph(n, e, seed, rels=1):
    """Deduplicated integer-weighted R-MAT graph (sums of small integers
    are exact in any order, and the tiles merge no multi-edge before a
    max); with `rels`, typed by `(src + dst) % rels`."""
    g = rmat_graph(n, e, seed=seed)
    u = np.unique(np.stack([g.src, g.dst]), axis=1)
    val = np.random.default_rng(seed).integers(1, 4, u.shape[1])
    src, dst = u[0].astype(np.int32), u[1].astype(np.int32)
    rel = (((src.astype(np.int64) + dst) % rels).astype(np.int32)
           if rels > 1 else None)
    return j_format.COOGraph(n, src, dst, val.astype(np.float32), rel, rels)


def _int_features(n, f, seed):
    return np.random.default_rng(seed + 17).integers(
        -3, 4, (n, f)).astype(np.float32)


def _port(g):
    return COOGraph(g.num_vertices, g.src, g.dst, g.val, g.rel,
                    g.num_relations)


# (n, e, seed, shards, tile, relations): P = 4 on an even graph, the
# uneven P = 3 ring at tile 4, a nearly empty grid, and a typed graph
_SPECS = {
    "even": (96, 500, 0, None, 8, 1),
    "uneven93": (93, 700, 7, 3, 4, 1),
    "sparse": (64, 3, 2, None, 4, 1),
    "typed": (96, 600, 3, None, 8, RELS),
}
_CACHE = {}


def _case(kind):
    """(reference graph, port graph, P, tile)."""
    if kind not in _CACHE:
        n, e, seed, p, tile, rels = _SPECS[kind]
        g = _int_graph(n, e, seed, rels)
        _CACHE[kind] = (g, _port(g), p or _p(), tile)
    return _CACHE[kind]


def _assert_fields_equal(got, want):
    assert type(got).__name__ == type(want).__name__
    for f in dataclasses.fields(want):
        a, b = getattr(got, f.name), getattr(want, f.name)
        if isinstance(b, np.ndarray):
            assert a.dtype == b.dtype and a.shape == b.shape, f.name
            assert np.array_equal(a, b), f.name
        else:
            assert a == b, f.name


# -- the mesh -----------------------------------------------------------------

def test_ring_mesh_counts_the_visible_devices_and_co_locates():
    m = ring_mesh(device="cpu")
    assert m == RingMesh("ring", 1, torch.device("cpu"))
    m = ring_mesh(8, axis="r", device="cpu")
    assert (m.axis, m.num_shards, m.device.type) == ("r", 8, "cpu")
    with pytest.raises(ValueError, match="at least 1 shard"):
        ring_mesh(-2, device="cpu")


def test_ring_mesh_defaults_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device works")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ring_mesh(2)


# -- host carriers: exactly the reference's ---------------------------------

@pytest.mark.parametrize("kind", sorted(_SPECS))
def test_ring_tile_shards_equal_reference(kind):
    g, tg, p, tile = _case(kind)
    got = t_df.build_ring_tile_shards(tg, p, tile=tile)
    want = j_df.build_ring_tile_shards(g, p, tile=tile)
    _assert_fields_equal(got, want)
    assert got.device_bytes() == want.device_bytes()
    assert got.padded_vertices == want.padded_vertices


@pytest.mark.parametrize("floor", [1, 8])
@pytest.mark.parametrize("kind", sorted(_SPECS))
def test_packed_ring_shards_equal_reference(kind, floor):
    g, tg, p, _ = _case(kind)
    got = t_df.build_packed_ring_shards(tg, p, bucket_floor=floor)
    want = j_df.build_packed_ring_shards(g, p, bucket_floor=floor)
    _assert_fields_equal(got, want)
    assert got.device_bytes() == want.device_bytes()


@pytest.mark.parametrize("fmt", ["dense", "packed"])
@pytest.mark.parametrize("kind", sorted(_SPECS))
def test_ring_stats_equal_reference(kind, fmt):
    g, tg, p, tile = _case(kind)
    if fmt == "dense":
        got = t_df.build_ring_tile_shards(tg, p, tile=tile)
        want = j_df.build_ring_tile_shards(g, p, tile=tile)
    else:
        got = t_df.build_packed_ring_shards(tg, p)
        want = j_df.build_packed_ring_shards(g, p)
    for dims in ((6, None), (6, 4)):
        a, b = got.stats(*dims), want.stats(*dims)
        assert a.as_dict() == b.as_dict()
        assert a.fill_factor() == b.fill_factor()
    assert t_df.RingStats().as_dict() == j_df.RingStats().as_dict()


@pytest.mark.parametrize("value_dtype", ["fp32", "int8"])
@pytest.mark.parametrize("fmt", ["dense", "packed", "auto"])
@pytest.mark.parametrize("kind", sorted(_SPECS))
def test_ring_stripe_bytes_equal_reference(kind, fmt, value_dtype):
    g, tg, p, tile = _case(kind)
    for shards in (1, p, 8):
        for dims in ((0, 0), (6, 4)):
            kw = dict(tile=tile, in_dim=dims[0], out_dim=dims[1],
                      tile_format=fmt, value_dtype=value_dtype)
            assert (t_df.ring_stripe_bytes(tg, shards, **kw)
                    == j_df.ring_stripe_bytes(g, shards, **kw))
    assert (t_df.ring_feature_bytes(32, 6, 4)
            == j_df.ring_feature_bytes(32, 6, 4))


def test_ring_stripe_bytes_prices_the_built_plan():
    _, tg, p, tile = _case("uneven93")
    dense = t_df.build_ring_tile_shards(tg, p, tile=tile)
    packed = t_df.build_packed_ring_shards(tg, p)
    feat = t_df.ring_feature_bytes(dense.n_loc, 6, 4)
    assert (t_df.ring_stripe_bytes(tg, p, tile=tile, in_dim=6, out_dim=4)
            == dense.device_bytes() + feat)
    assert (t_df.ring_stripe_bytes(tg, p, tile=tile, tile_format="packed")
            == packed.device_bytes())


@pytest.mark.parametrize("n,shards", [(12, 4), (10, 4), (9, 1), (7, 3)])
def test_shard_adjacency_and_padding_equal_reference(n, shards):
    rng = np.random.default_rng(n)
    a = ((rng.random((n, n)) < 0.3)
         * rng.integers(1, 4, (n, n))).astype(np.float32)
    got = t_df.shard_adjacency_for_ring(a, shards)
    want = j_df.shard_adjacency_for_ring(a, shards)
    assert got.dtype == want.dtype and np.array_equal(got, want)
    x = rng.standard_normal((n, 3)).astype(np.float32)
    assert np.array_equal(t_df.pad_ring_features(x, shards),
                          j_df.pad_ring_features(x, shards))
    assert t_df._ring_step_perm(shards) == j_df._ring_step_perm(shards)


def test_bad_inputs_raise_the_reference_errors():
    with pytest.raises(ValueError, match="num_shards"):
        t_df.shard_adjacency_for_ring(np.ones((4, 4), np.float32), 0)
    with pytest.raises(ValueError, match="square"):
        t_df.shard_adjacency_for_ring(np.ones((4, 3), np.float32), 2)
    _, tg, _, _ = _case("even")
    for build in (t_df.build_ring_tile_shards, t_df.build_packed_ring_shards):
        with pytest.raises(ValueError, match="num_shards"):
            build(tg, 0)
    mesh = ring_mesh(1, device="cpu")
    for make in (lambda op: t_df.make_ring_tiled_aggregate(mesh, "ring", op,
                                                           2, 4),
                 lambda op: t_df.make_ring_packed_aggregate(mesh, "ring", op,
                                                            8)):
        with pytest.raises(ValueError):
            make("min")
    # the dense oracle: blocks for another ring size, and unpadded X
    fn = t_df.make_ring_aggregate(mesh, "ring", op="sum")
    x = torch.ones((10, 3))
    a13 = t_df.shard_adjacency_for_ring(np.ones((13, 13), np.float32), 1)
    with pytest.raises(ValueError, match="pad_ring_features"):
        fn(torch.from_numpy(a13), x)
    a4 = t_df.shard_adjacency_for_ring(np.ones((10, 10), np.float32), 4)
    with pytest.raises(ValueError, match="ring shards"):
        fn(torch.from_numpy(a4), x)
    x13 = torch.from_numpy(t_df.pad_ring_features(np.ones((10, 3),
                                                          np.float32), 13))
    y = fn(torch.from_numpy(a13), x13)
    np.testing.assert_allclose(y[:10].numpy(), np.full((10, 3), 10.0))
    with pytest.raises(ValueError, match="not the ring's"):
        t_df.make_ring_aggregate(mesh, "data")


# -- aggregates against the reference's rings -------------------------------

def _pad(x, rows):
    xp = np.zeros((rows, x.shape[1]), np.float32)
    xp[:x.shape[0]] = x
    return xp


def _ring_pair(kind, fmt, op):
    """(port's, reference's) aggregate of the same padded features over
    the same plan arrays (the builders are equal)."""
    g, tg, p, tile = _case(kind)
    jm, tm = j_ring_mesh(p), ring_mesh(p, device="cpu")
    if fmt == "dense":
        plan = t_df.build_ring_tile_shards(tg, p, tile=tile)
        ops = (plan.blocks, plan.tile_row, plan.tile_col)
        jf = j_df.make_ring_tiled_aggregate(jm, "ring", op, plan.q_loc,
                                            plan.tile)
        tf = t_df.make_ring_tiled_aggregate(tm, "ring", op, plan.q_loc,
                                            plan.tile)
    else:
        plan = t_df.build_packed_ring_shards(tg, p)
        ops = (plan.rows, plan.cols, plan.vals)
        jf = j_df.make_ring_packed_aggregate(jm, "ring", op, plan.n_loc)
        tf = t_df.make_ring_packed_aggregate(tm, "ring", op, plan.n_loc)
    xp = _pad(_int_features(g.num_vertices, 5, 3), plan.padded_vertices)
    want = np.asarray(jf(*map(jnp.asarray, ops), jnp.asarray(xp),
                         jnp.asarray(plan.in_counts)))
    got = tf(*map(torch.from_numpy, ops), torch.from_numpy(xp),
             torch.from_numpy(plan.in_counts)).numpy()
    return got, want, g


def _segment(g, x, op):
    ev = jnp.asarray(x)[jnp.asarray(g.src)] * jnp.asarray(g.val)[:, None]
    return np.asarray(j_engn.segment_aggregate(ev, jnp.asarray(g.dst),
                                               g.num_vertices, op))


@pytest.mark.parametrize("op", ["sum", "max", "mean"])
@pytest.mark.parametrize("fmt", ["dense", "packed"])
@pytest.mark.parametrize("kind", ["even", "uneven93", "sparse"])
def test_aggregate_equals_reference_ring(kind, fmt, op):
    got, want, g = _ring_pair(kind, fmt, op)
    assert got.shape == want.shape
    if op == "mean":
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    else:
        assert np.array_equal(got, want), (kind, fmt, op)
    seg = _segment(g, _int_features(g.num_vertices, 5, 3), op)
    np.testing.assert_allclose(got[:g.num_vertices], seg, rtol=1e-6,
                               atol=1e-6)


@pytest.mark.parametrize("fmt", ["dense", "packed"])
def test_typed_sum_equals_reference_ring(fmt):
    g, tg, p, tile = _case("typed")
    h = 4
    jm, tm = j_ring_mesh(p), ring_mesh(p, device="cpu")
    if fmt == "dense":
        plan = t_df.build_ring_tile_shards(tg, p, tile=tile)
        ops = (plan.blocks, plan.tile_row, plan.tile_col, plan.tile_rel)
        jf = j_df.make_ring_typed_sum_tiled(jm, "ring", plan.q_loc,
                                            plan.tile, RELS)
        tf = t_df.make_ring_typed_sum_tiled(tm, "ring", plan.q_loc,
                                            plan.tile, RELS)
    else:
        plan = t_df.build_packed_ring_shards(tg, p)
        ops = (plan.rows, plan.cols, plan.vals, plan.rels)
        jf = j_df.make_ring_typed_sum_packed(jm, "ring", plan.n_loc, RELS)
        tf = t_df.make_ring_typed_sum_packed(tm, "ring", plan.n_loc, RELS)
    xp = _pad(_int_features(g.num_vertices, RELS * h, 5),
              plan.padded_vertices)
    want = np.asarray(jf(*map(jnp.asarray, ops), jnp.asarray(xp),
                         jnp.asarray(plan.in_counts)))
    got = tf(*map(torch.from_numpy, ops), torch.from_numpy(xp),
             torch.from_numpy(plan.in_counts)).numpy()
    assert np.array_equal(got, want)


@pytest.mark.parametrize("fmt", ["dense", "packed"])
@pytest.mark.parametrize("kind", ["even", "uneven93"])
def test_gated_body_equals_reference_ring(kind, fmt):
    g, tg, p, tile = _case(kind)
    f = 4
    jm, tm = j_ring_mesh(p), ring_mesh(p, device="cpu")
    if fmt == "dense":
        plan = t_df.build_ring_tile_shards(tg, p, tile=tile)
        ops = (plan.blocks, plan.tile_row, plan.tile_col)
        jf = j_df.make_ring_gated_tiled(jm, "ring", plan.q_loc, plan.tile)
        tf = t_df.make_ring_gated_tiled(tm, "ring", plan.q_loc, plan.tile)
    else:
        plan = t_df.build_packed_ring_shards(tg, p)
        ops = (plan.rows, plan.cols, plan.vals)
        jf = j_df.make_ring_gated_packed(jm, "ring", plan.n_loc)
        tf = t_df.make_ring_gated_packed(tm, "ring", plan.n_loc)
    rng = np.random.default_rng(9)
    n_pad = plan.padded_vertices
    ph = _pad(rng.standard_normal((g.num_vertices, f)).astype(np.float32),
              n_pad)
    pcx = _pad(rng.standard_normal((g.num_vertices, 2 * f))
               .astype(np.float32), n_pad)
    want = np.asarray(jf(*map(jnp.asarray, ops), jnp.asarray(ph),
                         jnp.asarray(pcx), jnp.asarray(plan.in_counts)))
    got = tf(*map(torch.from_numpy, ops), torch.from_numpy(ph),
             torch.from_numpy(pcx), torch.from_numpy(plan.in_counts)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("op", ["sum", "max"])
def test_dense_oracle_equals_reference_ring(op):
    p = _p()
    rng = np.random.default_rng(42)
    n = 26
    a = ((rng.random((n, n)) < 0.3)
         * rng.integers(1, 4, (n, n))).astype(np.float32)
    blocks = t_df.shard_adjacency_for_ring(a, p)
    x = t_df.pad_ring_features(rng.integers(-3, 4, (n, 4))
                               .astype(np.float32), p)
    want = np.asarray(j_df.make_ring_aggregate(
        jax.make_mesh((p,), ("ring",)), "ring", op)(jnp.asarray(blocks),
                                                     jnp.asarray(x)))
    got = t_df.make_ring_aggregate(ring_mesh(p, device="cpu"), "ring", op)(
        torch.from_numpy(blocks), torch.from_numpy(x)).numpy()
    assert np.array_equal(got, want)


def test_dense_max_slabs_are_bit_equal_to_one_pass(monkeypatch):
    """The dense max forms its (tiles, T, T, F) product a slab of tiles
    at a time: a slab of one tile gives the same result and gradient."""
    g, tg, p, tile = _case("even")
    plan = t_df.build_ring_tile_shards(tg, p, tile=tile)
    fn = t_df.make_ring_tiled_aggregate(ring_mesh(p, device="cpu"), "ring",
                                        "max", plan.q_loc, plan.tile)
    xp = _pad(_int_features(g.num_vertices, 5, 3), plan.padded_vertices)
    ops = tuple(map(torch.from_numpy, (plan.blocks, plan.tile_row,
                                        plan.tile_col)))
    cot = torch.from_numpy(np.random.default_rng(1).standard_normal(
        (plan.padded_vertices, 5)).astype(np.float32))

    def run():
        x = torch.from_numpy(xp).requires_grad_(True)
        y = fn(*ops, x, torch.from_numpy(plan.in_counts))
        (y * cot).sum().backward()
        return y.detach(), x.grad
    y1, g1 = run()
    monkeypatch.setattr(t_df, "MAX_TEMP_BYTES", 1)
    y2, g2 = run()
    assert torch.equal(y1, y2) and torch.equal(g1, g2)


# -- through prepare_graph and the layers ------------------------------------

def _layers(model, dims, backend, fmt, p, tile=8):
    """The reference's stack and weights, and the port's twin."""
    rels = RELS if model == "rgcn" else 1
    jl = j_models.make_gnn_stack(model, dims, backend=backend, tile=tile,
                                 num_relations=rels)
    tl = rt.make_gnn_stack(model, dims, backend=backend, tile=tile,
                           num_relations=rels, device="cpu")
    for a, b in zip(jl, tl):
        for cfg in (a.cfg, b.cfg):
            cfg.tile_format = fmt
            cfg.ring_shards = p
    jp = j_models.init_stack(jl, jax.random.key(0))
    load_reference_params(tl, [{k: np.asarray(v) for k, v in q.items()}
                               for q in jp])
    return jl, jp, tl


MODEL_DIMS = {"gcn": [6, 8, 4], "gs_pool": [6, 8, 4], "rgcn": [6, 5, 4],
              "gated_gcn": [6, 6]}


def _model_graph(model):
    kind = "typed" if model == "rgcn" else "uneven93"
    g, tg, p, _ = _case(kind)
    if model == "gcn":
        # real-valued weights: the layer's sums agree to fp32 rounding
        g = g.gcn_normalized()
        tg = _port(g)
    return g, tg, p


@pytest.mark.parametrize("fmt", ["dense", "packed"])
@pytest.mark.parametrize("model", sorted(MODEL_DIMS))
def test_stack_on_the_ring_equals_reference(model, fmt):
    g, tg, p = _model_graph(model)
    dims = MODEL_DIMS[model]
    jl, jp, tl = _layers(model, dims, "ring", fmt, p)
    x = np.random.default_rng(4).standard_normal(
        (g.num_vertices, dims[0])).astype(np.float32)
    jplan = j_engn.prepare_graph(g, jl[0].cfg)
    want = np.asarray(j_models.apply_stack(jl, jp, jplan, jnp.asarray(x)))
    tplan = rt.prepare_graph(tg, tl[0].cfg, device="cpu")
    assert (tplan.backend, tplan.tile_format) == ("ring", fmt)
    assert tplan.footprint_bytes == jplan.footprint_bytes
    for key in ("shards", "padded", "tile", "q_loc", "s_max", "nnzb",
                "device_bytes", "tile_format"):
        assert tplan.meta[key] == jplan.meta[key], key
    assert tplan.meta["stats"].as_dict() == jplan.meta["stats"].as_dict()
    assert tplan.meta["mesh"].num_shards == p
    with torch.no_grad():
        got = rt.apply_stack(tl, tplan, torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


def test_auto_picks_the_reference_format():
    for kind in ("even", "sparse"):
        g, tg, p, tile = _case(kind)
        for dims in ((5, 5), (64, 64)):
            cfg_j = j_engn.EnGNConfig(*dims, backend="ring", tile=tile,
                                      ring_shards=p)
            cfg_t = t_engn.EnGNConfig(*dims, backend="ring", tile=tile,
                                      ring_shards=p)
            assert (rt.prepare_graph(tg, cfg_t, device="cpu").tile_format
                    == j_engn.prepare_graph(g, cfg_j).tile_format)


@pytest.mark.parametrize("op", ["sum", "max"])
def test_ring_tiled_one_shard_degenerates_to_blocked_bitwise(op):
    """A 1-shard ring is the blocked path: same tile grid, same per-tile
    contraction, same reduce (the reference's test, on the port)."""
    g = _port(_int_graph(70, 500, seed=2))
    x = torch.from_numpy(np.random.default_rng(3).integers(
        -3, 4, (70, 5)).astype(np.float32))
    outs = []
    for backend in ("blocked", "ring"):
        cfg = t_engn.EnGNConfig(5, 5, aggregate_op=op, backend=backend,
                                tile=16, tile_format="dense", ring_shards=1)
        plan = rt.prepare_graph(g, cfg, device="cpu")
        outs.append(t_engn.EnGNLayer(cfg, device="cpu")._aggregate(plan, x))
    assert torch.equal(outs[0], outs[1])


def test_ring_tiled_empty_rows_and_self_loops():
    """Empty destination shards keep the segment convention (0 for max,
    sum and mean) and the diagonal's self loops stay on their shard."""
    loops = np.arange(12, dtype=np.int32)
    g = COOGraph(12, np.concatenate([loops, [0]]).astype(np.int32),
                 np.concatenate([loops, [11]]).astype(np.int32),
                 np.ones(13, np.float32))
    x = np.arange(36, dtype=np.float32).reshape(12, 3) - 10.0
    jg = j_format.COOGraph(12, g.src, g.dst, g.val)
    for op in ("sum", "max", "mean"):
        cfg = t_engn.EnGNConfig(3, 3, aggregate_op=op, backend="ring",
                                tile=2, tile_format="dense", ring_shards=_p())
        plan = rt.prepare_graph(g, cfg, device="cpu")
        got = t_engn.EnGNLayer(cfg, device="cpu")._aggregate(
            plan, torch.from_numpy(x)).numpy()
        np.testing.assert_allclose(got, _segment(jg, x, op), rtol=1e-6,
                                   atol=1e-6)


# -- the rotation: hops, bytes, no gather -------------------------------------

class _Rows(TorchDispatchMode):
    """Records (op, rows of its output) for every aten call."""

    def __init__(self):
        super().__init__()
        self.seen = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in (out if isinstance(out, (tuple, list)) else (out,)):
            if isinstance(t, torch.Tensor) and t.dim():
                self.seen.append((str(func.overloadpacket.__name__),
                                  t.shape[0]))
        return out


@pytest.mark.parametrize("op", ["sum", "max", "mean"])
@pytest.mark.parametrize("fmt", ["dense", "packed"])
def test_each_aggregate_hops_p_times_and_never_gathers(fmt, op):
    g, tg, p, tile = _case("uneven93")
    f = 5
    cfg = t_engn.EnGNConfig(f, f, aggregate_op=op, backend="ring", tile=tile,
                            tile_format=fmt, ring_shards=p)
    plan = rt.prepare_graph(tg, cfg, device="cpu")
    meta, carrier = plan.meta, plan.carrier
    stats = meta["stats"]
    n_pad = meta["padded"]
    n_loc = n_pad // p
    xf = torch.from_numpy(_pad(_int_features(93, f, 3), n_pad))
    t_df.reset_hop_counts()
    mode = _Rows()
    with mode:
        y = carrier["ring_fn"](*carrier["ring_operands"], xf,
                               carrier["ring_counts"])
    assert t_df.hop_counts["hops"] == stats.ring_steps == p
    assert t_df.hop_counts["bytes"] == stats.ppermute_bytes
    # each hop copies n_loc-row shards; the only P * n_loc-row tensor is
    # the result, assembled after the last step
    assert ("clone", n_loc) in mode.seen
    full = [i for i, (_, rows) in enumerate(mode.seen) if rows == n_pad]
    assert [mode.seen[i][0] for i in full] == ["cat"]
    assert full == [len(mode.seen) - 1]
    assert y.shape == (n_pad, f)
    # the backward rotates every cotangent back: P - 1 hops reach the
    # input (the last step's hop delivers nothing that is used)
    t_df.reset_hop_counts()
    xg = xf.clone().requires_grad_(True)
    carrier["ring_fn"](*carrier["ring_operands"], xg,
                       carrier["ring_counts"]).sum().backward()
    assert t_df.hop_counts["bwd_hops"] == p - 1
    assert t_df.hop_counts["bwd_bytes"] == (p - 1) * p * n_loc * f * 4


@pytest.mark.parametrize("fmt", ["dense", "packed"])
def test_plan_holds_each_shard_pair_up_to_its_last_live_slot(fmt):
    """The plan uploads shard pair (d, s)'s slots up to its last live one:
    the reference's pads after it (there for one static shape) are not
    held, and the pair's real entries or tiles all are."""
    g, tg, p, tile = _case("even")
    cfg = t_engn.EnGNConfig(5, 5, backend="ring", tile=tile,
                            tile_format=fmt, ring_shards=p)
    plan = rt.prepare_graph(tg, cfg, device="cpu")
    if fmt == "dense":
        host = t_df.build_ring_tile_shards(tg, p, tile=tile)
        arrays = (host.blocks, host.tile_row, host.tile_col)
        real = host.blocks.any(axis=(3, 4)).sum(axis=-1).ravel()
    else:
        host = t_df.build_packed_ring_shards(tg, p)
        arrays = (host.rows, host.cols, host.vals)
        real = (host.vals != 0).sum(axis=-1).ravel()
    live = t_df.pair_counts(host)
    assert np.array_equal(live.ravel(), real)     # real slots lead a pair
    ops = plan.carrier["ring_operands"]
    assert len(plan.carrier["ring_counts"]) == p
    held = host.in_counts.nbytes
    for arr, op in zip(arrays, ops):
        assert len(op) == p and all(len(row) == p for row in op)
        for d in range(p):
            for s in range(p):
                assert torch.equal(op[d][s], torch.from_numpy(
                    arr[d, s, :live[d, s]]))
                held += arr[d, s, :live[d, s]].nbytes
    assert plan.held_bytes() == held
    assert plan.footprint_bytes == host.device_bytes() + \
        t_df.ring_feature_bytes(host.n_loc, 5, 5)


# -- the budget gate ------------------------------------------------------------

def test_ring_tiled_per_shard_budget_spills_and_raises():
    """The reference's test on the port: the per-shard budget is priced
    on the plan as built; too small spills to "tiled" or raises with the
    per-shard wording."""
    jg = rmat_graph(120, 900, seed=1).gcn_normalized()
    g = _port(jg)
    kw = dict(in_dim=16, out_dim=8, backend="ring", tile=16, ring_shards=1)
    strict = t_engn.EnGNConfig(**kw, device_budget_bytes=10_000,
                               auto_spill=False)
    with pytest.raises(DeviceBudgetExceeded, match="per shard"):
        rt.prepare_graph(g, strict, device="cpu")
    for budget, backend in ((10_000, "tiled"), (50_000_000, "ring")):
        got = rt.prepare_graph(g, t_engn.EnGNConfig(
            **kw, device_budget_bytes=budget), device="cpu")
        want = j_engn.prepare_graph(jg, j_engn.EnGNConfig(
            **kw, device_budget_bytes=budget))
        assert got.backend == want.backend == backend
        assert got.footprint_bytes == want.footprint_bytes
    # the ring shrinks the stripe: P shards fit a budget one does not
    one = t_df.ring_stripe_bytes(g, 1, 16, 16, 8, tile_format="auto")
    four = t_df.ring_stripe_bytes(g, 4, 16, 16, 8, tile_format="auto")
    assert four < one
    for budget in (four, one - 1):
        cfg = t_engn.EnGNConfig(**{**kw, "ring_shards": 4},
                                device_budget_bytes=budget)
        jcfg = j_engn.EnGNConfig(**{**kw, "ring_shards": 4},
                                 device_budget_bytes=budget)
        assert (rt.prepare_graph(g, cfg, device="cpu").backend
                == j_engn.prepare_graph(jg, jcfg).backend == "ring")


def test_training_doubles_the_feature_price_as_the_reference():
    jg = rmat_graph(120, 900, seed=1).gcn_normalized()
    for training in (False, True):
        kw = dict(in_dim=16, out_dim=8, backend="ring", tile=16,
                  ring_shards=2, training=training)
        assert (rt.prepare_graph(_port(jg), t_engn.EnGNConfig(**kw),
                                 device="cpu").footprint_bytes
                == j_engn.prepare_graph(jg, j_engn.EnGNConfig(**kw))
                .footprint_bytes)


def test_typed_contract_needs_a_typed_plan():
    g, tg, p, tile = _case("even")
    cfg = t_engn.EnGNConfig(5, 4, backend="ring", tile=tile,
                            stage_contract="typed", num_relations=RELS)
    plan = t_df.build_packed_ring_shards(tg, p)
    typed = dataclasses.replace(tg, rel=np.zeros(tg.num_edges, np.int32),
                                num_relations=RELS)
    with pytest.raises(ValueError, match="relation-typed ring plan"):
        t_engn.prepare_ring(typed, cfg, plan=plan,
                            mesh=ring_mesh(p, device="cpu"))


# -- serving's ring gate ------------------------------------------------------

def _gate_engines(budget, shards, model="gcn"):
    """The reference test's dense-ish graph and stack
    (`tests/test_serving.py::test_engine_ring_gate_serves_oversized_
    batches_on_the_mesh`), in both packages."""
    rng = np.random.default_rng(0)
    n, e = 200, 8000
    src = rng.integers(0, n, e).astype(np.int32)
    dst = rng.integers(0, n, e).astype(np.int32)
    g = j_format.COOGraph(n, src, dst).gcn_normalized()
    x = np.random.default_rng(1).standard_normal((n, 16)).astype(np.float32)
    jl = j_models.make_gnn_stack(model, [16, 8, 4])
    jp = j_models.init_stack(jl, jax.random.key(0))
    tl = rt.make_gnn_stack(model, [16, 8, 4], device="cpu")
    load_reference_params(tl, [{k: np.asarray(v) for k, v in q.items()}
                               for q in jp])
    engn = dict(in_dim=0, out_dim=0, device_budget_bytes=budget,
                ring_shards=shards)
    kw = dict(batch_size=8, ring_tile=32, tiled_tile=32)
    je = j_engine.GNNServingEngine(
        g, x, jl, jp, j_engine.ServingConfig(
            **kw, engn=j_engn.EnGNConfig(**engn)))
    te = GNNServingEngine(_port(g), x, tl, None, ServingConfig(
        **kw, engn=t_engn.EnGNConfig(**engn)))
    return je, te


_GATE_REQS = [np.arange(25, dtype=np.int32), np.array([5, 190], np.int32)]


def _serve(eng):
    for i, ids in enumerate(_GATE_REQS):
        eng.submit(i, ids)
    return {r.rid: r.outputs for r in eng.drain()}


@pytest.mark.parametrize("budget,route", [(400_000, "ring"),
                                          (50_000, "tiled")])
@pytest.mark.parametrize("shards", [1, 2])
def test_serving_ring_gate_routes_as_the_reference(shards, budget, route):
    je, te = _gate_engines(budget, shards)
    want, got = _serve(je), _serve(te)
    for key in ("ring_batches", "tiled_batches", "subgraphs"):
        assert te.stats[key] == je.stats[key], key
    assert te.stats[f"{route}_batches"] > 0
    for rid in want:
        np.testing.assert_allclose(got[rid], want[rid], rtol=RTOL,
                                   atol=ATOL)


def test_serving_ring_gate_skips_mixed_stacks():
    je, te = _gate_engines(400_000, 2)
    te.layers[0].cfg.aggregate_op = "max"
    assert te._try_ring_plan(_port(je.graph)) is None


# -- on the card ------------------------------------------------------------------

def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("op", ["sum", "max", "mean"])
@pytest.mark.parametrize("fmt", ["dense", "packed"])
def test_card_aggregate_matches_cpu(fmt, op):
    dev = _card()
    g, tg, p, tile = _case("uneven93")
    outs = []
    for d in ("cpu", dev):
        cfg = t_engn.EnGNConfig(5, 5, aggregate_op=op, backend="ring",
                                tile=tile, tile_format=fmt, ring_shards=p)
        plan = rt.prepare_graph(tg, cfg, device=d)
        assert plan.carrier["ring_operands"][0][0][0].device.type == \
            torch.device(d).type
        x = torch.from_numpy(_int_features(93, 5, 3)).to(d)
        outs.append(t_engn.EnGNLayer(cfg, device=d)._aggregate(plan, x)
                    .cpu())
    if op == "mean":
        torch.testing.assert_close(outs[1], outs[0], rtol=1e-6, atol=1e-6)
    else:
        assert torch.equal(outs[0], outs[1])


@pytest.mark.cuda
def test_card_default_shard_count_is_the_card_count():
    _card()
    assert ring_mesh().num_shards == torch.cuda.device_count()
