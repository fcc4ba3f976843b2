"""GNN training in the port against the reference, on the CPU.

One-step gradients of each model on each resident backend against
`jax.grad` (rtol=1e-4, atol=1e-5: the frameworks reduce in different
orders); the max backward's tie conventions (dense tiles split within a
tile, then across tiles; packed entries split evenly over a row); the
optimizer, clip and schedules (1e-6); the node stream (exact); an 8-step
GCN trajectory from the reference's init (rtol=1e-3, atol=1e-4, the
reference launcher test's own tolerance); checkpoints written by either
package and restored by the other; the launcher.  The kernels' own
backward runs on the card in the `cuda`-marked tests at the end.
"""
import argparse

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import manager as j_ckpt
from repro.core import engn as j_engn
from repro.core import models as j_models
from repro.data import pipeline as j_pipeline
from repro.graphs import partition as j_partition
from repro.graphs.degree import apply_vertex_permutation, degree_sort_permutation
from repro.graphs.generate import make_dataset, random_features
from repro.kernels.rer_gather import ops as j_gather
from repro.kernels.rer_spmm import ops as j_spmm
from repro.training import optimizer as j_opt
from repro.training import schedule as j_sched
import repro_torch as rt
from repro_torch.checkpoint import manager as t_ckpt
from repro_torch.core import engn as t_engn
from repro_torch.core.models import stack_params
from repro_torch.data import pipeline as t_pipeline
from repro_torch.graphs import format as t_format
from repro_torch.graphs import partition as t_partition
from repro_torch.interop import load_reference_params
from repro_torch.core.tiled import dense_footprint_bytes
from repro_torch.kernels import rer_gather as t_gather
from repro_torch.kernels import rer_gather_bwd as t_gather_bwd
from repro_torch.kernels import rer_spmm as t_spmm
from repro_torch.launch import train as t_train
from repro_torch.training import optimizer as t_opt
from repro_torch.training import schedule as t_sched

RTOL, ATOL = 1e-4, 1e-5
DIMS = {"gcn": [12, 16, 5], "gs_pool": [12, 8, 5], "grn": [12, 12]}
GRAD_CASES = [("gcn", "segment", "auto"), ("gcn", "blocked", "dense"),
              ("gcn", "blocked", "packed"), ("gcn", "fused", "auto"),
              ("gs_pool", "segment", "auto"), ("gs_pool", "blocked", "dense"),
              ("gs_pool", "blocked", "packed"), ("grn", "segment", "auto"),
              ("grn", "blocked", "dense")]


def _graph(n=120, f=12, seed=0):
    """A degree-sorted, GCN-normalised cora stand-in with its multi-edges
    merged (the tile carriers merge them before a max sees them; the
    segment backend does not)."""
    g, _, _ = make_dataset("cora", seed=seed, max_vertices=n, feature_dim=f)
    g = apply_vertex_permutation(g, degree_sort_permutation(g))
    g = g.gcn_normalized()
    key, val = j_partition.merge_by_key(g.dst.astype(np.int64) * n + g.src,
                                        g.weights())
    g = t_format.COOGraph(n, (key % n).astype(np.int32),
                          (key // n).astype(np.int32), val)
    x = random_features(n, f, seed=1)
    return g, x


def _stacks(model, dims, backend, fmt, tile=16):
    jl = j_models.make_gnn_stack(model, dims, backend=backend, tile=tile)
    tl = rt.make_gnn_stack(model, dims, backend=backend, tile=tile,
                           device="cpu")
    for a, b in zip(jl, tl):
        a.cfg.tile_format = b.cfg.tile_format = fmt
    jp = j_models.init_stack(jl, jax.random.key(0))
    load_reference_params(tl, [{k: np.asarray(v) for k, v in p.items()}
                               for p in jp])
    return jl, jp, tl


@pytest.mark.parametrize("model,backend,fmt", GRAD_CASES)
def test_one_step_gradients_match_jax_grad(model, backend, fmt):
    g, x = _graph()
    jl, jp, tl = _stacks(model, DIMS[model], backend, fmt)
    cot = np.random.default_rng(7).standard_normal(
        (g.num_vertices, DIMS[model][-1])).astype(np.float32)
    jplan = j_engn.prepare_graph(g, jl[0].cfg)

    def j_loss(ps, xx):
        return jnp.sum(j_models.apply_stack(jl, ps, jplan, xx) * cot)
    jgp, jgx = jax.grad(j_loss, argnums=(0, 1))(jp, jnp.asarray(x))

    tplan = rt.prepare_graph(g, tl[0].cfg, device="cpu")
    assert tplan.backend == backend
    if backend == "blocked":
        assert tplan.tile_format == fmt
    held = tplan.held_bytes()
    ps = [{k: v.clone().requires_grad_(True) for k, v in p.items()}
          for p in stack_params(tl)]
    xt = torch.from_numpy(x).requires_grad_(True)
    out = rt.apply_stack(tl, tplan, xt, params=ps)
    (out * torch.from_numpy(cot)).sum().backward()
    for i, (jd, td) in enumerate(zip(jgp, ps)):
        assert set(jd) == set(td)
        for k in jd:
            np.testing.assert_allclose(td[k].grad.numpy(), np.asarray(jd[k]),
                                       rtol=RTOL, atol=ATOL,
                                       err_msg=f"layer {i} {k}")
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(jgx), rtol=RTOL,
                               atol=ATOL, err_msg="x")
    # every backward walks the forward carrier: the plan holds no byte
    # more than prepare_graph gave it (no carrier of A^T)
    built = tplan.held_bytes() - held
    assert built == 0


# -- the max backward's tie conventions -----------------------------------

def _tie_graph():
    """Destination 0 has three in-edges of weight 1: from 0 and 1 (tile
    (0, 0)) and from 2 (tile (0, 1)); with T = 2 and x = 1 all three tie
    for the max.  Vertex 3 has one in-edge, vertex 1 none."""
    src = np.array([0, 1, 2, 0], np.int32)
    dst = np.array([0, 0, 0, 3], np.int32)
    return t_format.COOGraph(4, src, dst, np.ones(4, np.float32))


def test_dense_max_tie_split_is_two_level():
    g = _tie_graph()
    b = t_format.coo_to_blocked(g, 2)
    blocks, brow, bcol = j_spmm.prepare_blocks(b.blocks, b.block_row,
                                               b.block_col, b.q)
    x = np.ones((4, 1), np.float32)
    gy = np.zeros((4, 1), np.float32)
    gy[0] = 1.0
    want = jax.grad(lambda xx: jnp.sum(j_spmm.blocked_spmm_xla(
        blocks, brow, bcol, xx, q=b.q, op="max") * gy))(jnp.asarray(x))
    np.testing.assert_array_equal(np.asarray(want)[:3, 0], [0.25, 0.25, 0.5])
    xt = torch.from_numpy(x).requires_grad_(True)
    carrier = [torch.from_numpy(a) for a in (blocks, brow, bcol)]
    y = t_spmm.blocked_spmm(*carrier, xt, q=b.q, op="max")
    (y * torch.from_numpy(gy)).sum().backward()
    np.testing.assert_array_equal(xt.grad.numpy(), np.asarray(want))


@pytest.mark.parametrize("backend", ["blocked", "fused"])
def test_dense_max_backward_builds_no_transposed_carrier(backend):
    """A GS-Pool stack on dense tiles ("fused" runs a max through the
    same dense aggregate) trains without the carrier of A^T: after a
    backward that matches jax.grad, the plan holds what prepare_graph
    gave it, and a raw max under autograd differentiates too."""
    g, x = _graph(seed=2)
    jl, jp, tl = _stacks("gs_pool", DIMS["gs_pool"], backend, "dense")
    cot = np.random.default_rng(9).standard_normal(
        (g.num_vertices, DIMS["gs_pool"][-1])).astype(np.float32)
    jplan = j_engn.prepare_graph(g, jl[0].cfg)
    jgx = jax.grad(lambda xx: jnp.sum(
        j_models.apply_stack(jl, jp, jplan, xx) * cot))(jnp.asarray(x))
    tplan = rt.prepare_graph(g, tl[0].cfg, device="cpu")
    held = tplan.held_bytes()
    xt = torch.from_numpy(x).requires_grad_(True)
    (rt.apply_stack(tl, tplan, xt) * torch.from_numpy(cot)).sum().backward()
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(jgx), rtol=RTOL,
                               atol=ATOL)
    assert tplan.held_bytes() == held
    c = tplan.carrier
    xm = torch.from_numpy(np.abs(x[:, :5])).requires_grad_(True)
    xf = torch.zeros((c["blocks_meta"]["padded"], 5))
    xf[:g.num_vertices] = xm
    y = t_spmm.blocked_spmm(c["blocks"], c["block_row"], c["block_col"], xf,
                            q=c["blocks_meta"]["q"], op="max")
    y.sum().backward()
    assert xm.grad is not None and bool(torch.isfinite(xm.grad).all())


@pytest.mark.parametrize("floor", [1, 2])
def test_packed_group_max_tie_split_is_flat(floor):
    """The bucket-group form (the card's carrier, one launch per group,
    partials merged by maximum) differentiates as the reference's flat
    `segment_max` does, however the tied entries fall into groups: 1/3
    each.  floor=1 puts the two tiles into different buckets."""
    g = _tie_graph()
    ps = t_partition.pack_tile_store(t_partition.build_tile_store(g, 2))
    jflat = j_gather.flat_entries(ps)
    x = np.ones((4, 1), np.float32)
    gy = np.zeros((4, 1), np.float32)
    gy[0] = 1.0
    want = jax.grad(lambda xx: jnp.sum(j_gather.packed_flat_xla(
        *jflat, xx, n=4, op="max") * gy))(jnp.asarray(x))
    np.testing.assert_allclose(np.asarray(want)[:3, 0], [1 / 3] * 3)
    groups = t_engn.upload_groups(t_gather.prepare_packed_groups(ps, floor),
                                   torch.device("cpu"))
    assert len(groups) == (2 if floor == 1 else 1)
    xt = torch.from_numpy(x).requires_grad_(True)
    y = t_gather.packed_groups_spmm(groups, xt, q=ps.q, op="max")
    (y * torch.from_numpy(gy)).sum().backward()
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(want), rtol=1e-6)


@pytest.mark.parametrize("op", ["sum", "max"])
@pytest.mark.parametrize("floor", [1, 8])
def test_packed_groups_grad_matches_flat_reference(op, floor):
    """Bucket groups on a real graph, integer-valued features (many
    ties): the grouped backward equals jax.grad of `packed_flat_xla`."""
    g, _ = _graph(seed=3)
    ps = t_partition.pack_tile_store(t_partition.build_tile_store(g, 16))
    n_pad = ps.padded_vertices
    rng = np.random.default_rng(floor)
    x = rng.integers(-2, 3, (n_pad, 6)).astype(np.float32)
    gy = rng.standard_normal((n_pad, 6)).astype(np.float32)
    flat = j_gather.flat_entries(ps)
    want = jax.grad(lambda xx: jnp.sum(j_gather.packed_flat_xla(
        *flat, xx, n=n_pad, op=op) * gy))(jnp.asarray(x))
    cpu = torch.device("cpu")
    groups = t_engn.upload_groups(t_gather.prepare_packed_groups(ps, floor),
                                   cpu)
    xt = torch.from_numpy(x).requires_grad_(True)
    y = t_gather.packed_groups_spmm(groups, xt, q=ps.q, op=op)
    (y * torch.from_numpy(gy)).sum().backward()
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(want), rtol=RTOL,
                               atol=ATOL)


@pytest.mark.parametrize("op", ["sum", "max"])
@pytest.mark.parametrize("floor", [1, 8])
def test_packed_backward_plain_over_forward_groups(op, floor):
    """The plain versions the packed backward kernels are held to, over
    the FORWARD groups, on integer-valued x (many ties): the sum's
    A^T G (`packed_groups_t_plain`) against jax.vjp of the reference's
    `packed_flat_xla`; the max's counts exactly equal to the tied
    entries of the reference's flat entries and its scatter against
    jax.grad of `packed_flat_xla` (the file's RTOL/ATOL)."""
    g, _ = _graph(seed=4)
    ps = t_partition.pack_tile_store(t_partition.build_tile_store(g, 16))
    n_pad = ps.padded_vertices
    rng = np.random.default_rng(10 + floor)
    x = rng.integers(-2, 3, (n_pad, 6)).astype(np.float32)
    gy = rng.standard_normal((n_pad, 6)).astype(np.float32)
    gsrc, gdst, gval = j_gather.flat_entries(ps)
    groups = t_engn.upload_groups(t_gather.prepare_packed_groups(ps, floor),
                                   torch.device("cpu"))
    assert len(groups) > 1
    y, vjp = jax.vjp(lambda xx: j_gather.packed_flat_xla(
        gsrc, gdst, gval, xx, n=n_pad, op=op), jnp.asarray(x))
    want = np.asarray(vjp(jnp.asarray(gy))[0])
    if op == "sum":
        got = t_gather_bwd.packed_groups_t_plain(
            groups, torch.from_numpy(gy), q=ps.q)
    else:
        y = np.asarray(y)
        win = (gval != 0)[:, None] & (gval[:, None] * x[gsrc] == y[gdst])
        cnt_want = np.zeros(x.shape, np.int32)
        np.add.at(cnt_want, gdst, win.astype(np.int32))
        assert cnt_want.max() > 1                     # ties
        xt, yt = torch.from_numpy(x), torch.from_numpy(np.array(y))
        cnt = t_gather_bwd.packed_max_count_plain(groups, xt, yt, q=ps.q)
        np.testing.assert_array_equal(cnt.numpy(), cnt_want)
        got = t_gather_bwd.packed_max_scatter_plain(
            groups, xt, yt, torch.from_numpy(gy), cnt, q=ps.q)
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("op", ["sum", "max"])
def test_dense_grad_matches_reference_with_ties(op):
    g, _ = _graph(seed=5)
    b = t_format.coo_to_blocked(g, 16)
    blocks, brow, bcol = j_spmm.prepare_blocks(b.blocks, b.block_row,
                                               b.block_col, b.q)
    rng = np.random.default_rng(2)
    x = rng.integers(-2, 3, (b.padded_vertices, 5)).astype(np.float32)
    gy = rng.standard_normal(x.shape).astype(np.float32)
    want = jax.grad(lambda xx: jnp.sum(j_spmm.blocked_spmm_xla(
        blocks, brow, bcol, xx, q=b.q, op=op) * gy))(jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_(True)
    carrier = [torch.from_numpy(a) for a in (blocks, brow, bcol)]
    y = t_spmm.blocked_spmm(*carrier, xt, q=b.q, op=op)
    (y * torch.from_numpy(gy)).sum().backward()
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(want), rtol=RTOL,
                               atol=ATOL)


def test_the_graph_is_a_constant_of_the_backward():
    """The tiles and entries are the graph: asking autograd for their
    gradient raises rather than returning a silently missing one."""
    x = torch.zeros((32, 4), requires_grad=True)
    z = torch.zeros(1, dtype=torch.int32)
    tiles = torch.zeros((1, 16, 16), requires_grad=True)
    with pytest.raises(NotImplementedError, match="constant"):
        t_spmm.blocked_spmm(tiles, z, z, x, q=2)
    from repro_torch.kernels import fused_engn as t_fused
    with pytest.raises(NotImplementedError, match="constant"):
        t_fused.fused_engn_layer(tiles, z, z, x, torch.zeros((4, 3)), q=2)
    gr = {"rows": torch.zeros((1, 8), dtype=torch.int32),
          "cols": torch.zeros((1, 8), dtype=torch.int32),
          "vals": torch.zeros((1, 8), requires_grad=True),
          "block_row": z, "block_col": z}
    with pytest.raises(NotImplementedError, match="constant"):
        t_gather.packed_groups_spmm([gr], x, q=2)


def _no_transpose(monkeypatch):
    """Make every function that builds a carrier of A^T raise."""
    def refuse(*a, **k):
        raise AssertionError("a backward built a carrier of A^T")
    for name in ("transpose_blocks", "transpose_block_index",
                 "transpose_tile_store", "transpose_packed_store"):
        monkeypatch.setattr(t_partition, name, refuse)


@pytest.mark.parametrize("kind", ["blocked", "fused", "packed"])
def test_a_differentiated_call_builds_no_transposed_carrier(kind,
                                                            monkeypatch):
    """A sum under autograd (dense tiles, the fused layer, a plan's
    bucket groups) differentiates over its forward carrier: its gradient
    equals jax.grad of the reference, and no `transpose_*` runs."""
    g, x = _graph(seed=6)
    b = t_format.coo_to_blocked(g, 16)
    blocks, brow, bcol = j_spmm.prepare_blocks(b.blocks, b.block_row,
                                               b.block_col, b.q)
    rng = np.random.default_rng(11)
    xp = rng.standard_normal((b.padded_vertices, 5)).astype(np.float32)
    w = rng.standard_normal((5, 3)).astype(np.float32)
    gy = rng.standard_normal((b.padded_vertices,
                              3 if kind == "fused" else 5)
                             ).astype(np.float32)
    if kind == "packed":
        ps = t_partition.pack_tile_store(t_partition.build_tile_store(g, 16))
        flat = j_gather.flat_entries(ps)
        groups = t_engn.upload_groups(t_gather.prepare_packed_groups(ps),
                                       torch.device("cpu"))

        def j_fn(xx, ww):
            return j_gather.packed_flat_xla(*flat, xx, n=xx.shape[0])

        def t_fn(xx, ww):
            return t_gather.packed_groups_spmm(groups, xx, q=ps.q)
    elif kind == "blocked":
        def j_fn(xx, ww):
            return j_spmm.blocked_spmm_xla(blocks, brow, bcol, xx, q=b.q)

        def t_fn(xx, ww):
            return t_spmm.blocked_spmm(
                *map(torch.from_numpy, (blocks, brow, bcol)), xx, q=b.q)
    else:
        from repro.kernels.fused_engn import ops as j_fused
        from repro_torch.kernels import fused_engn as t_fused

        def j_fn(xx, ww):
            return j_fused.fused_engn_layer(blocks, brow, bcol, xx, ww,
                                            q=b.q, impl="xla")

        def t_fn(xx, ww):
            return t_fused.fused_engn_layer(
                *map(torch.from_numpy, (blocks, brow, bcol)), xx, ww, q=b.q)
    jgx, jgw = jax.grad(lambda xx, ww: jnp.sum(j_fn(xx, ww) * gy),
                        argnums=(0, 1))(jnp.asarray(xp), jnp.asarray(w))
    _no_transpose(monkeypatch)
    xt = torch.from_numpy(xp).requires_grad_(True)
    wt = torch.from_numpy(w).requires_grad_(True)
    (t_fn(xt, wt) * torch.from_numpy(gy)).sum().backward()
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(jgx), rtol=RTOL,
                               atol=ATOL)
    if kind == "fused":
        np.testing.assert_allclose(wt.grad.numpy(), np.asarray(jgw),
                                   rtol=RTOL, atol=ATOL)


def _full_grid_graph(n=96, tile=16, seed=0):
    """A GCN-normalised graph with at least one edge in every (dst, src)
    interval pair, so the gate's min(q^2, E) dense price is the
    carrier's true size (no pad tile, every grid cell a tile)."""
    rng = np.random.default_rng(seed)
    q = -(-n // tile)
    cells = np.arange(q * q)
    src = np.concatenate([(cells % q) * tile + rng.integers(0, tile, q * q),
                          rng.integers(0, n, 4 * n)]) % n
    dst = np.concatenate([(cells // q) * tile
                          + rng.integers(0, tile, q * q),
                          rng.integers(0, n, 4 * n)]) % n
    key, val = j_partition.merge_by_key(
        dst.astype(np.int64) * n + src, np.ones(src.size, np.float32))
    g = t_format.COOGraph(n, (key % n).astype(np.int32),
                          (key // n).astype(np.int32), val)
    return g.gcn_normalized()


@pytest.mark.parametrize("kind", ["blocked", "fused", "packed"])
def test_a_training_plan_admitted_under_a_budget_stays_in_it(kind):
    """Fault C1 of the port: a GCN training plan admitted by the budget
    gate at `dense_footprint_bytes(training=True)` (dense tiles, fused)
    or the packed price (a plan of bucket groups, as the card's), trains
    one step, and afterwards holds no tensor byte it did not hold after
    prepare_graph and stays within the budget: no backward builds a
    carrier of A^T outside the gate."""
    g = _full_grid_graph()
    dims = [8, 8, 4]
    backend = "fused" if kind == "fused" else "blocked"
    fmt = "packed" if kind == "packed" else "dense"
    tl = rt.make_gnn_stack("gcn", dims, backend=backend, tile=16,
                           device="cpu")
    cfg = tl[0].cfg
    cfg.tile_format, cfg.training, cfg.auto_spill = fmt, True, False
    budget = dense_footprint_bytes(g.num_vertices, g.num_edges, cfg.in_dim,
                                   cfg.out_dim, backend, tile=16,
                                   tile_format=fmt, training=True)
    cfg.device_budget_bytes = budget
    plan = rt.prepare_graph(g, cfg, device="cpu")
    assert plan.backend == backend and plan.tile_format == fmt
    q = plan.meta["q"]
    if kind == "packed":
        # the card's carrier, bucket groups with their work table
        ps = t_partition.pack_tile_store(t_partition.build_tile_store(g, 16))
        c = {k: v for k, v in plan.carrier.items() if k != "packed_flat"}
        c["packed_groups"] = t_engn.upload_groups(
            t_gather.prepare_packed_groups(ps, cfg.packed_bucket_floor),
            torch.device("cpu"))
        plan = rt.PreparedPlan(backend=backend, n=plan.n, carrier=c,
                               tile_format=fmt)
    else:
        assert plan.carrier["blocks"].shape[0] == q * q    # the true price
    held = plan.held_bytes()
    assert held <= budget
    x = torch.from_numpy(random_features(g.num_vertices, dims[0], seed=2))
    cot = torch.from_numpy(np.random.default_rng(3).standard_normal(
        (g.num_vertices, dims[-1])).astype(np.float32))
    ps_ = [{k: v.clone().requires_grad_(True) for k, v in p.items()}
           for p in stack_params(tl)]
    (rt.apply_stack(tl, plan, x, params=ps_) * cot).sum().backward()
    assert all(p.grad is not None for d in ps_ for p in d.values())
    assert plan.held_bytes() == held <= budget


# -- optimizer, clip, schedules, data ------------------------------------------

def _tree(rng):
    return [{"w": rng.standard_normal((5, 3)).astype(np.float32),
             "b_pool": rng.standard_normal(3).astype(np.float32)},
            {"w": rng.standard_normal((3, 2)).astype(np.float32)}]


def _to_torch(tree):
    return t_opt.tree_map(lambda a: torch.from_numpy(np.array(a)), tree)


def _close(t_tree, j_tree, tol=1e-6):
    tl, jl = t_opt.tree_leaves(t_tree), jax.tree.leaves(j_tree)
    assert len(tl) == len(jl)
    for a, b in zip(tl, jl):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=tol,
                                   atol=tol)


@pytest.mark.parametrize("max_norm", [0.5, 100.0])
def test_adamw_and_clip_match_reference(max_norm):
    rng = np.random.default_rng(0)
    params = _tree(rng)
    cfg_j = j_opt.AdamWConfig(weight_decay=0.01, clip_norm=max_norm)
    cfg_t = t_opt.AdamWConfig(weight_decay=0.01, clip_norm=max_norm)
    assert dataclasses_equal(cfg_j, cfg_t)
    jp, tp = jax.tree.map(jnp.asarray, params), _to_torch(params)
    jo, to = j_opt.init_opt_state(jp), t_opt.init_opt_state(tp)
    for step in range(4):
        grads = _tree(rng)
        jg, jn = j_opt.clip_by_global_norm(jax.tree.map(jnp.asarray, grads),
                                           max_norm)
        tg, tn = t_opt.clip_by_global_norm(_to_torch(grads), max_norm)
        np.testing.assert_allclose(float(tn), float(jn), rtol=1e-6)
        _close(tg, jg)
        lr = 1e-2 * (step + 1)
        jp, jo = j_opt.adamw_update(cfg_j, jg, jo, jp, lr)
        tp, to = t_opt.adamw_update(cfg_t, tg, to, tp,
                                    torch.tensor(lr, dtype=torch.float32))
        _close(tp, jp)
        _close(to["m"], jo["m"])
        _close(to["v"], jo["v"])
        assert int(to["count"]) == int(jo["count"]) == step + 1
    assert to["count"].dtype == torch.int32


def dataclasses_equal(a, b):
    import dataclasses
    return dataclasses.asdict(a) == dataclasses.asdict(b)


@pytest.mark.parametrize("name", ["cosine", "wsd"])
def test_schedules_match_reference(name):
    jf, jkw = j_sched.get_schedule(name, peak_lr=5e-3)
    tf, tkw = t_sched.get_schedule(name, peak_lr=5e-3)
    assert jkw == tkw
    for step in list(range(0, 40)) + [99, 100, 150]:
        want = float(jf(step, warmup=7, total=100, **jkw))
        for arg in (step, float(step),
                    torch.tensor(step, dtype=torch.int32)):
            got = tf(arg, warmup=7, total=100, **tkw)
            assert isinstance(got, torch.Tensor) and got.dim() == 0
            np.testing.assert_allclose(float(got), want, rtol=1e-6,
                                       atol=1e-9)


def test_graph_node_stream_batches_equal_reference():
    js = j_pipeline.GraphNodeStream(500, 7, batch=33, seed=4)
    ts = t_pipeline.GraphNodeStream(500, 7, batch=33, seed=4)
    for _ in range(3):
        a, b = next(js), next(ts)
        assert a.keys() == b.keys()
        for k in a:
            np.testing.assert_array_equal(a[k], b[k])
            assert a[k].dtype == b[k].dtype
    js.seek(1)
    ts.seek(1)
    assert js.cursor() == ts.cursor() == 1
    np.testing.assert_array_equal(next(js)["nodes"], next(ts)["nodes"])


# -- the launcher -----------------------------------------------------------

def _gnn_kw(steps):
    return dict(model="gcn", dataset="pubmed", steps=steps, hidden=8,
                batch=64, max_vertices=300, max_edges=2000)


@pytest.mark.parametrize("backend", ["segment", "blocked"])
def test_gcn_trajectory_matches_reference_from_its_init(backend):
    """`tests/test_launcher.py::_gnn_losses`, 8 steps, both packages from
    the reference's initial weights (student and teacher)."""
    _trajectory_matches_reference("gcn", backend)


@pytest.mark.parametrize("backend", ["segment", "blocked"])
@pytest.mark.parametrize("model", ["rgcn", "gated_gcn"])
def test_staged_trajectory_matches_reference_from_its_init(model, backend):
    """The staged models' 8-step `build_gnn` trajectories (R-GCN on the
    3-type colouring) from the reference's initial weights."""
    _trajectory_matches_reference(model, backend)


def _trajectory_matches_reference(model, backend):
    from repro.launch.train import build_gnn as j_build_gnn
    steps = 8
    kw = {**_gnn_kw(steps), "model": model}
    step, state, data, gd, aux = j_build_gnn(backend=backend, **kw)
    f, classes = aux["x"].shape[1], aux["num_classes"]
    teacher = j_models.init_stack(
        j_models.make_gnn_stack("gcn", [f, 16, classes]), jax.random.key(42))
    refs = {"student": [{k: np.asarray(v) for k, v in p.items()}
                        for p in state["params"]],
            "teacher": [{k: np.asarray(v) for k, v in p.items()}
                        for p in teacher]}
    want = []
    ps, opt = state["params"], state["opt"]
    for _ in range(steps):
        ps, opt, m = step(ps, opt, next(data))
        want.append(float(m["loss"]))

    tstep, tstate, tdata, tgd, taux = t_train.build_gnn(
        backend=backend, device="cpu", reference_params=refs, **kw)
    assert (tgd.backend, tgd.tile_format) == (gd.backend, gd.tile_format)
    np.testing.assert_array_equal(taux["y_true"].numpy(),
                                  np.asarray(aux["y_true"]))
    got = []
    ps, opt = tstate["params"], tstate["opt"]
    for _ in range(steps):
        ps, opt, m = tstep(ps, opt, next(tdata))
        got.append(float(m["loss"]))
        assert set(m) == {"loss", "grad_norm", "lr"}
    np.testing.assert_allclose(got, want, rtol=1e-3, atol=1e-4)
    assert got[-1] < got[0]


@pytest.mark.parametrize("model,backend", [("gcn", "fused"),
                                           ("gs_pool", "blocked"),
                                           ("gs_pool", "segment")])
def test_backends_train_along_segment(model, backend):
    """The port's own init: each resident backend follows the segment
    trajectory."""
    def losses(b):
        step, state, data, _, _ = t_train.build_gnn(
            **{**_gnn_kw(6), "model": model}, backend=b, device="cpu")
        ps, opt, out = state["params"], state["opt"], []
        for _ in range(6):
            ps, opt, m = step(ps, opt, next(data))
            out.append(float(m["loss"]))
        return out
    got = losses(backend)
    assert all(np.isfinite(got))
    np.testing.assert_allclose(got, losses("segment"), rtol=1e-3, atol=1e-4)


def _args(tmp_path, **kw):
    base = dict(gnn="gcn", gnn_backend="blocked", gnn_shards=None,
                gnn_hidden=8, dataset="cora", device_budget=0, steps=4,
                batch=32, ckpt_dir=str(tmp_path), ckpt_every=2,
                chaos_seed=None, device="cpu")
    return argparse.Namespace(**{**base, **kw})


def test_run_gnn_checkpoints_and_resumes(tmp_path):
    first = t_train.run_gnn(_args(tmp_path, steps=2))
    assert (first["start"], first["steps"], first["saves"]) == (0, 2, 1)
    mgr = t_ckpt.CheckpointManager(tmp_path)
    assert mgr.latest_step() == 2
    second = t_train.run_gnn(_args(tmp_path, steps=4))
    assert (second["start"], second["steps"]) == (2, 4)
    assert len(second["losses"]) == 2 and all(np.isfinite(second["losses"]))
    assert mgr.latest_step() == 4


def test_launcher_main_trains_on_the_cpu_when_asked(tmp_path):
    out = t_train.main(["--gnn", "gcn", "--gnn-backend", "fused",
                        "--dataset", "cora", "--steps", "2", "--batch", "16",
                        "--gnn-hidden", "8", "--device", "cpu",
                        "--ckpt-dir", str(tmp_path)])
    assert out["steps"] == 2 and len(out["losses"]) == 2


@pytest.mark.parametrize("case,item", [
    ("ring", "A8"), ("shards", "A8"), ("chaos", "A11"), ("lm", "A12"),
    ("remesh", "A8")])
def test_unported_training_paths_raise_with_their_roadmap_item(case, item,
                                                              tmp_path):
    kw = dict(_gnn_kw(2), device="cpu")
    with pytest.raises(NotImplementedError, match=f"ROADMAP {item}"):
        if case == "ring":
            t_train.build_gnn(backend="ring", **kw)
        elif case == "shards":
            t_train.build_gnn(backend="blocked", ring_shards=2, **kw)
        elif case == "chaos":
            t_train.run_gnn(_args(tmp_path, chaos_seed=3))
        elif case == "lm":
            t_train.main(["--arch", "granite_3_2b"])
        else:
            _, _, _, _, aux = t_train.build_gnn(backend="segment", **kw)
            aux["trainer"].remesh(2)


def test_launcher_defaults_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device works")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        t_train.build_gnn(backend="blocked", **_gnn_kw(2))


def test_trainer_hooks_are_no_ops_off_the_ring():
    _, state, _, gd, aux = t_train.build_gnn(backend="blocked", device="cpu",
                                             **_gnn_kw(2))
    tr = aux["trainer"]
    plan = tr.plan
    tr.on_failure(RuntimeError("transient"))
    tr.on_straggler(3, 1.0)
    assert tr.plan is plan and tr.stats == {"strikes": 1}


# -- checkpoints across the two packages --------------------------------------

def _state_pair(rng):
    params = _tree(rng)
    jp = jax.tree.map(jnp.asarray, params)
    jstate = {"params": jp, "opt": j_opt.init_opt_state(jp)}
    jstate["opt"]["count"] = jnp.asarray(5, jnp.int32)
    tp = _to_torch(params)
    tstate = {"params": tp, "opt": t_opt.init_opt_state(tp)}
    return jstate, tstate


def test_reference_checkpoint_restores_in_the_port(tmp_path):
    jstate, tstate = _state_pair(np.random.default_rng(1))
    jm = j_ckpt.CheckpointManager(tmp_path, keep=2)
    jm.save(7, jstate, metadata={"cursor": 7, "step": 7})
    tm = t_ckpt.CheckpointManager(tmp_path, keep=2)
    assert tm.latest_step() == 7
    got, meta, step = tm.restore(tstate)
    assert (meta, step) == ({"cursor": 7, "step": 7}, 7)
    _close(got, jstate, tol=0)
    assert isinstance(got["opt"]["count"], torch.Tensor)
    assert int(got["opt"]["count"]) == 5


def test_port_checkpoint_restores_in_the_reference(tmp_path):
    jstate, tstate = _state_pair(np.random.default_rng(2))
    tstate["opt"]["count"] = torch.tensor(9, dtype=torch.int32)
    tm = t_ckpt.CheckpointManager(tmp_path, keep=1, async_save=True)
    tm.save(3, tstate, metadata={"cursor": 3})
    tm.save(4, tstate, metadata={"cursor": 4})
    tm.wait()
    assert tm.all_steps() == [4]                     # keep=1 collected 3
    jm = j_ckpt.CheckpointManager(tmp_path)
    got, meta, step = jm.restore(jstate)
    assert (meta, step) == ({"cursor": 4}, 4)
    _close(tstate, got, tol=0)
    assert int(got["opt"]["count"]) == 9
    # the two packages write the same manifest for the same tree
    jdir, tdir = tmp_path / "j", tmp_path / "t"
    j_ckpt.CheckpointManager(jdir).save(1, jstate)
    t_ckpt.CheckpointManager(tdir).save(1, tstate)
    import json
    names = [json.loads((d / "step_0000000001" / "manifest.json")
                        .read_text())["names"] for d in (jdir, tdir)]
    assert names[0] == names[1]


def test_restore_falls_back_past_a_corrupt_checkpoint(tmp_path):
    _, tstate = _state_pair(np.random.default_rng(3))
    tm = t_ckpt.CheckpointManager(tmp_path, keep=3)
    tm.save(1, tstate)
    tm.save(2, tstate)
    (tmp_path / "step_0000000002" / "00000.npy").write_bytes(b"torn")
    with pytest.warns(RuntimeWarning, match="corrupt"):
        _, _, step = tm.restore(tstate)
    assert step == 1
    with pytest.raises(t_ckpt.CorruptCheckpointError):
        tm.restore(tstate, step=2)


# -- on the card ---------------------------------------------------------------

def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("model,backend,fmt", GRAD_CASES)
def test_card_gradients_match_cpu(model, backend, fmt):
    """The backward kernels (transposed sums, the max backwards, the
    fused backward) against the CPU's plain backward, one step."""
    dev = _card()
    from repro_torch.kernels import launch_counts
    g, x = _graph()
    grads = []
    for d in ("cpu", dev):
        _, _, tl = _stacks(model, DIMS[model], backend, fmt)
        tl = [layer.to(d) for layer in tl]
        plan = rt.prepare_graph(g, tl[0].cfg, device=d)
        ps = [{k: v.clone().requires_grad_(True) for k, v in p.items()}
              for p in stack_params(tl)]
        xt = torch.from_numpy(x).to(d).requires_grad_(True)
        before = sum(launch_counts().values())
        out = rt.apply_stack(tl, plan, xt, params=ps)
        cot = torch.from_numpy(np.random.default_rng(7).standard_normal(
            tuple(out.shape)).astype(np.float32)).to(d)
        (out * cot).sum().backward()
        if d != "cpu" and backend != "segment":
            assert sum(launch_counts().values()) > before
        grads.append([xt.grad.cpu()] + [p[k].grad.cpu() for p in ps
                                        for k in sorted(p)])
    for a, b in zip(*grads):
        np.testing.assert_allclose(b.numpy(), a.numpy(), rtol=RTOL,
                                   atol=ATOL)


@pytest.mark.cuda
@pytest.mark.parametrize("floor", [1, 8])
def test_card_packed_group_max_backward_matches_flat(floor):
    dev = _card()
    g, _ = _graph(seed=3)
    ps = t_partition.pack_tile_store(t_partition.build_tile_store(g, 16))
    rng = np.random.default_rng(floor)
    x = rng.integers(-2, 3, (ps.padded_vertices, 40)).astype(np.float32)
    gy = torch.from_numpy(rng.standard_normal(x.shape).astype(np.float32))
    flat = [torch.from_numpy(a).to(dev) for a in t_gather.flat_entries(ps)]
    xf = torch.from_numpy(x).to(dev).requires_grad_(True)
    (t_gather.packed_flat_plain(*flat, xf, n=x.shape[0], op="max")
     * gy.to(dev)).sum().backward()
    groups = t_engn.upload_groups(t_gather.prepare_packed_groups(ps, floor),
                                   dev)
    xt = torch.from_numpy(x).to(dev).requires_grad_(True)
    (t_gather.packed_groups_spmm(groups, xt, q=ps.q, op="max")
     * gy.to(dev)).sum().backward()
    np.testing.assert_allclose(xt.grad.cpu().numpy(), xf.grad.cpu().numpy(),
                               rtol=1e-5, atol=1e-6)


@pytest.mark.cuda
def test_card_dense_training_plan_stays_in_budget():
    """Fault C1 on the card: a GCN dense training plan admitted by the
    gate at `dense_footprint_bytes(training=True)` (a tile in every grid
    cell, so the price is the carrier's true size: 64 MiB of tiles)
    keeps the memory allocated over its first forward and backward
    within the budget; a carrier of A^T would add another 64 MiB."""
    dev = _card()
    g = _full_grid_graph(n=4096, tile=256)
    (layer,) = rt.make_gnn_stack("gcn", [64, 4], backend="blocked",
                                 tile=256)
    cfg = layer.cfg
    cfg.tile_format, cfg.training, cfg.auto_spill = "dense", True, False
    budget = dense_footprint_bytes(g.num_vertices, g.num_edges, 64, 4,
                                   "blocked", tile=256, training=True)
    cfg.device_budget_bytes = budget
    x = torch.from_numpy(random_features(g.num_vertices, 64,
                                         seed=2)).to(dev)
    cot = torch.ones((g.num_vertices, 4), device=dev)
    (x[:8] @ layer.w).sum().item()             # cuBLAS' workspace first
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    plan = rt.prepare_graph(g, cfg)
    assert plan.carrier["blocks"].shape[0] == 16 * 16
    from repro_torch.kernels import launch_counts
    before = launch_counts()["rer_spmm_sum_t"]
    (rt.apply_stack([layer], plan, x) * cot).sum().backward()
    torch.cuda.synchronize()
    assert launch_counts()["rer_spmm_sum_t"] == before + 1
    assert layer.w.grad is not None
    assert torch.cuda.max_memory_allocated() - base <= budget


@pytest.mark.cuda
def test_card_trajectory_matches_cpu():
    _card()
    losses = []
    for d in ("cpu", None):
        step, state, data, _, _ = t_train.build_gnn(
            backend="blocked", device=d, **_gnn_kw(6))
        ps, opt, out = state["params"], state["opt"], []
        for _ in range(6):
            ps, opt, m = step(ps, opt, next(data))
            out.append(float(m["loss"]))
        losses.append(out)
    np.testing.assert_allclose(losses[1], losses[0], rtol=1e-3, atol=1e-4)
