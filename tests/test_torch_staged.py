"""R-GCN and Gated-GCN in the port (the typed and gated stage contracts)
against the reference, on the CPU.

The reference matrix's sizes (`tests/test_backend_matrix.py`: DIM=6,
HID=5, RELS=3, TILE=16, its four typed graphs): forwards on "segment",
"blocked" dense and packed and "tiled" dense and packed (rtol=atol=1e-4,
the matrix's tolerance); R-GCN stripped to its raw typed sum with
integer weights, every route bit for bit equal to the port's "segment"
(`torch.equal`); the typed carriers, `fold_rel_norm` and the streamed
executor's counters exactly equal; one-step gradients of every parameter
against `jax.grad` (rtol=1e-4, atol=1e-5).  Inputs are made from seeds
with numpy; weights cross with `load_reference_params`.  The card's
twins (B1 once per relation, a gated dense plan, the gated dense size
check) carry the `cuda` marker.
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
from repro.graphs.format import COOGraph as JCOO
from repro.graphs.generate import rmat_graph
import repro_torch as rt
from repro_torch import tracing
from repro_torch.core import engn as t_engn
from repro_torch.core import models as t_models
from repro_torch.core import tiled as t_tiled
from repro_torch.graphs.format import COOGraph as TCOO
from repro_torch.interop import load_reference_params
from repro_torch.kernels import rer_spmm as t_spmm

TILE, DIM, HID, RELS = 16, 6, 5, 3
RTOL, ATOL = 1e-4, 1e-4               # the reference matrix's
GRAD_RTOL, GRAD_ATOL = 1e-4, 1e-5
MODELS = ["rgcn", "gated_gcn"]
ROUTES = [("segment", "auto"), ("blocked", "dense"), ("blocked", "packed"),
          ("tiled", "dense"), ("tiled", "packed")]
ROUTE_IDS = ["segment", "blocked-dense", "blocked-packed", "tiled-dense",
             "tiled-packed"]


# -- graphs: the reference matrix's typed fixtures ---------------------------

def _int_graph(n, e, seed):
    """Deduplicated graph with weights in {1, 2, 3}."""
    g = rmat_graph(n, e, seed=seed)
    uniq = np.unique(np.stack([g.src, g.dst]), axis=1)
    val = np.random.default_rng(seed).integers(1, 4, uniq.shape[1])
    return uniq[0].astype(np.int32), uniq[1].astype(np.int32), \
        val.astype(np.float32)


def _typed_int_graph(n, e, seed, collide=False):
    """rel = (src + dst) % RELS; with `collide` a quarter of the edges
    repeat under the next relation (one adjacency cell, two types)."""
    src, dst, val = _int_graph(n, e, seed)
    rel = ((src.astype(np.int64) + dst) % RELS).astype(np.int32)
    if collide:
        k = max(1, src.size // 4)
        src = np.concatenate([src, src[:k]])
        dst = np.concatenate([dst, dst[:k]])
        val = np.concatenate([val, np.full(k, 2.0, np.float32)])
        rel = np.concatenate([rel, (rel[:k] + 1) % RELS])
    return JCOO(n, src, dst, val, rel, RELS)


_TYPED_SPECS = {
    "even": (96, 500, 0, False),
    "uneven": (101, 600, 1, False),
    "empty_tile": (64, 3, 2, False),
    "collision": (64, 400, 3, True),
}
KINDS = sorted(_TYPED_SPECS)
_CACHE = {}


def _typed_graph(kind):
    """(reference graph, port graph, integer features)."""
    if kind not in _CACHE:
        n, e, seed, collide = _TYPED_SPECS[kind]
        g = _typed_int_graph(n, e, seed, collide)
        x = np.random.default_rng(seed + 17).integers(
            -3, 4, (n, DIM)).astype(np.float32)
        _CACHE[kind] = (g, _port(g), x)
    return _CACHE[kind]


def _port(g):
    return TCOO(g.num_vertices, g.src, g.dst, g.val, g.rel, g.num_relations)


def _real_typed_graph(n=80, e=500, seed=4):
    """Real-valued weights and features (sums are allclose, not exact)."""
    g = rmat_graph(n, e, seed=seed)
    rng = np.random.default_rng(seed)
    rel = rng.integers(0, RELS, g.num_edges).astype(np.int32)
    val = rng.uniform(0.1, 1.0, g.num_edges).astype(np.float32)
    jg = JCOO(n, g.src, g.dst, val, rel, RELS)
    x = rng.standard_normal((n, DIM)).astype(np.float32)
    return jg, _port(jg), x


# -- layers: both packages, one set of weights -------------------------------

def _cfg(mod, backend, fmt, **kw):
    cfg = mod.EnGNConfig(in_dim=DIM, out_dim=HID, backend=backend, tile=TILE,
                         tile_format=fmt, **kw)
    return cfg


def _np_params(p):
    return {k: np.asarray(v) for k, v in p.items()}


def _pair(model, backend, fmt, key=11, **kw):
    """(reference layer, its params, the port's layer with those
    weights)."""
    if model == "rgcn":
        jl = j_models.RGCNLayer(_cfg(j_engn, backend, fmt, **kw), RELS)
        tl = t_models.RGCNLayer(_cfg(t_engn, backend, fmt, **kw), RELS,
                                device="cpu")
    else:
        jl = j_models.GatedGCNLayer(_cfg(j_engn, backend, fmt, **kw))
        tl = t_models.GatedGCNLayer(_cfg(t_engn, backend, fmt, **kw),
                                    device="cpu")
    params = jl.init(jax.random.key(key))
    load_reference_params([tl], [_np_params(params)])
    return jl, params, tl


def _forward(tl, plan, x):
    with torch.no_grad():
        return tl(plan, torch.from_numpy(x))


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("route", ROUTES, ids=ROUTE_IDS)
@pytest.mark.parametrize("model", MODELS)
def test_staged_forward_matches_reference(model, route, kind):
    """Each staged model on each route equals the reference's layer on
    the same route, and lands on the same backend and tile format."""
    backend, fmt = route
    g, tg, x = _typed_graph(kind)
    jl, params, tl = _pair(model, backend, fmt)
    jplan = j_engn.prepare_graph(g, jl.cfg)
    want = np.asarray(jl.apply(params, jplan, jnp.asarray(x)))
    plan = rt.prepare_graph(tg, tl.cfg, device="cpu")
    assert (plan.backend, plan.tile_format) == (jplan.backend,
                                                jplan.tile_format)
    got = _forward(tl, plan, x)
    assert got.shape == (g.num_vertices, HID) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)


# -- the raw typed sum, bit for bit ------------------------------------------

class _TypedSumProbe(t_models.RGCNLayer):
    """R-GCN stripped to its raw relation-typed sum (no normalisation,
    identity update): with integer weights and features every route's
    sum is exact, so each must equal "segment" bit for bit."""

    def __init__(self, cfg, rels, **kw):
        super().__init__(cfg, rels, **kw)
        self.cfg = dataclasses.replace(self.cfg, rel_normalize=False)

    def stage_spec(self):
        return {"kind": "typed", "num_relations": self.num_relations,
                "channels": self.cfg.out_dim, "normalize": False}

    def update(self, x_self, agg):
        return agg


class _JTypedSumProbe(j_models.RGCNLayer):
    def __init__(self, cfg, rels):
        super().__init__(cfg, rels)
        self.cfg = dataclasses.replace(self.cfg, rel_normalize=False)

    def stage_spec(self):
        return {"kind": "typed", "num_relations": self.num_relations,
                "channels": self.cfg.out_dim, "normalize": False}

    def update(self, params, x_self, agg):
        return agg


def _int_typed_params(seed=0):
    rng = np.random.default_rng(seed + 23)
    return {"w0": np.zeros((DIM, HID), np.float32),
            "wr": rng.integers(-2, 3, (RELS, DIM, HID)).astype(np.float32)}


def _probe(backend, fmt, params):
    p = _TypedSumProbe(_cfg(t_engn, backend, fmt), RELS, device="cpu")
    load_reference_params([p], [params])
    return p


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("route", ROUTES[1:], ids=ROUTE_IDS[1:])
def test_typed_sum_probe_bitwise_equal_to_segment(route, kind):
    """sum_r A_r X W_r with integer weights, features and projections:
    every typed carrier (B1 per relation, flat entries over their
    (src, relation) pairs' rows, the streamed typed tiles) equals the
    port's "segment", which equals the reference's."""
    backend, fmt = route
    g, tg, x = _typed_graph(kind)
    params = _int_typed_params()
    seg = _probe("segment", fmt, params)
    want = _forward(seg, rt.prepare_graph(tg, seg.cfg, device="cpu"), x)
    jseg = _JTypedSumProbe(_cfg(j_engn, "segment", fmt), RELS)
    jwant = np.asarray(jseg.apply(
        {k: jnp.asarray(v) for k, v in params.items()},
        j_engn.prepare_graph(g, jseg.cfg), jnp.asarray(x)))
    assert np.array_equal(want.numpy(), jwant)
    probe = _probe(backend, fmt, params)
    plan = rt.prepare_graph(tg, probe.cfg, device="cpu")
    tracing.reset()
    got = _forward(probe, plan, x)
    assert torch.equal(got, want), (backend, fmt, kind)
    # the flat entries take the pair route: one projected row per
    # (src, relation) pair that sends
    rows = tracing.report().get("typed.pair_rows", {}).get("calls")
    if (backend, fmt) == ("blocked", "packed"):
        assert rows == plan.carrier["typed_pairs"].num_pairs > 0
    else:
        assert rows is None


def test_typed_dense_plan_launches_b1_once_per_relation(monkeypatch):
    """A typed dense forward calls B1 once for each relation that has
    tiles, each on a contiguous (q*T, H) payload slice."""
    g, tg, x = _typed_graph("collision")
    calls = []
    real = t_spmm.blocked_spmm

    def spy(blocks, block_row, block_col, xr, **kw):
        assert xr.is_contiguous() and xr.shape[1] == HID
        calls.append(kw["q"])
        return real(blocks, block_row, block_col, xr, **kw)
    monkeypatch.setattr(t_spmm, "blocked_spmm", spy)
    _, _, tl = _pair("rgcn", "blocked", "dense")
    plan = rt.prepare_graph(tg, tl.cfg, device="cpu")
    _forward(tl, plan, x)
    assert len(calls) == len(plan.carrier["typed_blocks"]) == RELS


# -- carriers and the host-side fold -----------------------------------------

@pytest.mark.parametrize("kind", KINDS)
def test_fold_rel_norm_equals_reference(kind):
    g, tg, _ = _typed_graph(kind)
    for jg_, tg_ in ((g, tg), (dataclasses.replace(g, val=None),
                               dataclasses.replace(tg, val=None))):
        want = j_engn.fold_rel_norm(jg_)
        got = t_engn.fold_rel_norm(tg_)
        for f in ("src", "dst", "val", "rel"):
            a, b = getattr(got, f), getattr(want, f)
            assert a.dtype == b.dtype and np.array_equal(a, b), f
        assert got.num_relations == want.num_relations
    # a segment plan carries the folded weights and says so, once
    _, _, tl = _pair("rgcn", "segment", "auto")
    plan = rt.prepare_graph(tg, tl.cfg, device="cpu")
    assert plan.carrier["rel_normed"] is True
    np.testing.assert_array_equal(plan.carrier["val"].numpy(),
                                  t_engn.fold_rel_norm(tg).val)
    with pytest.raises(ValueError, match="relation-typed"):
        t_engn.fold_rel_norm(TCOO(4, tg.src[:0], tg.dst[:0]))


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("fmt", ["dense", "packed", "auto"])
def test_typed_blocked_carriers_equal_reference(fmt, kind):
    """One dense B1 plan per relation with edges (dense), or the flat
    entries with their relation column ("packed" / "auto"), field for
    field the reference's."""
    g, tg, _ = _typed_graph(kind)
    jl, _, tl = _pair("rgcn", "blocked", fmt)
    jc = j_engn.prepare_graph(g, jl.cfg).carrier
    tc = rt.prepare_graph(tg, tl.cfg, device="cpu").carrier
    jm, tm = dict(jc["blocks_meta"]), dict(tc["blocks_meta"])
    assert jm == tm
    if fmt == "dense":
        assert "typed_flat" not in tc
        assert len(tc["typed_blocks"]) == len(jc["typed_blocks"])
        for a, b in zip(tc["typed_blocks"], jc["typed_blocks"]):
            assert (a["rel"], a["q"]) == (b["rel"], b["q"])
            for k in ("blocks", "block_row", "block_col"):
                np.testing.assert_array_equal(a[k].numpy(),
                                              np.asarray(b[k]))
    else:
        assert "typed_blocks" not in tc
        for a, b in zip(tc["typed_flat"], jc["typed_flat"]):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))


@pytest.mark.parametrize("kind", ["even", "collision"])
def test_gated_packed_plan_takes_flat_entries(kind):
    """A gated packed plan carries flat entries (on every device), as the
    reference's; an untyped packed plan on the CPU does too."""
    g, tg, _ = _typed_graph(kind)
    jl, _, tl = _pair("gated_gcn", "blocked", "packed")
    jc = j_engn.prepare_graph(g, jl.cfg).carrier
    tc = rt.prepare_graph(tg, tl.cfg, device="cpu").carrier
    assert "packed_groups" not in tc
    for a, b in zip(tc["packed_flat"], jc["packed_flat"]):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


# -- DASR, refusals, parameters ----------------------------------------------

def test_rgcn_fau_equals_afu_on_segment():
    """Both stage orders on "segment", on a raw dict (no `rel_normed`:
    the normalisation runs in the layer) and on a plan (folded), equal
    each other and the reference's."""
    g, tg, x = _real_typed_graph()
    f, h = DIM, 10                        # F < H: auto picks afu
    jls = [j_models.RGCNLayer(j_engn.EnGNConfig(f, h, stage_order=o), RELS)
           for o in ("fau", "afu")]
    params = jls[0].init(jax.random.key(5))
    tls = [t_models.RGCNLayer(t_engn.EnGNConfig(f, h, stage_order=o), RELS,
                              device="cpu") for o in ("fau", "afu")]
    load_reference_params(tls, [_np_params(params)] * 2)
    raw = {"n": tg.num_vertices, "src": torch.from_numpy(tg.src),
           "dst": torch.from_numpy(tg.dst), "val": torch.from_numpy(tg.val),
           "rel": torch.from_numpy(tg.rel)}
    jraw = {"n": g.num_vertices, "src": jnp.asarray(g.src),
            "dst": jnp.asarray(g.dst), "val": jnp.asarray(g.val),
            "rel": jnp.asarray(g.rel)}
    want = np.asarray(jls[0].apply(params, jraw, jnp.asarray(x)))
    plan = rt.prepare_graph(tg, tls[0].cfg, device="cpu")
    outs = [_forward(tl, gr, x).numpy() for tl in tls for gr in (raw, plan)]
    for o in outs:
        np.testing.assert_allclose(o, want, rtol=RTOL, atol=ATOL)
    assert tls[1].dasr_order() == "afu" and tls[0].dasr_order() == "fau"
    assert t_models.make_gnn("rgcn", f, h, num_relations=RELS,
                             device="cpu").dasr_order() == "afu"


@pytest.mark.parametrize("model", MODELS)
def test_fused_and_non_sum_refuse_staged_models(model):
    """The fused kernel serves the default contract only, and both staged
    contracts aggregate by sum: each refusal is a ValueError, as in the
    reference."""
    g, tg, x = _typed_graph("even")
    _, _, tl = _pair(model, "fused", "auto")
    plan = rt.prepare_graph(tg, tl.cfg, device="cpu")
    with pytest.raises(ValueError, match="fused"):
        _forward(tl, plan, x)
    _, _, tl = _pair(model, "segment", "auto")
    tl.cfg = dataclasses.replace(tl.cfg, aggregate_op="max")
    with pytest.raises(ValueError, match="aggregates by sum"):
        _forward(tl, rt.prepare_graph(tg, tl.cfg, device="cpu"), x)


def test_gated_layer_over_groups_equals_the_flat_route():
    """A gated layer handed a plan's bucket groups (the card's carrier,
    built here on CPU tensors, with the source table) runs the gated
    aggregate's plain version over them and equals the flat route of the
    CPU plan, within the reference matrix's tolerance."""
    from repro_torch.graphs.partition import build_tile_store, \
        pack_tile_store
    from repro_torch.kernels.rer_gather import prepare_packed_groups
    _, tg, x = _typed_graph("even")
    _, _, tl = _pair("gated_gcn", "blocked", "packed")
    plan = rt.prepare_graph(tg, tl.cfg, device="cpu")
    carrier = dict(plan.carrier)
    carrier.pop("packed_flat")
    carrier["packed_groups"] = t_engn.upload_groups(
        prepare_packed_groups(pack_tile_store(build_tile_store(tg, TILE))),
        "cpu", source=True)
    np.testing.assert_allclose(_forward(tl, carrier, x).numpy(),
                               _forward(tl, plan, x).numpy(), rtol=RTOL,
                               atol=ATOL)


@pytest.mark.parametrize("model", MODELS)
def test_staged_parameters_are_the_reference_layout(model):
    """Names and shapes equal the reference's init (R-GCN's `wr` is
    (R, F, H)), so reference weights load as they are; make_gnn and
    make_gnn_stack build both models."""
    jl, params, tl = _pair(model, "segment", "auto")
    got = {k: tuple(v.shape) for k, v in tl.named_parameters()}
    assert got == {k: tuple(np.shape(v)) for k, v in params.items()}
    for k, v in tl.named_parameters():
        np.testing.assert_array_equal(v.detach().numpy(),
                                      np.asarray(params[k]))
    stack = rt.make_gnn_stack(model, [DIM, 8, HID], num_relations=RELS,
                              device="cpu")
    jstack = j_models.make_gnn_stack(model, [DIM, 8, HID],
                                     num_relations=RELS)
    for a, b in zip(stack, jstack):
        assert a.cfg.stage_contract == b.cfg.stage_contract
        assert a.cfg.rel_normalize == b.cfg.rel_normalize
        assert a.stage_spec() == b.stage_spec()
        assert a.dasr_order() == b.dasr_order()
    cfg = t_engn.EnGNConfig(DIM, HID)
    t_models.RGCNLayer(cfg, RELS, device="cpu")
    t_models.GatedGCNLayer(cfg, device="cpu")
    assert (cfg.stage_contract, cfg.num_relations, cfg.rel_normalize,
            cfg.stage_order) == (None, 1, False, "auto")


# -- gradients against jax.grad ----------------------------------------------

@pytest.mark.parametrize("route", ROUTES[:3], ids=ROUTE_IDS[:3])
@pytest.mark.parametrize("model", MODELS)
def test_one_step_gradients_match_jax_grad(model, route):
    """d(sum(y * c))/d(every parameter and x) on a real-valued typed
    graph, the port's autograd (B1's autograd Function per relation on
    dense tiles, the flat gathers on packed) against `jax.grad`."""
    backend, fmt = route
    g, tg, x = _real_typed_graph()
    jl, params, tl = _pair(model, backend, fmt, key=3)
    cot = np.random.default_rng(9).standard_normal(
        (g.num_vertices, HID)).astype(np.float32)
    jplan = j_engn.prepare_graph(g, jl.cfg)

    def loss(p, xv):
        return jnp.sum(jl.apply(p, jplan, xv) * cot)
    jgp, jgx = jax.grad(loss, argnums=(0, 1))(params, jnp.asarray(x))
    plan = rt.prepare_graph(tg, tl.cfg, device="cpu")
    xt = torch.from_numpy(x).requires_grad_(True)
    (tl(plan, xt) * torch.from_numpy(cot)).sum().backward()
    for k, p in tl.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), np.asarray(jgp[k]),
                                   rtol=GRAD_RTOL, atol=GRAD_ATOL,
                                   err_msg=k)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(jgx),
                               rtol=GRAD_RTOL, atol=GRAD_ATOL)


# -- the streamed executor ---------------------------------------------------

@pytest.mark.parametrize("order", ["column", "row"])
@pytest.mark.parametrize("fmt", ["dense", "packed"])
@pytest.mark.parametrize("kind", ["uneven", "collision"])
def test_typed_stream_equals_reference_executor(kind, fmt, order):
    """`aggregate(rel_channels=H)` over an integer (N, R*H) payload:
    output and every `TiledStats` counter exactly the reference's, in
    both sweep orders."""
    g, tg, _ = _typed_graph(kind)
    pay = np.random.default_rng(2).integers(
        -3, 4, (g.num_vertices, RELS * HID)).astype(np.float32)
    kw = dict(tile=TILE, chunk=3, tile_format=fmt)
    je = j_tiled.TiledExecutor(g, **kw)
    te = t_tiled.TiledExecutor(tg, device="cpu", **kw)
    want = je.aggregate(pay, "sum", order=order, rel_channels=HID)
    got = te.aggregate(torch.from_numpy(pay), "sum", order=order,
                       rel_channels=HID)
    np.testing.assert_array_equal(got.numpy(), want)
    assert dataclasses.asdict(te.stats) == dataclasses.asdict(je.stats)
    with pytest.raises(ValueError):
        te.aggregate(pay[:, :HID], "sum", rel_channels=HID)


@pytest.mark.parametrize("fmt", ["dense", "packed"])
@pytest.mark.parametrize("kind", ["uneven", "collision"])
def test_gated_stream_equals_reference_executor(kind, fmt):
    """`gated_aggregate(ph, pc, x)`: output allclose (sigmoids) and every
    `TiledStats` counter exactly the reference's."""
    g, tg, x = _typed_graph(kind)
    rng = np.random.default_rng(6)
    ph, pc = (rng.standard_normal(x.shape).astype(np.float32)
              for _ in range(2))
    kw = dict(tile=TILE, chunk=3, tile_format=fmt)
    je = j_tiled.TiledExecutor(g, **kw)
    te = t_tiled.TiledExecutor(tg, device="cpu", **kw)
    want = je.gated_aggregate(ph, pc, x)
    got = te.gated_aggregate(torch.from_numpy(ph), pc, x)
    assert got.dtype == torch.float32 and got.device.type == "cpu"
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)
    assert dataclasses.asdict(te.stats) == dataclasses.asdict(je.stats)


@pytest.mark.parametrize("budget", [20_000, 12_000])
@pytest.mark.parametrize("model", MODELS)
def test_staged_budget_spill_streams_like_the_reference(model, budget):
    """A budget that spills a staged blocked plan to "tiled": the
    streamed plan (its fitted tile and chunk, sized by the staged dim
    hint) and the layer's output are the reference's."""
    g, tg, x = _typed_graph("uneven")
    jl, params, tl = _pair(model, "blocked", "auto",
                           device_budget_bytes=budget)
    jplan = j_engn.prepare_graph(g, jl.cfg)
    plan = rt.prepare_graph(tg, tl.cfg, device="cpu")
    assert plan.backend == jplan.backend == "tiled"
    for k in ("q", "tile", "chunk", "tile_format", "streaming_mode",
              "queue_plan"):
        assert plan.meta[k] == jplan.meta[k], k
    want = np.asarray(jl.apply(params, jplan, jnp.asarray(x)))
    np.testing.assert_allclose(_forward(tl, plan, x).numpy(), want,
                               rtol=RTOL, atol=ATOL)


# -- the gated dense size check ----------------------------------------------

def test_gated_dense_check_prices_and_refuses():
    """The formulation's bytes (four (nnzb, T, T, F) float32 tensors) and
    the refusal, over the budget or the free memory, naming B6."""
    assert t_engn.gated_dense_bytes(4627, 256, 500) == \
        4 * 4 * 4627 * 256 * 256 * 500
    t_engn.check_gated_dense(100, None, None)
    t_engn.check_gated_dense(100, 100, 100)
    for budget, free in ((99, None), (None, 99), (99, 99)):
        with pytest.raises(t_tiled.DeviceBudgetExceeded, match="ROADMAP B6"):
            t_engn.check_gated_dense(100, budget, free)


def test_gated_dense_cpu_plan_is_not_priced():
    """CPU plans run the formulation as the reference does: the check is
    the card's (its budget and free memory)."""
    g, tg, x = _typed_graph("even")
    jl, params, tl = _pair("gated_gcn", "blocked", "dense")
    nnzb = rt.prepare_graph(tg, tl.cfg, device="cpu").carrier[
        "blocks"].shape[0]
    tl.cfg.device_budget_bytes = t_engn.gated_dense_bytes(nnzb, TILE, DIM) - 1
    jl.cfg.device_budget_bytes = tl.cfg.device_budget_bytes
    plan = rt.prepare_graph(tg, tl.cfg, device="cpu")
    assert (plan.backend, plan.tile_format) == ("blocked", "dense")
    want = np.asarray(jl.apply(params, j_engn.prepare_graph(g, jl.cfg),
                               jnp.asarray(x)))
    np.testing.assert_allclose(_forward(tl, plan, x).numpy(), want,
                               rtol=RTOL, atol=ATOL)


# -- on the card ---------------------------------------------------------------

def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _typed_card_graph(n=3000, e=20000, seed=5):
    g = rmat_graph(n, e, seed=seed)
    rng = np.random.default_rng(seed)
    rel = ((g.src.astype(np.int64) + g.dst) % RELS).astype(np.int32)
    val = rng.uniform(0.1, 1.0, g.num_edges).astype(np.float32)
    x = rng.standard_normal((n, 40)).astype(np.float32)
    return TCOO(n, g.src, g.dst, val, rel, RELS), x


@pytest.mark.cuda
@pytest.mark.parametrize("h", [5, 16, 64])
def test_b1_per_relation_on_card(h):
    """Each relation's B1 launch against its plain version on the card,
    one launch per relation a forward and one B1^T per relation a
    backward, and the layer against "segment" (forward and gradients)."""
    dev = _card()
    from repro_torch import kernels as K
    g, x = _typed_card_graph()
    layers = {}
    for backend in ("segment", "blocked"):
        layer = rt.make_gnn("rgcn", x.shape[1], h, backend=backend,
                            num_relations=RELS, device=dev)
        layer.cfg.tile_format = "dense"
        layers[backend] = layer
    layers["blocked"].load_state_dict(layers["segment"].state_dict())
    plan = rt.prepare_graph(g, layers["blocked"].cfg, device=dev)
    c = plan.carrier
    pad = c["blocks_meta"]["padded"]
    xr = torch.randn(pad, h, device=dev)
    for blk in c["typed_blocks"]:
        args = (blk["blocks"], blk["block_row"], blk["block_col"], xr)
        got = t_spmm.blocked_spmm(*args, q=blk["q"], op="sum")
        want = t_spmm.blocked_spmm_plain(*args, q=blk["q"], op="sum")
        torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-5)
    seg_plan = rt.prepare_graph(g, layers["segment"].cfg, device=dev)
    xd = torch.from_numpy(x).to(dev)
    outs, grads = {}, {}
    for name, pl in (("segment", seg_plan), ("blocked", plan)):
        layer = layers[name]
        layer.zero_grad()
        K.reset_launch_counts()
        y = layer(pl, xd)
        launched = K.launch_counts()["rer_spmm_sum"]
        y.square().sum().backward()
        outs[name] = y.detach()
        grads[name] = [p.grad.clone() for p in layer.parameters()]
        if name == "blocked":
            assert launched == len(c["typed_blocks"]) == RELS
            assert K.launch_counts()["rer_spmm_sum_t"] == RELS
    torch.testing.assert_close(outs["blocked"], outs["segment"], rtol=1e-4,
                               atol=1e-5)
    for a, b in zip(grads["blocked"], grads["segment"]):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-4)


@pytest.mark.cuda
def test_gated_dense_small_plan_on_card_matches_segment():
    """A gated dense plan that fits runs the formulation on the card and
    equals "segment" there."""
    dev = _card()
    g, x = _typed_card_graph(n=600, e=4000)
    g = TCOO(g.num_vertices, g.src, g.dst, g.val)
    x = x[:, :8]
    outs = {}
    state = None
    for backend in ("segment", "blocked"):
        layer = rt.make_gnn("gated_gcn", 8, 4, backend=backend, tile=64,
                            device=dev)
        layer.cfg.tile_format = "dense"
        if state is None:
            state = layer.state_dict()
        layer.load_state_dict(state)
        plan = rt.prepare_graph(g, layer.cfg, device=dev)
        with torch.no_grad():
            outs[backend] = layer(plan, torch.from_numpy(x).to(dev))
    torch.testing.assert_close(outs["blocked"], outs["segment"], rtol=1e-4,
                               atol=1e-5)


@pytest.mark.cuda
def test_gated_dense_refused_at_pubmed_before_allocating():
    """Uncut pubmed [500 -> 64] on dense tiles: the formulation needs
    about 2.4 TB; the plan is refused before anything is allocated, and
    "auto" (packed there) runs."""
    dev = _card()
    from repro_torch.graphs.generate import make_dataset
    g, f, _ = make_dataset("pubmed")
    g = g.gcn_normalized()
    layer = rt.make_gnn("gated_gcn", f, 64, backend="blocked", device=dev)
    layer.cfg.tile_format = "dense"
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated(dev)
    with pytest.raises(t_tiled.DeviceBudgetExceeded, match="ROADMAP B6"):
        rt.prepare_graph(g, layer.cfg, device=dev)
    assert torch.cuda.memory_allocated(dev) == before
    layer.cfg.tile_format = "auto"
    plan = rt.prepare_graph(g, layer.cfg, device=dev)
    assert plan.tile_format == "packed" and "packed_groups" in plan.carrier
