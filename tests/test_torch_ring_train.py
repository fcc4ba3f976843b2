"""Training on the port's sharded ring against the reference, on the CPU.

- One step's gradients (dX and every dW) of GCN, GS-Pool, R-GCN and
  Gated-GCN on dense and packed ring stripes against `jax.grad` through
  the reference's shard_map ring (rtol=1e-4, atol=1e-5), P =
  min(len(jax.devices()), 4) under conftest's 8-device view.
- The ring max's tie convention against `jax.grad` on inputs that tie
  within a tile, across a stripe's tiles and across ring steps.
- `build_gnn(backend="ring")` trajectories from the reference's weights
  (`interop.load_reference_params`) against the reference's (rtol=1e-3,
  atol=1e-4, its launcher test's tolerance); a ring training plan holds
  the same bytes after its steps.
- `ElasticGNNTrainer`: the four non-chaos cases of
  `tests/test_elastic_ring.py` (degrade to tiled under a budget,
  straggler strikes, non-shard-loss failures, the floor of one shard)
  and shard loss off the ring, routes and counters equal to the
  reference trainer's; the launcher's `--gnn-backend ring --gnn-shards`.
The `cuda`-marked twins run on a card only and skip here.
"""
import _torch_cpu  # noqa: F401  (this worker's share of the cores)
import argparse

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import engn as j_engn
from repro.core import models as j_models
from repro.distributed.chaos import ShardLossError as JShardLoss
from repro.graphs import format as j_format
from repro.graphs.generate import rmat_graph
from repro.launch.train import build_gnn as j_build_gnn
import repro_torch as rt
from repro_torch.core.models import stack_params
from repro_torch.distributed.chaos import InjectedFault, ShardLossError
from repro_torch.graphs.format import COOGraph
from repro_torch.interop import load_reference_params
from repro_torch.launch import train as t_train

RTOL, ATOL = 1e-4, 1e-5
RELS = 3
DIMS = {"gcn": [6, 8, 4], "gs_pool": [6, 8, 4], "rgcn": [6, 5, 4],
        "gated_gcn": [6, 6]}


def _p():
    return min(len(jax.devices()), 4)


def _graph(model, n=90, seed=23):
    """A float-weighted graph, relation-typed for R-GCN, multi-edges
    merged (the stripes merge them before a max sees them)."""
    g = rmat_graph(n, 700, seed=seed)
    u = np.unique(np.stack([g.src, g.dst]), axis=1)
    src, dst = u[0].astype(np.int32), u[1].astype(np.int32)
    val = np.random.default_rng(seed + 31).uniform(
        0.5, 1.5, src.size).astype(np.float32)
    rel, rels = None, 1
    if model == "rgcn":
        rel = ((src.astype(np.int64) + dst) % RELS).astype(np.int32)
        rels = RELS
    return j_format.COOGraph(n, src, dst, val, rel, rels)


def _port(g):
    return COOGraph(g.num_vertices, g.src, g.dst, g.val, g.rel,
                    g.num_relations)


def _stacks(model, fmt, p, tile=8):
    rels = RELS if model == "rgcn" else 1
    jl = j_models.make_gnn_stack(model, DIMS[model], backend="ring",
                                 tile=tile, num_relations=rels)
    tl = rt.make_gnn_stack(model, DIMS[model], backend="ring", tile=tile,
                           num_relations=rels, device="cpu")
    for a, b in zip(jl, tl):
        for cfg in (a.cfg, b.cfg):
            cfg.tile_format = fmt
            cfg.ring_shards = p
            cfg.training = True
    jp = j_models.init_stack(jl, jax.random.key(9))
    load_reference_params(tl, [{k: np.asarray(v) for k, v in q.items()}
                               for q in jp])
    return jl, jp, tl


def _grads(tl, plan, x, cot):
    ps = [{k: v.clone().requires_grad_(True) for k, v in q.items()}
          for q in stack_params(tl)]
    xt = torch.as_tensor(x).clone().requires_grad_(True)
    out = rt.apply_stack(tl, plan, xt, params=ps)
    (out * torch.as_tensor(cot)).sum().backward()
    return xt.grad, ps


@pytest.mark.parametrize("fmt", ["dense", "packed"])
@pytest.mark.parametrize("model", sorted(DIMS))
def test_ring_gradients_match_jax_grad(model, fmt):
    g = _graph(model)
    p = _p()
    jl, jp, tl = _stacks(model, fmt, p)
    rng = np.random.default_rng(7)
    x = rng.uniform(-1, 1, (g.num_vertices, DIMS[model][0])).astype(
        np.float32)
    cot = rng.standard_normal((g.num_vertices, DIMS[model][-1])).astype(
        np.float32)
    jplan = j_engn.prepare_graph(g, jl[0].cfg)

    def j_loss(ps, xx):
        return jnp.sum(j_models.apply_stack(jl, ps, jplan, xx) * cot)
    jgp, jgx = jax.grad(j_loss, argnums=(0, 1))(jp, jnp.asarray(x))

    plan = rt.prepare_graph(_port(g), tl[0].cfg, device="cpu")
    assert (plan.backend, plan.tile_format) == ("ring", fmt)
    held = plan.held_bytes()
    gx, ps = _grads(tl, plan, torch.from_numpy(x), torch.from_numpy(cot))
    np.testing.assert_allclose(gx.numpy(), np.asarray(jgx), rtol=RTOL,
                               atol=ATOL, err_msg="x")
    for i, (jd, td) in enumerate(zip(jgp, ps)):
        assert set(jd) == set(td)
        for k in jd:
            np.testing.assert_allclose(td[k].grad.numpy(), np.asarray(jd[k]),
                                       rtol=RTOL, atol=ATOL,
                                       err_msg=f"layer {i} {k}")
    assert plan.held_bytes() == held


def _tie_graph():
    """Destination 0 has five in-edges of weight 1, all tying at x = 1:
    from 0 and 1 (one tile), from 2 (another tile of the same stripe)
    and from 4 and 6 (other shards: other ring steps).  Destination 5
    has two tying in-edges from one shard."""
    src = np.array([0, 1, 2, 4, 6, 4, 5], np.int32)
    dst = np.array([0, 0, 0, 0, 0, 5, 5], np.int32)
    return j_format.COOGraph(8, src, dst, np.ones(7, np.float32))


@pytest.mark.parametrize("fmt", ["dense", "packed"])
@pytest.mark.parametrize("shards", [1, 4])
def test_ring_max_tie_convention_is_the_reference(shards, fmt):
    """Ties split evenly within a tile and over a stripe's tiles (dense)
    or a stripe's entries (packed), then in halves at each ring step's
    maximum with the accumulator: the reference's, held against
    `jax.grad`."""
    g = _tie_graph()
    cfg_kw = dict(in_dim=1, out_dim=1, aggregate_op="max", backend="ring",
                  tile=2, tile_format=fmt, ring_shards=shards)
    x = np.ones((8, 1), np.float32)
    gy = np.zeros((8, 1), np.float32)
    gy[0] = 1.0
    gy[5] = 2.0
    jcfg = j_engn.EnGNConfig(**cfg_kw)
    jplan = j_engn.prepare_graph(g, jcfg)
    jlayer = j_engn.EnGNLayer(jcfg)
    want = jax.grad(lambda xx: jnp.sum(
        jlayer._aggregate(jplan, xx) * gy))(jnp.asarray(x))
    cfg = rt.EnGNConfig(**cfg_kw)
    plan = rt.prepare_graph(_port(g), cfg, device="cpu")
    xt = torch.from_numpy(x).requires_grad_(True)
    (rt.EnGNLayer(cfg, device="cpu")._aggregate(plan, xt)
     * torch.from_numpy(gy)).sum().backward()
    np.testing.assert_array_equal(xt.grad.numpy(), np.asarray(want))
    # the cotangent is split, not lost: dst 0's 1 and dst 5's 2
    np.testing.assert_allclose(float(xt.grad.sum()), 3.0, rtol=1e-6)


# -- build_gnn on the ring ------------------------------------------------------

def _gnn_kw(steps, model="gcn"):
    return dict(model=model, dataset="pubmed", steps=steps, hidden=8,
                batch=64, max_vertices=300, max_edges=2000)


def _reference_weights(state, aux):
    f, classes = aux["x"].shape[1], aux["num_classes"]
    teacher = j_models.init_stack(
        j_models.make_gnn_stack("gcn", [f, 16, classes]), jax.random.key(42))
    return {"student": [{k: np.asarray(v) for k, v in q.items()}
                        for q in state["params"]],
            "teacher": [{k: np.asarray(v) for k, v in q.items()}
                        for q in teacher]}


def _losses(step, state, data, steps):
    ps, opt, out = state["params"], state["opt"], []
    for _ in range(steps):
        ps, opt, m = step(ps, opt, next(data))
        out.append(float(m["loss"]))
    return out


@pytest.mark.parametrize("model", ["gcn", "gs_pool"])
def test_ring_trajectory_matches_reference_from_its_init(model):
    steps, p = 6, _p()
    kw = _gnn_kw(steps, model)
    step, state, data, gd, aux = j_build_gnn(backend="ring", ring_shards=p,
                                             **kw)
    refs = _reference_weights(state, aux)
    want = _losses(step, state, data, steps)
    tstep, tstate, tdata, tgd, taux = t_train.build_gnn(
        backend="ring", ring_shards=p, device="cpu", reference_params=refs,
        **kw)
    assert (tgd.backend, tgd.tile_format) == (gd.backend, gd.tile_format)
    assert tgd.meta["shards"] == gd.meta["shards"] == p
    assert tgd.footprint_bytes == gd.footprint_bytes
    held = tgd.held_bytes()
    got = _losses(tstep, tstate, tdata, steps)
    np.testing.assert_allclose(got, want, rtol=1e-3, atol=1e-4)
    assert got[-1] < got[0]
    # the backward wrote nothing into the plan: the same bytes after
    assert tgd.held_bytes() == held


def test_dense_ring_training_plan_holds_its_bytes():
    step, state, data, _, aux = t_train.build_gnn(
        backend="ring", ring_shards=3, device="cpu", **_gnn_kw(4))
    tr = aux["trainer"]
    for layer in tr.layers:
        layer.cfg.tile_format = "dense"
    plan = tr.rebuild()
    assert plan.tile_format == "dense"
    held = plan.held_bytes()
    losses = _losses(step, state, data, 4)
    assert all(np.isfinite(losses))
    assert plan.held_bytes() == held


# -- the elastic trainer ----------------------------------------------------------

def _pair(shards, steps=3, **kw):
    """The reference's trainer and the port's, on one configuration."""
    _, _, _, _, jaux = j_build_gnn(backend="ring", ring_shards=shards,
                                   **{**_gnn_kw(steps), **kw})
    out = t_train.build_gnn(backend="ring", ring_shards=shards, device="cpu",
                            **{**_gnn_kw(steps), **kw})
    return jaux["trainer"], out


def _same_counters(tr, jtr):
    keys = ("remesh_count", "strikes", "degraded", "shards")
    assert {k: tr.stats[k] for k in keys} == {k: jtr.stats[k] for k in keys}
    assert set(tr.stats) == set(jtr.stats)
    assert (tr.backend, tr.shards) == (jtr.backend, jtr.shards)
    assert tr.plan.backend == jtr.plan.backend


def test_shard_loss_degrades_to_tiled_under_budget():
    steps = 3
    jtr, (step, state, data, gd, aux) = _pair(4, steps)
    tr = aux["trainer"]
    assert gd.backend == "ring" and gd.meta["shards"] == 4
    for trainer in (jtr, tr):
        for layer in trainer.layers:
            layer.cfg.device_budget_bytes = 50_000
    jtr.on_failure(JShardLoss(lost_shards=3))
    tr.on_failure(ShardLossError(lost_shards=3))
    _same_counters(tr, jtr)
    assert tr.stats["remesh_count"] == 1 and tr.stats["degraded"] == 1
    assert tr.plan.backend == "tiled" and tr.plan.meta["trainable"] is True
    assert tr.stats["remesh_s"] > 0
    seg = t_train.build_gnn(backend="segment", device="cpu",
                            **_gnn_kw(steps))
    want = _losses(seg[0], seg[1], seg[2], steps)
    got = _losses(step, state, data, steps)
    np.testing.assert_allclose(got, want, rtol=1e-3, atol=1e-4)


def test_straggler_strikes_shrink_ring():
    jtr, (_, _, _, gd, aux) = _pair(4, strike_limit=2)
    tr = aux["trainer"]
    assert gd.meta["shards"] == 4
    for dt in (1, 2):
        jtr.on_straggler(dt, 99.0)
        tr.on_straggler(dt, 99.0)
        _same_counters(tr, jtr)
    assert tr.stats["remesh_count"] == 1 and tr.stats["strikes"] == 0
    assert tr.plan.meta["shards"] == 3


def test_non_shard_loss_failures_do_not_remesh():
    jtr, (_, _, _, _, aux) = _pair(2)
    tr = aux["trainer"]
    plan = tr.plan
    for exc in (RuntimeError("transient blip"), InjectedFault("blip")):
        tr.on_failure(exc)
    jtr.on_failure(RuntimeError("transient blip"))
    _same_counters(tr, jtr)
    assert tr.plan is plan and tr.plan.meta["shards"] == 2


def test_remesh_floor_is_one_shard():
    jtr, (_, _, _, _, aux) = _pair(2)
    tr = aux["trainer"]
    jtr.on_failure(JShardLoss(lost_shards=5))
    tr.on_failure(ShardLossError(lost_shards=5))
    _same_counters(tr, jtr)
    assert tr.plan.meta["shards"] == 1
    assert tr.remesh(0).meta["shards"] == jtr.remesh(0).meta["shards"] == 1
    _same_counters(tr, jtr)


def test_shard_loss_on_non_ring_backend_is_ignored():
    _, _, _, _, aux = t_train.build_gnn(backend="segment", device="cpu",
                                        **_gnn_kw(3))
    tr = aux["trainer"]
    tr.on_failure(ShardLossError(lost_shards=1))
    assert tr.stats["remesh_count"] == 0 and tr.plan.backend == "segment"
    assert tr.shards is None and tr.stats["shards"] is None


def test_remesh_keeps_the_trajectory():
    """A run that loses a shard after two steps goes on along the
    unbroken run's losses (the rotation changes the sums' order only)."""
    steps = 4
    step, state, data, _, aux = t_train.build_gnn(
        backend="ring", ring_shards=4, device="cpu", **_gnn_kw(steps))
    seg = t_train.build_gnn(backend="segment", device="cpu",
                            **_gnn_kw(steps))
    want = _losses(seg[0], seg[1], seg[2], steps)
    ps, opt, got = state["params"], state["opt"], []
    for i in range(steps):
        if i == 2:
            aux["trainer"].on_failure(ShardLossError(lost_shards=1))
            assert aux["trainer"].shards == 3
        ps, opt, m = step(ps, opt, next(data))
        got.append(float(m["loss"]))
    np.testing.assert_allclose(got, want, rtol=1e-3, atol=1e-4)


def _args(tmp_path, **kw):
    base = dict(gnn="gcn", gnn_backend="ring", gnn_shards=3, gnn_hidden=8,
                dataset="cora", device_budget=0, steps=2, batch=32,
                ckpt_dir=str(tmp_path), ckpt_every=2, chaos_seed=None,
                device="cpu", straggler_strikes=3)
    return argparse.Namespace(**{**base, **kw})


def test_launcher_trains_the_ring_and_resumes(tmp_path, capsys):
    out = t_train.main(["--gnn", "gcn", "--gnn-backend", "ring",
                        "--gnn-shards", "3", "--dataset", "cora",
                        "--steps", "2", "--batch", "16", "--gnn-hidden", "8",
                        "--device", "cpu", "--ckpt-dir", str(tmp_path),
                        "--ckpt-every", "2"])
    assert out["steps"] == 2 and all(np.isfinite(out["losses"]))
    assert "backend=ring" in capsys.readouterr().out
    again = t_train.run_gnn(_args(tmp_path, steps=4))
    assert (again["start"], again["steps"]) == (2, 4)
    assert len(again["losses"]) == 2


# -- on the card ---------------------------------------------------------------------

def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("fmt", ["dense", "packed"])
@pytest.mark.parametrize("model", sorted(DIMS))
def test_card_ring_gradients_match_cpu(model, fmt):
    dev = _card()
    g = _port(_graph(model))
    rng = np.random.default_rng(7)
    x = rng.uniform(-1, 1, (g.num_vertices, DIMS[model][0])).astype(
        np.float32)
    cot = rng.standard_normal((g.num_vertices, DIMS[model][-1])).astype(
        np.float32)
    grads = []
    for d in ("cpu", dev):
        _, _, tl = _stacks(model, fmt, _p())
        tl = [layer.to(d) for layer in tl]
        plan = rt.prepare_graph(g, tl[0].cfg, device=d)
        held = plan.held_bytes()
        gx, ps = _grads(tl, plan, torch.from_numpy(x).to(d),
                        torch.from_numpy(cot).to(d))
        assert plan.held_bytes() == held
        grads.append([gx.cpu()] + [q[k].grad.cpu() for q in ps
                                   for k in sorted(q)])
    for a, b in zip(*grads):
        torch.testing.assert_close(b, a, rtol=RTOL, atol=ATOL)


@pytest.mark.cuda
def test_card_remesh_and_degrade():
    dev = _card()
    steps = 3
    step, state, data, gd, aux = t_train.build_gnn(
        backend="ring", ring_shards=4, device=dev, **_gnn_kw(steps))
    tr = aux["trainer"]
    assert gd.carrier["ring_operands"][0][0][0].device.type == dev.type
    tr.on_failure(ShardLossError(lost_shards=1))
    assert tr.shards == 3 and tr.stats["remesh_count"] == 1
    for layer in tr.layers:
        layer.cfg.device_budget_bytes = 50_000
    tr.on_failure(ShardLossError(lost_shards=1))
    assert tr.plan.backend == "tiled" and tr.stats["degraded"] == 1
    seg = t_train.build_gnn(backend="segment", device=dev, **_gnn_kw(steps))
    want = _losses(seg[0], seg[1], seg[2], steps)
    np.testing.assert_allclose(_losses(step, state, data, steps), want,
                               rtol=1e-3, atol=1e-4)
