"""Gated-GCN's aggregate over bucket groups (`kernels/rer_gather_gated`)
on the CPU, where it runs its plain version: the autograd Function
against the segment route's formula and the layer over a groups-form
plan against the reference's `GatedGCNLayer`, outputs and the gradients
of x, w_h, w_c and w, on a multigraph (repeated pairs merged into one
weighted entry) and a weighted graph, each with vertices that receive
nothing and send nothing.

Tolerances: the port's fp32 `allclose` of the reference matrix
(rtol = atol = 1e-4 for outputs; rtol 1e-4, atol 1e-5 for gradients),
since the merged entries and the groups sum in another order than the
edge-wise reference; the Function against the port's own segment
formula at rtol 1e-5, both fp32 sums of the same products."""
import _torch_cpu  # noqa: F401  (this worker's share of the cores)

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import engn as j_engn
from repro.core import models as j_models
from repro.graphs.format import COOGraph as JCOO
import repro_torch as rt
from repro_torch import tracing
from repro_torch.core import engn as t_engn
from repro_torch.core import models as t_models
from repro_torch.core.engn import segment_aggregate, upload_groups
from repro_torch.graphs.format import COOGraph as TCOO
from repro_torch.graphs.partition import build_tile_store, pack_tile_store
from repro_torch.interop import load_reference_params
from repro_torch.kernels.rer_gather import prepare_packed_groups
from repro_torch.kernels.rer_gather_gated import (gated_backward,
                                                  gated_forward,
                                                  gated_groups_aggregate)

TILE, F, H = 16, 6, 5
RTOL, ATOL = 1e-4, 1e-4
GRAD_RTOL, GRAD_ATOL = 1e-4, 1e-5
KINDS = ["multigraph", "weighted"]
EMPTY_DST, EMPTY_SRC = (5, 41), (7, 42)   # receive nothing, send nothing


def _graph(kind, n=75, e=700, seed=3):
    """A graph over n vertices; "multigraph": unweighted, a quarter of the
    pairs drawn again; "weighted": weights in [0.1, 1)."""
    rng = np.random.default_rng(seed)
    src = rng.integers(0, n, e)
    dst = rng.integers(0, n, e)
    keep = ~np.isin(dst, EMPTY_DST) & ~np.isin(src, EMPTY_SRC)
    src, dst = src[keep].astype(np.int32), dst[keep].astype(np.int32)
    val = None
    if kind == "multigraph":
        k = src.size // 4
        src, dst = np.concatenate([src, src[:k]]), np.concatenate([dst,
                                                                   dst[:k]])
        assert np.unique(dst.astype(np.int64) * n + src).size < src.size
    else:
        val = rng.uniform(0.1, 1.0, src.size).astype(np.float32)
    x = rng.standard_normal((n, F)).astype(np.float32)
    return JCOO(n, src, dst, val), TCOO(n, src, dst, val), x


def _groups(tg):
    """The card's carrier of `tg`, built on CPU tensors: bucket groups
    with the work and source tables."""
    return upload_groups(prepare_packed_groups(pack_tile_store(
        build_tile_store(tg, TILE))), "cpu", source=True)


def _padded(n, *arrays):
    q = -(-n // TILE)
    out = []
    for a in arrays:
        p = torch.zeros((q * TILE, a.shape[1]))
        p[:n] = a
        out.append(p.requires_grad_(True))
    return q, out


@pytest.mark.parametrize("kind", KINDS)
def test_function_matches_the_segment_formula(kind):
    """y and the gradients of ph, pc and x: the Function over the groups
    against autograd through the segment route's per-edge formula over
    the raw edges."""
    _, tg, x = _graph(kind)
    n = tg.num_vertices
    rng = np.random.default_rng(8)
    ph0, pc0 = (torch.from_numpy(rng.standard_normal((n, F))
                                 .astype(np.float32)) for _ in range(2))
    q, (ph, pc, xp) = _padded(n, ph0, pc0, torch.from_numpy(x))
    cot = torch.from_numpy(rng.standard_normal((q * TILE, F))
                           .astype(np.float32))
    y = gated_groups_aggregate(_groups(tg), ph, pc, xp, q=q)
    (y * cot).sum().backward()

    src, dst = torch.from_numpy(tg.src).long(), torch.from_numpy(tg.dst).long()
    val = torch.from_numpy(tg.weights())
    leaves = [a.detach().clone().requires_grad_(True) for a in (ph, pc, xp)]
    rph, rpc, rx = leaves
    msg = val[:, None] * torch.sigmoid(rph[dst] + rpc[src]) * rx[src]
    want = segment_aggregate(msg, dst, q * TILE, "sum")
    (want * cot).sum().backward()
    torch.testing.assert_close(y.detach(), want.detach(), rtol=1e-5,
                               atol=1e-5)
    for got, ref in zip((ph, pc, xp), leaves):
        torch.testing.assert_close(got.grad, ref.grad, rtol=1e-5, atol=1e-5)
    # the rows that receive nothing get 0; those that send nothing get no
    # dx and no dpc
    assert not y[list(EMPTY_DST)].any()
    assert not xp.grad[list(EMPTY_SRC)].any()
    assert not pc.grad[list(EMPTY_SRC)].any()


def test_backward_skips_dx_and_dph_where_not_asked():
    _, tg, x = _graph("weighted")
    n = tg.num_vertices
    q, (ph, pc, xp) = _padded(n, *(torch.randn(n, F) for _ in range(2)),
                              torch.from_numpy(x))
    groups, g = _groups(tg), torch.randn(q * TILE, F)
    full = gated_backward(groups, ph.detach(), pc.detach(), xp.detach(), g,
                          q=q)
    part = gated_backward(groups, ph.detach(), pc.detach(), xp.detach(), g,
                          q=q, need_dx=False, need_dph=False)
    assert part[0] is None and part[2] is None
    torch.testing.assert_close(part[1], full[1], rtol=0, atol=0)
    # through autograd: x without a gradient (a first layer's features)
    y = gated_groups_aggregate(groups, ph, pc, xp.detach(), q=q)
    y.sum().backward()
    assert ph.grad is not None and pc.grad is not None
    with torch.no_grad():
        assert gated_groups_aggregate(groups, ph, pc, xp, q=q).grad_fn is None


def test_gate_evals_counted_only_while_a_profiler_records():
    _, tg, x = _graph("multigraph")
    n = tg.num_vertices
    q, (ph, pc, xp) = _padded(n, *(torch.randn(n, F) for _ in range(2)),
                              torch.from_numpy(x))
    groups = _groups(tg)
    entries = int(np.unique(tg.dst.astype(np.int64) * n + tg.src).size)
    tracing.reset()
    gated_forward(groups, ph.detach(), pc.detach(), xp.detach(), q=q)
    assert "gated.gate_evals" not in tracing.report()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        gated_groups_aggregate(groups, ph, pc, xp, q=q).sum().backward()
    rep = tracing.report()
    tracing.reset()
    # a forward, the source walk and the destination walk
    assert rep["gated.gate_evals"]["calls"] == 3 * entries * F
    assert rep["engn.aggregate_bwd"]["calls"] == 1


def _pair(kind, key=11):
    """(reference layer, its params, the port's packed blocked layer with
    those weights, the port's plan with its flat entries replaced by the
    groups, the reference's segment plan, features)."""
    g, tg, x = _graph(kind)
    cfg = dict(in_dim=F, out_dim=H, backend="blocked", tile=TILE,
               tile_format="packed")
    jl = j_models.GatedGCNLayer(j_engn.EnGNConfig(**{**cfg,
                                                     "backend": "segment"}))
    tl = t_models.GatedGCNLayer(t_engn.EnGNConfig(**cfg), device="cpu")
    params = jl.init(jax.random.key(key))
    load_reference_params([tl], [{k: np.asarray(v)
                                  for k, v in params.items()}])
    plan = rt.prepare_graph(tg, tl.cfg, device="cpu")
    carrier = dict(plan.carrier)
    assert "packed_flat" in carrier and "packed_groups" not in carrier
    carrier.pop("packed_flat")
    carrier["packed_groups"] = _groups(tg)
    return jl, params, tl, carrier, j_engn.prepare_graph(g, jl.cfg), x


@pytest.mark.parametrize("kind", KINDS)
def test_layer_over_groups_matches_the_reference_layer(kind):
    """The port's Gated-GCN layer on a groups-form plan against the
    reference's on "segment": the output, and the gradients of x, w_h,
    w_c and w of sum(y * c) against `jax.grad`."""
    jl, params, tl, carrier, jplan, x = _pair(kind)
    cot = np.random.default_rng(9).standard_normal(
        (x.shape[0], H)).astype(np.float32)

    def loss(p, xv):
        return jnp.sum(jl.apply(p, jplan, xv) * cot)
    want = np.asarray(jl.apply(params, jplan, jnp.asarray(x)))
    jgp, jgx = jax.grad(loss, argnums=(0, 1))(params, jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_(True)
    y = tl(carrier, xt)
    np.testing.assert_allclose(y.detach().numpy(), want, rtol=RTOL,
                               atol=ATOL)
    (y * torch.from_numpy(cot)).sum().backward()
    assert {k for k, _ in tl.named_parameters()} == {"w_h", "w_c", "w"}
    for k, p in tl.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), np.asarray(jgp[k]),
                                   rtol=GRAD_RTOL, atol=GRAD_ATOL,
                                   err_msg=k)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(jgx),
                               rtol=GRAD_RTOL, atol=GRAD_ATOL)


def test_layer_spans_on_the_groups_route():
    """The gated blocked route's spans: the gate projections, the
    aggregate, the update, and the aggregate's backward."""
    _, _, tl, carrier, _, x = _pair("multigraph")
    tracing.reset()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        tl(carrier, torch.from_numpy(x)).sum().backward()
    rep = tracing.report()
    tracing.reset()
    for name in ("engn.extract", "engn.aggregate", "engn.update",
                 "engn.aggregate_bwd"):
        assert rep[name]["calls"] == 1, name
