"""Gated-GCN's kernels on the card (`csrc/rer_gather_gated.cu`): the
forward, the source walk (dx, dpc) and the destination walk (dph), each
against its plain version over the same bucket groups, at widths 1, 3,
41, 128 and 602, with source pieces that split the intervals (merged
rows) and that hold them whole (stored rows); and a gated layer on the
card's packed plan against "segment", forward and gradients.  Every test
carries the `cuda` marker and skips without a card.

Tolerances: fp32 sums in another order (atomics, the merges of split
pieces), so `allclose` with rtol 1e-4 and atol 1e-5 of the largest
magnitude of the plain result."""
import _torch_cpu  # noqa: F401  (this worker's share of the cores)

import numpy as np
import pytest
import torch

import repro_torch as rt
from repro_torch.graphs.format import COOGraph
from repro_torch.graphs.generate import rmat_graph


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _multigraph(n=3000, e=30000, seed=5):
    """An R-MAT multigraph with weights in [0.1, 1), the repeats merged
    by the plan, and vertices 0-9 receiving nothing."""
    g = rmat_graph(n, e, seed=seed)
    keep = g.dst >= 10
    rng = np.random.default_rng(seed)
    src, dst = g.src[keep], g.dst[keep]
    val = rng.uniform(0.1, 1.0, src.size).astype(np.float32)
    return COOGraph(n, src, dst, val)


def _close(got, want):
    scale = max(1e-30, float(want.abs().max()))
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-5 * scale)


@pytest.mark.cuda
@pytest.mark.parametrize("whole", [False, True], ids=["split", "whole"])
@pytest.mark.parametrize("f", [1, 3, 41, 128, 602])
def test_gated_kernels_match_their_plain_versions(f, whole):
    dev = _card()
    from repro_torch.kernels.rer_gather import ops as gops
    from repro_torch.kernels.rer_gather_gated import ops as G
    g = _multigraph()
    layer = rt.make_gnn("gated_gcn", f, 4, backend="blocked", device=dev)
    layer.cfg.tile_format = "packed"
    plan = rt.prepare_graph(g, layer.cfg, device=dev)
    groups = plan.carrier["packed_groups"]
    meta = plan.carrier["blocks_meta"]
    q, t = meta["q"], meta["tile"]
    src = groups.source
    # the plan's pieces split the source intervals (merged rows)
    assert src is not None and src.pieces[:, 3].any().item()
    if whole:
        # one piece per source interval (~10 k entries at most): every dX
        # row stored, none merged
        host = [gops.real_counts(gr["rows"], gr["cols"], gr["vals"]).cpu()
                .numpy() for gr in groups]
        groups.source = gops._build_source(
            host, [gr["block_row"].cpu().numpy() for gr in groups],
            [gr["block_col"].cpu().numpy() for gr in groups], src.q, dev,
            piece=1 << 15)
        assert not groups.source.pieces[:, 3].any()
    gen = torch.Generator(device=dev).manual_seed(f)
    ph, pc, x, gy = (torch.randn((q * t, f), generator=gen, device=dev)
                     for _ in range(4))
    s, d, v = G._flat(groups, t)
    before = dict(G.LAUNCHES)
    y = G.gated_forward(groups, ph, pc, x, q=q)
    _close(y, G.gated_flat_plain(s, d, v, ph, pc, x, n=q * t))
    dx, dpc, dph = G.gated_backward(groups, ph, pc, x, gy, q=q)
    want = G.gated_backward_plain(s, d, v, ph, pc, x, gy)
    for got, ref in zip((dx, dpc, dph), want):
        _close(got, ref)
    none, dpc2, _ = G.gated_backward(groups, ph, pc, x, gy, q=q,
                                     need_dx=False)
    assert none is None
    _close(dpc2, want[1])
    torch.cuda.synchronize()
    assert {k: G.LAUNCHES[k] - before[k] for k in before} == \
        {"fwd": 1, "src": 2, "dph": 2}


@pytest.mark.cuda
def test_gated_layer_on_card_matches_segment():
    """A two-layer Gated-GCN [64, 16, 5] on the card's packed plan (the
    gated kernels) against "segment" (plain gathers): output and one
    backward's gradients of every parameter and of x; the packed route
    allocates less than half of one (entry, feature) tensor."""
    dev = _card()
    g = _multigraph(e=150000)
    entries = np.unique(g.dst.astype(np.int64) * g.num_vertices
                        + g.src).size
    x = torch.randn((g.num_vertices, 64), device=dev)
    outs, grads = {}, {}
    state = None
    for backend in ("segment", "blocked"):
        layers = rt.make_gnn_stack("gated_gcn", [64, 16, 5], backend=backend,
                                   device=dev)
        for layer in layers:
            layer.cfg.tile_format = "packed"
        if state is None:
            state = [ly.state_dict() for ly in layers]
        for ly, st in zip(layers, state):
            ly.load_state_dict(st)
        plan = rt.prepare_graph(g, layers[0].cfg, device=dev)
        if backend == "blocked":
            assert "packed_groups" in plan.carrier
            assert plan.carrier["packed_groups"].source is not None
        xr = x.clone().requires_grad_(True)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        base = torch.cuda.memory_allocated(dev)
        y = rt.apply_stack(layers, plan, xr)
        y.square().sum().backward()
        if backend == "blocked":
            grew = torch.cuda.max_memory_allocated(dev) - base
            assert grew < 4 * entries * x.shape[1] / 2, grew
        outs[backend] = y.detach()
        grads[backend] = [p.grad for ly in layers for p in ly.parameters()] \
            + [xr.grad]
    _close(outs["blocked"], outs["segment"])
    for a, b in zip(grads["blocked"], grads["segment"]):
        _close(a, b)
