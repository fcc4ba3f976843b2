"""The inference slice of the port against the reference, on the CPU.

gcn / gs_pool / grn x segment / blocked-dense / blocked-packed / fused
(gcn only) x sum / max / mean: the same numpy graph and features, the
reference's initial weights carried across by `load_reference_params`.
Aggregates of max are exactly equal; sums, means and layer outputs agree
to rtol=1e-4, atol=1e-5 (the frameworks reduce in different orders).
Plans and carriers are exactly equal.
"""

import _torch_cpu  # noqa: F401  (this worker's share of the cores)
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import engn as j_engn
from repro.core import models as j_models
from repro.graphs.degree import (apply_vertex_permutation,
                                 degree_sort_permutation, permute_features,
                                 unpermute_features)
from repro.graphs.generate import make_dataset, random_features
import repro_torch as rt
from repro_torch.core import engn as t_engn
from repro_torch.core.tiled import DeviceBudgetExceeded
from repro_torch.interop import load_reference_params

RTOL, ATOL = 1e-4, 1e-5
DIMS = {"gcn": [12, 16, 5], "gs_pool": [12, 8, 5], "grn": [12, 12]}
BACKENDS = [("segment", "auto"), ("blocked", "dense"),
            ("blocked", "packed"), ("fused", "auto")]


def _graph(n=120, f=12, seed=0):
    g, _, _ = make_dataset("cora", seed=seed, max_vertices=n,
                           feature_dim=f)
    perm = degree_sort_permutation(g)
    g = apply_vertex_permutation(g, perm).gcn_normalized()
    x = permute_features(random_features(n, f, seed=1), perm)
    return g, x, perm


def _distinct(g):
    """`g` with each (src, dst) pair once, in key order, at its first
    copy's weight: the neighbour sets a max plan of the port holds,
    drawn here with numpy (the reference's carriers merge repeats by
    summing)."""
    key = g.dst.astype(np.int64) * g.num_vertices + g.src
    _, first = np.unique(key, return_index=True)
    return type(g)(g.num_vertices, g.src[first], g.dst[first],
                   None if g.val is None else g.val[first])


def _reference_graph(g, backend, op):
    """The graph the reference's plan is built from: for a max over tile
    carriers, its distinct edges (`_distinct`)."""
    if op == "max" and backend in ("blocked", "fused"):
        return _distinct(g)
    return g


def _stacks(model, dims, backend, fmt, op=None, tile=16):
    """The reference's stack with its weights, and the port's twin."""
    jl = j_models.make_gnn_stack(model, dims, backend=backend, tile=tile)
    tl = rt.make_gnn_stack(model, dims, backend=backend, tile=tile,
                           device="cpu")
    for a, b in zip(jl, tl):
        for cfg in (a.cfg, b.cfg):
            cfg.tile_format = fmt
            if op is not None:
                cfg.aggregate_op = op
    jp = j_models.init_stack(jl, jax.random.key(0))
    load_reference_params(tl, [{k: np.asarray(v) for k, v in p.items()}
                               for p in jp])
    return jl, jp, tl


def _cases():
    for model in ("gcn", "gs_pool", "grn"):
        for backend, fmt in BACKENDS:
            if backend == "fused" and model != "gcn":
                continue
            for op in ("sum", "max", "mean"):
                yield model, backend, fmt, op


@pytest.mark.parametrize("model,backend,fmt,op", list(_cases()))
def test_slice_matches_reference(model, backend, fmt, op):
    g, x, _ = _graph()
    jl, jp, tl = _stacks(model, DIMS[model], backend, fmt, op)
    jg = _reference_graph(g, backend, op)
    want = np.asarray(j_models.apply_stack(
        jl, jp, j_engn.prepare_graph(jg, jl[0].cfg), jnp.asarray(x)))
    plan = rt.prepare_graph(g, tl[0].cfg, device="cpu")
    with torch.no_grad():
        got = rt.apply_stack(tl, plan, torch.from_numpy(x)).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("backend,fmt", BACKENDS)
@pytest.mark.parametrize("op", ["sum", "max", "mean"])
def test_aggregate_matches_reference(backend, fmt, op):
    g, _, _ = _graph(seed=2)
    jl, _, tl = _stacks("gcn", [12, 6], backend, fmt, op)
    feat = np.random.default_rng(3).standard_normal(
        (g.num_vertices, 6)).astype(np.float32)
    jg = _reference_graph(g, backend, op)
    want = np.asarray(jl[0]._aggregate(j_engn.prepare_graph(jg, jl[0].cfg),
                                       jnp.asarray(feat)))
    got = tl[0]._aggregate(rt.prepare_graph(g, tl[0].cfg, device="cpu"),
                           torch.from_numpy(feat)).numpy()
    if op == "max":
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("backend,fmt", BACKENDS + [("blocked", "auto")])
@pytest.mark.parametrize("op", ["sum", "mean"])
def test_plan_and_carrier_equal_reference(backend, fmt, op):
    g, _, _ = _graph(seed=4)
    jl, _, tl = _stacks("gcn", [12, 6], backend, fmt, op)
    jplan = j_engn.prepare_graph(g, jl[0].cfg)
    tplan = rt.prepare_graph(g, tl[0].cfg, device="cpu")
    assert tplan.device == torch.device("cpu")
    for attr in ("backend", "n", "tile_format", "streaming_mode",
                 "footprint_bytes"):
        assert getattr(tplan, attr) == getattr(jplan, attr), attr
    ja, ta = jplan.autotune, tplan.autotune
    assert (ja is None) == (ta is None)
    if ja is not None:
        assert ja.as_dict() == ta.as_dict()
    jc, tc = jplan.carrier, tplan.carrier
    assert set(tc) - {"device"} == set(jc)
    for key, jv in jc.items():
        tv = tc[key]
        if key == "blocks_meta":
            jm = {k: v for k, v in jv.items() if k != "format_choice"}
            tm = {k: v for k, v in tv.items() if k != "format_choice"}
            assert jm == tm
        elif isinstance(jv, tuple):
            for a, b in zip(jv, tv):
                np.testing.assert_array_equal(b.numpy(), np.asarray(a))
                assert b.numpy().dtype == np.asarray(a).dtype
        elif hasattr(jv, "shape"):
            np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
            assert tv.numpy().dtype == np.asarray(jv).dtype
        else:
            assert tv == jv, key


def test_quickstart_slice():
    """examples/quickstart.py at a CPU size: degree sort, GCN
    normalisation, `prepare_graph`, a 2-layer GCN on "fused", undo the
    relabelling."""
    g, f, classes = make_dataset("cora", seed=0, max_vertices=400,
                                 feature_dim=48)
    x = random_features(g.num_vertices, f, seed=1)
    perm = degree_sort_permutation(g)
    g = apply_vertex_permutation(g, perm).gcn_normalized()
    x = permute_features(x, perm)
    jl, jp, tl = _stacks("gcn", [f, 16, classes], "fused", "auto", tile=32)
    want = unpermute_features(np.asarray(j_models.apply_stack(
        jl, jp, j_engn.prepare_graph(g, jl[0].cfg), jnp.asarray(x))), perm)
    plan = rt.prepare_graph(g, tl[0].cfg, device="cpu")
    assert [layer.dasr_order() for layer in tl] == ["fau", "fau"]
    with torch.no_grad():
        got = unpermute_features(rt.apply_stack(tl, plan, x).numpy(), perm)
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    np.testing.assert_array_equal(got.argmax(-1), want.argmax(-1))


@pytest.mark.parametrize("op", ["sum", "max", "mean"])
def test_segment_aggregate_matches_reference(op):
    rng = np.random.default_rng(0)
    ev = rng.standard_normal((50, 4)).astype(np.float32)
    dst = rng.integers(0, 9, 50).astype(np.int32)     # rows 9..11 empty
    want = np.asarray(j_engn.segment_aggregate(jnp.asarray(ev),
                                               jnp.asarray(dst), 12, op))
    got = t_engn.segment_aggregate(torch.from_numpy(ev),
                                   torch.from_numpy(dst), 12, op).numpy()
    if op == "max":
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    assert not got[9:].any()


def test_dasr_and_config_match_reference():
    for f, h, order in ((12, 16, "auto"), (16, 5, "auto"), (8, 8, "afu")):
        jlay = j_models.make_gnn("gcn", f, h, stage_order=order)
        tlay = rt.make_gnn("gcn", f, h, stage_order=order, device="cpu")
        assert jlay.dasr_order() == tlay.dasr_order()
        assert jlay.dasr_op_counts(100) == tlay.dasr_op_counts(100)
    jcfg = j_engn.EnGNConfig(3, 4)
    tcfg = t_engn.EnGNConfig(3, 4)
    for name in jcfg.__dataclass_fields__:
        if name != "dtype":
            assert getattr(jcfg, name) == getattr(tcfg, name), name
    assert set(jcfg.__dataclass_fields__) == set(tcfg.__dataclass_fields__)


def test_stack_weights_come_from_the_seed():
    a = rt.make_gnn_stack("gs_pool", [6, 4, 3], device="cpu", seed=5)
    b = rt.make_gnn_stack("gs_pool", [6, 4, 3], device="cpu", seed=5)
    c = rt.make_gnn_stack("gs_pool", [6, 4, 3], device="cpu", seed=6)
    for la, lb, lc in zip(a, b, c):
        for (k, va), vb, vc in zip(la.named_parameters(), lb.parameters(),
                                   lc.parameters()):
            assert torch.equal(va, vb)
            assert k == "b_pool" or not torch.equal(va, vc)
    rt.init_stack(c, 5)
    for la, lc in zip(a, c):
        for va, vc in zip(la.parameters(), lc.parameters()):
            assert torch.equal(va, vc)


def test_load_reference_params_rejects_mismatch():
    tl = rt.make_gnn_stack("gcn", [4, 3], device="cpu")
    with pytest.raises(ValueError, match="reference has"):
        load_reference_params(tl, [{"w_pool": np.zeros((4, 3))}])
    with pytest.raises(ValueError, match="shape"):
        load_reference_params(tl, [{"w": np.zeros((3, 4))}])
    with pytest.raises(ValueError, match="parameter dicts"):
        load_reference_params(tl, [])


def test_entry_points_default_to_cuda():
    """With no card and no explicit CPU request, the entry points raise
    instead of running on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device works")
    g, _, _ = _graph()
    cfg = t_engn.EnGNConfig(12, 5, backend="blocked")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        rt.prepare_graph(g, cfg)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        rt.make_gnn_stack("gcn", [12, 5])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        rt.EnGNLayer(cfg)


def test_strict_budget_raises_device_budget_exceeded():
    g, _, _ = _graph()
    for fmt in ("dense", "packed"):
        cfg = t_engn.EnGNConfig(12, 5, backend="blocked", tile=16,
                                tile_format=fmt, device_budget_bytes=1000,
                                auto_spill=False)
        with pytest.raises(DeviceBudgetExceeded):
            rt.prepare_graph(g, cfg, device="cpu")
        cfg.device_budget_bytes = 10 ** 9
        assert rt.prepare_graph(g, cfg, device="cpu").tile_format == fmt


# -- on the card -----------------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("model,backend,fmt,op", [
    ("gcn", "fused", "auto", "sum"), ("gcn", "blocked", "dense", "sum"),
    ("gcn", "blocked", "packed", "mean"), ("gs_pool", "blocked", "dense",
                                           "max"),
    ("gs_pool", "blocked", "packed", "max"), ("grn", "blocked", "packed",
                                              "sum")])
def test_slice_on_card_matches_cpu(model, backend, fmt, op):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    from repro_torch.kernels import launch_counts
    g, x, _ = _graph()
    _, _, cpu = _stacks(model, DIMS[model], backend, fmt, op)
    _, _, card = _stacks(model, DIMS[model], backend, fmt, op)
    card = [layer.cuda() for layer in card]
    with torch.no_grad():
        want = rt.apply_stack(cpu, rt.prepare_graph(g, cpu[0].cfg,
                                                    device="cpu"), x)
        before = sum(launch_counts().values())
        plan = rt.prepare_graph(g, card[0].cfg)
        got = rt.apply_stack(card, plan, x).cpu()
    assert sum(launch_counts().values()) > before
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=RTOL,
                               atol=ATOL)
