"""R-GCN's typed pair projection (`kernels/typed_pairs`): the pair table
against a numpy oracle, the work tables, the plain autograd Function's
gradients against autograd of the einsum payload route, and the typed
blocked plans that carry the table, on the CPU.  The `cuda`-marked tests
hold the kernels (forward, dW, dX) to the plain versions on the card:
small-integer inputs, whose fp32 sums are exact in any order, compared
with `torch.equal`, and real-valued inputs within fp32 rounding.
"""
import _torch_cpu  # noqa: F401  (this worker's share of the cores)
import numpy as np
import pytest
import torch

import repro_torch as rt
from repro_torch import tracing
from repro_torch.core import engn as t_engn
from repro_torch.core import models as t_models
from repro_torch.graphs.format import COOGraph
from repro_torch.kernels import launch_counts
from repro_torch.kernels import typed_pairs as tp

RTOL, ATOL = 1e-5, 1e-6


def _entries(n, r, counts, seed):
    """Flat entries (gsrc, grel) with `counts[rel]` entries of relation
    rel (0: the relation has none), sources drawn with repeats (a
    negative count: that many entries of one source), in a shuffled
    order as a plan's tiles leave them."""
    rng = np.random.default_rng(seed)
    grel = np.repeat(np.arange(r), np.abs(counts)).astype(np.int32)
    gsrc = rng.integers(0, n, grel.size).astype(np.int32)
    for rr, c in enumerate(counts):
        if c < 0:
            gsrc[grel == rr] = gsrc[grel == rr][0]
    order = rng.permutation(grel.size)
    return gsrc[order], grel[order]


def _oracle(gsrc, grel):
    pairs = sorted(set(zip(grel.tolist(), gsrc.tolist())))
    return pairs, {p: i for i, p in enumerate(pairs)}


# relation 1 has no entry, relation 2 a single pair (three entries), and
# relation 3 more pairs than a projection block (several blocks)
CASES = {"mixed": (600, 5, [7, 0, -3, 400, 25], 0),
         "one_relation": (9, 1, [30], 1),
         "hub": (2000, 4, [5000, 1, 0, 2], 2)}


@pytest.mark.parametrize("case", sorted(CASES))
def test_pair_table_matches_numpy_oracle(case):
    n, r, counts, seed = CASES[case]
    gsrc, grel = _entries(n, r, counts, seed)
    pair_src, pair_ptr, gpair = tp.pair_table(gsrc, grel, n, r)
    pairs, index = _oracle(gsrc, grel)
    if case == "mixed":
        assert pair_ptr[3] - pair_ptr[2] == 1 and pair_ptr[4] - pair_ptr[3] > 128
    assert pair_src.dtype == np.int32 and gpair.dtype == np.int32
    assert pair_ptr.shape == (r + 1,) and pair_ptr[0] == 0
    got = [(rr, int(s)) for rr in range(r)
           for s in pair_src[pair_ptr[rr]:pair_ptr[rr + 1]]]
    assert got == pairs                       # sorted by (rel, src), unique
    want = np.array([index[(int(b), int(a))] for a, b in zip(gsrc, grel)])
    np.testing.assert_array_equal(gpair, want)
    np.testing.assert_array_equal(pair_src[gpair], gsrc)


@pytest.mark.parametrize("rows", [1, 4, 128, 2048])
@pytest.mark.parametrize("case", sorted(CASES))
def test_pair_blocks_cover_each_relation_once(case, rows):
    n, r, counts, seed = CASES[case]
    _, pair_ptr, _ = tp.pair_table(*_entries(n, r, counts, seed), n, r)
    blocks = tp.pair_blocks(pair_ptr, rows)
    assert blocks.dtype == np.int32 and blocks.shape[1] == 3
    rel, start, end = blocks.T
    assert np.all(end > start) and np.all(end - start <= rows)
    for rr in range(r):
        mine = blocks[rel == rr]
        if pair_ptr[rr + 1] == pair_ptr[rr]:
            assert mine.size == 0
            continue
        assert mine[0, 1] == pair_ptr[rr] and mine[-1, 2] == pair_ptr[rr + 1]
        np.testing.assert_array_equal(mine[1:, 1], mine[:-1, 2])
        assert len(mine) == -(-(pair_ptr[rr + 1] - pair_ptr[rr]) // rows)


def _pairs(case, dev="cpu"):
    n, r, counts, seed = CASES[case]
    gsrc, grel = _entries(n, r, counts, seed)
    return n, r, tp.TypedPairs(*tp.pair_table(gsrc, grel, n, r),
                               torch.device(dev))


def _einsum_rows(x, wr, pairs):
    """The reference route's rows: the (N, R, H) payload of every vertex
    under every relation, then each pair's row of it."""
    rel = torch.repeat_interleave(
        torch.arange(pairs.num_relations),
        torch.from_numpy(np.diff(pairs.pair_ptr)))
    return torch.einsum("nf,rfh->nrh", x, wr)[pairs.pair_src.long(), rel]


@pytest.mark.parametrize("case", sorted(CASES))
def test_plain_function_gradients_match_einsum_autograd(case):
    n, r, pairs = _pairs(case)
    f, h = 7, 5
    rng = np.random.default_rng(3)
    x0 = torch.from_numpy(rng.standard_normal((n, f)).astype(np.float32))
    w0 = torch.from_numpy(rng.standard_normal((r, f, h)).astype(np.float32))
    g = torch.from_numpy(rng.standard_normal((pairs.num_pairs, h))
                         .astype(np.float32))
    outs = []
    for fn in (tp.typed_pair_project, _einsum_rows):
        x, wr = x0.clone().requires_grad_(), w0.clone().requires_grad_()
        y = fn(x, wr, pairs)
        (y * g).sum().backward()
        outs.append((y.detach(), x.grad, wr.grad))
    for got, want in zip(*outs):
        # dW sums up to a relation's pairs (5,000 in "hub") in another
        # order: held relative to the largest magnitude
        scale = max(1.0, float(want.abs().max()))
        torch.testing.assert_close(got, want, rtol=RTOL, atol=ATOL * scale)
    # the Function's backward is the plain versions', pass by pass
    _, gx, gw = outs[0]
    torch.testing.assert_close(
        gx, tp.typed_pair_grad_x_plain(g, w0, pairs, x0.shape))
    torch.testing.assert_close(
        gw, tp.typed_pair_grad_w_plain(x0, g, pairs, w0.shape))


def test_only_the_asked_gradients_are_computed(monkeypatch):
    """x that needs no gradient (a first layer's features) gets no dX
    pass."""
    n, r, pairs = _pairs("mixed")
    called = []
    real = tp.ops.typed_pair_grad_x_plain

    def spy(*a):
        called.append(1)
        return real(*a)
    monkeypatch.setattr(tp.ops, "typed_pair_grad_x_plain", spy)
    x = torch.randn(n, 4)
    wr = torch.randn(r, 4, 3, requires_grad=True)
    tp.typed_pair_project(x, wr, pairs).sum().backward()
    assert called == [] and wr.grad is not None
    x.requires_grad_()
    tp.typed_pair_project(x, wr, pairs).sum().backward()
    assert called == [1] and x.grad is not None


def test_refuses_mismatched_shapes():
    n, r, pairs = _pairs("mixed")
    with pytest.raises(ValueError, match="relations"):
        tp.typed_pair_project(torch.randn(n, 4), torch.randn(r + 1, 4, 3),
                              pairs)
    with pytest.raises(TypeError, match="float32"):
        tp.typed_pair_project(torch.randn(n, 4, dtype=torch.float64),
                              torch.randn(r, 4, 3), pairs)


# -- the typed blocked plans that carry the table ----------------------------

def _typed_graph(n=300, e=2500, r=4, seed=5):
    rng = np.random.default_rng(seed)
    src = rng.integers(0, n, e).astype(np.int32)
    dst = rng.integers(0, n, e).astype(np.int32)
    rel = rng.integers(0, r, e).astype(np.int32)
    rel[rel == 2] = 1                      # relation 2 has no edge
    val = rng.uniform(0.5, 1.5, e).astype(np.float32)
    return COOGraph(n, src, dst, val, rel, r)


def _layer(fmt, f=6, h=5, r=4):
    cfg = t_engn.EnGNConfig(in_dim=f, out_dim=h, backend="blocked", tile=32,
                            tile_format=fmt)
    return t_models.RGCNLayer(cfg, r, device="cpu")


@pytest.mark.parametrize("fmt", ["packed", "auto"])
def test_packed_plan_carries_the_pairs_of_its_entries(fmt):
    g = _typed_graph()
    tl = _layer(fmt)
    plan = rt.prepare_graph(g, tl.cfg, device="cpu")
    gsrc, _, _, grel = (a.numpy() for a in plan.carrier["typed_flat"])
    pairs = plan.carrier["typed_pairs"]
    src, ptr, gpair = tp.pair_table(gsrc, grel, g.num_vertices, 4)
    np.testing.assert_array_equal(pairs.pair_src.numpy(), src)
    np.testing.assert_array_equal(pairs.pair_ptr, ptr)
    np.testing.assert_array_equal(pairs.gpair.numpy(), gpair)
    assert ptr[3] == ptr[2]                # the relation with no edge
    assert pairs.num_pairs < g.num_vertices * 4
    # the plan's bytes count the table's tensors
    assert plan.held_bytes() >= sum(
        t.numel() * t.element_size()
        for t in (pairs.pair_src, pairs.gpair, pairs.blocks, pairs.wblocks))


def test_dense_plan_keeps_the_payload_route():
    g = _typed_graph()
    tl = _layer("dense")
    plan = rt.prepare_graph(g, tl.cfg, device="cpu")
    assert "typed_pairs" not in plan.carrier
    tracing.reset()
    with torch.no_grad():
        tl(plan, torch.randn(g.num_vertices, 6))
    rep = tracing.report()
    assert rep["typed.payload_rows"]["calls"] == g.num_vertices * 4
    assert "typed.pair_rows" not in rep


def test_pair_route_trains_as_the_payload_route():
    """One R-GCN layer's output and gradients on the packed plan (pair
    route) against the same layer on "segment"."""
    g = _typed_graph()
    x0 = torch.randn(g.num_vertices, 6)
    outs = []
    for backend, fmt in (("blocked", "packed"), ("segment", "auto")):
        tl = _layer(fmt)
        tl.cfg.backend = backend
        plan = rt.prepare_graph(g, tl.cfg, device="cpu")
        x = x0.clone().requires_grad_()
        tracing.reset()
        y = tl(plan, x)
        (y * y).sum().backward()
        rows = tracing.report().get("typed.pair_rows", {}).get("calls")
        outs.append((rows, y.detach(), x.grad, tl.wr.grad, tl.w0.grad))
    (rows, *got), (none, *want) = outs
    distinct = np.unique(g.rel.astype(np.int64) * g.num_vertices + g.src)
    assert rows == distinct.size and none is None
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-5)


# -- on the card ---------------------------------------------------------------

def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _card_case(case, f, h, integer, seed=0):
    n, r, cpu_pairs = _pairs(case)
    dev = _card()
    pairs = tp.TypedPairs(cpu_pairs.pair_src.numpy(), cpu_pairs.pair_ptr,
                          cpu_pairs.gpair.numpy(), dev)
    rng = np.random.default_rng(seed)
    if integer:
        def draw(*s):
            return (rng.integers(-3, 4, s) * 0.5).astype(np.float32)
    else:
        def draw(*s):
            return rng.standard_normal(s).astype(np.float32)
    x = torch.from_numpy(draw(n, f)).to(dev)
    wr = torch.from_numpy(draw(r, f, h)).to(dev)
    g = torch.from_numpy(draw(pairs.num_pairs, h)).to(dev)
    return x, wr, g, pairs, cpu_pairs


# F = 10 / H = 11 (AM's second layer), AM's first (267 / 10), a narrow
# dW slice shared by two thread groups (64), and widths over one H-chunk
# (16) and one dW feature slice (512) and dX slice (256)
SHAPES = [(10, 11), (267, 10), (3, 4), (64, 13), (600, 20)]


@pytest.mark.cuda
@pytest.mark.parametrize("integer", [True, False])
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("case", sorted(CASES))
def test_kernels_match_plain_on_card(case, shape, integer):
    f, h = shape
    x, wr, g, pairs, cpu_pairs = _card_case(case, f, h, integer)
    before = launch_counts()
    xg, wg = x.clone().requires_grad_(), wr.clone().requires_grad_()
    y = tp.typed_pair_project(xg, wg, pairs)
    y.backward(g)
    torch.cuda.synchronize()
    after = launch_counts()
    for k in ("project", "grad_w", "grad_x"):
        assert after[f"typed_pairs_{k}"] == before[f"typed_pairs_{k}"] + 1
    want = (tp.typed_pair_project_plain(x.cpu(), wr.cpu(), cpu_pairs),
            tp.typed_pair_grad_x_plain(g.cpu(), wr.cpu(), cpu_pairs,
                                       x.shape),
            tp.typed_pair_grad_w_plain(x.cpu(), g.cpu(), cpu_pairs,
                                       wr.shape))
    for got, ref in zip((y.detach(), xg.grad, wg.grad), want):
        if integer:
            assert torch.equal(got.cpu(), ref)
        else:
            scale = max(1.0, float(ref.abs().max()))
            torch.testing.assert_close(got.cpu(), ref, rtol=1e-5,
                                       atol=1e-5 * scale)


@pytest.mark.cuda
def test_packed_rgcn_plan_takes_the_kernels_on_card():
    dev = _card()
    g = _typed_graph()
    cfg = t_engn.EnGNConfig(in_dim=6, out_dim=5, backend="blocked", tile=32,
                            tile_format="auto")
    tl = t_models.RGCNLayer(cfg, 4, device=dev)
    plan = rt.prepare_graph(g, tl.cfg, device=dev)
    x = torch.randn(g.num_vertices, 6, device=dev, requires_grad=True)
    before = launch_counts()
    tl(plan, x).sum().backward()
    after = launch_counts()
    for k in ("project", "grad_w", "grad_x"):
        assert after[f"typed_pairs_{k}"] == before[f"typed_pairs_{k}"] + 1
    ref = _layer("auto")
    ref.load_state_dict({k: v.cpu() for k, v in tl.state_dict().items()})
    ref.cfg.backend = "segment"
    xc = x.detach().cpu().requires_grad_()
    want = ref(rt.prepare_graph(g, ref.cfg, device="cpu"), xc)
    want.sum().backward()
    torch.testing.assert_close(tl(plan, x).detach().cpu(), want.detach(),
                               rtol=1e-4, atol=1e-5)
    torch.testing.assert_close(x.grad.cpu(), xc.grad, rtol=1e-4, atol=1e-5)
    torch.testing.assert_close(tl.wr.grad.cpu(), ref.wr.grad, rtol=1e-4,
                               atol=1e-5)
