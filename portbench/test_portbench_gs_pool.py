"""GS-Pool's plain reference (`reference/gs_pool.py`) on the CPU: its
chunked max against one unchunked `scatter_reduce`, and the port's
GS-Pool on a multigraph against it, on every route that builds tile
carriers."""
import numpy as np
import pytest
import torch

from portbench.lib import plain
from portbench.lib.spec import load_module

REF = load_module("reference", "gs_pool")


def _tied_graph():
    """9 vertices, 14 edges with repeats; integer messages, so rows tie
    within and across chunks of 3 edges."""
    src = torch.tensor([0, 1, 0, 2, 3, 0, 4, 1, 5, 5, 6, 7, 2, 0])
    dst = torch.tensor([8, 8, 8, 8, 6, 6, 6, 6, 1, 1, 1, 2, 3, 3])
    m = torch.tensor([[1., 2.], [1., 0.], [3., 2.], [2., 2.], [0., 5.],
                      [1., 1.], [3., 1.], [3., 3.]], dtype=torch.float64)
    m = torch.cat([m, torch.zeros((1, 2), dtype=torch.float64)])
    return src, dst, m


@pytest.mark.parametrize("chunk", [None, 1, 3, 5])
def test_chunked_max_equals_one_scatter_reduce(chunk):
    src, dst, m0 = _tied_graph()
    g = torch.arange(18, dtype=torch.float64).reshape(9, 2) - 4.0
    m = m0.clone().requires_grad_(True)
    y = REF.ChunkedMax.apply(m, src, dst, 9, chunk, False)
    (y * g).sum().backward()
    # one scatter_reduce over every edge: its backward splits the
    # cotangent evenly over each row's tied edges
    mu = m0.clone().requires_grad_(True)
    full = torch.zeros((9, 2), dtype=torch.float64).scatter_reduce(
        0, dst[:, None].expand(-1, 2), mu[src], "amax", include_self=False)
    (full * g).sum().backward()
    assert torch.equal(y.detach(), full.detach())
    assert torch.equal(m.grad, mu.grad)
    # row 8's second feature ties over edges 0, 2 and 3, which a chunk
    # of 3 edges cuts: the split counts the winners of both chunks
    win = (m0[src] == full.detach()[dst])[:, 1] & (dst == 8)
    assert win.nonzero().flatten().tolist() == [0, 2, 3]


def test_transposed_fault_moves_the_gradient():
    src, dst, m0 = _tied_graph()
    g = torch.arange(18, dtype=torch.float64).reshape(9, 2)
    grads = []
    for transposed in (False, True):
        m = m0.clone().requires_grad_(True)
        (REF.ChunkedMax.apply(m, src, dst, 9, 3, transposed)
         * g).sum().backward()
        grads.append(m.grad)
    assert not torch.equal(*grads)


def _ports_gs_pool(g, dims, backend, fmt, params):
    import repro_torch as rt
    from repro_torch.core.models import apply_stack
    layers = rt.make_gnn_stack("gs_pool", dims, backend=backend, tile=16,
                               device="cpu")
    for layer in layers:
        layer.cfg.tile_format = fmt
    ps = [{k: v.clone().requires_grad_(True) for k, v in p.items()}
          for p in params]
    return layers, rt.prepare_graph(g, layers[0].cfg, device="cpu"), ps, \
        apply_stack


def test_ports_gs_pool_matches_the_reference_on_a_multigraph():
    """Segment, blocked-dense and blocked-packed: the first layer's max
    is bitwise equal across the routes; the loss and every gradient are
    the float64 reference's to float32's rounding of a two-layer stack:
    a relative 1e-5 on the loss, and 1e-5 of each leaf's largest gradient
    element (float32's 6e-8 grown by the products' sums of up to 28
    terms and the weight gradients' sums over 200 rows read 5.6e-7)."""
    from repro_torch.graphs.format import COOGraph
    from repro_torch.graphs.generate import rmat_graph
    n, dims = 200, [12, 16, 5]
    g = rmat_graph(n, 3000, seed=4)
    g = COOGraph(n, g.src, g.dst)
    assert np.unique(g.dst.astype(np.int64) * n + g.src).size < g.num_edges
    gen = torch.Generator().manual_seed(7)
    params = REF.init_params({"dims": dims}, gen, torch.device("cpu"))
    x = torch.randn((n, dims[0]), generator=gen)
    labels = torch.randint(0, dims[-1], (n,), generator=gen)
    nodes = torch.arange(0, n, 3)

    src, dst = torch.from_numpy(g.src), torch.from_numpy(g.dst)
    rg = REF.Graph(src, dst, None, {"graph": {"vertices": n}})
    wide = [{k: v.double().requires_grad_(True) for k, v in p.items()}
            for p in params]
    loss = plain.nll(REF.forward(rg, x.double(), wide, chunk=700), labels,
                     nodes)
    loss.backward()

    aggs = []
    for backend, fmt in (("segment", "auto"), ("blocked", "dense"),
                         ("blocked", "packed")):
        layers, plan, ps, apply_stack = _ports_gs_pool(g, dims, backend,
                                                       fmt, params)
        with torch.no_grad():
            m = torch.relu(x @ params[0]["w_pool"] + params[0]["b_pool"])
            aggs.append(layers[0]._aggregate(plan, m))
        got = plain.nll(apply_stack(layers, plan, x, ps), labels, nodes)
        got.backward()
        assert abs(float(got.detach()) - float(loss.detach())) <= \
            1e-5 * abs(float(loss.detach()))
        for p, r in zip(ps, wide):
            for k in p:
                want = r[k].grad
                torch.testing.assert_close(
                    p[k].grad.double(), want, rtol=0,
                    atol=1e-5 * float(want.abs().max()))
    assert torch.equal(aggs[0], aggs[1]) and torch.equal(aggs[0], aggs[2])


def test_least_work_of_a_layer():
    work = {"n": 10, "entries": 40, "src_rows": 8, "dst_rows": 10,
            "self_term": 0}
    fwd = REF.model_flops([6, 4], work, False)
    assert fwd == 2 * 8 * 6 * 4 + 40 * 4 + 2 * 10 * (4 + 6) * 4
    assert REF.model_flops([6, 4], work, True) == 2 * fwd
    assert REF.aggregate_bytes([6, 4], work, False) == 12 * 40 + 8 * 10 * 4


def test_least_work_of_the_cell_is_pinned():
    """The `work` gspool-reddit.train printed on the card (graph seed 0:
    78,789,682 distinct entries, 218,663 vertices that send) and the
    least FLOPs and aggregate bytes the reference counts from it, to the
    FLOP and the byte: the yardstick of `mfu.train` and
    `agg_roofline.train` in that cell."""
    from portbench.lib import counts, spec
    cfg = spec.load_data("configs", "gspool-reddit")
    assert spec.load_module("reference", cfg["model"]).model_flops
    flops, agg_bytes = counts.least_work(REF)
    work = {"n": 232965, "entries": 78789682, "src_rows": 218663,
            "dst_rows": 232965, "self_term": 0}
    got = [(flops(cfg["dims"], work, t), agg_bytes(cfg["dims"], work, t))
           for t in (False, True)]
    assert got == [(203402116012.0, 2444477208.0),
                   (406804232024.0, 4888954416.0)]
