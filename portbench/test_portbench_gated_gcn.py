"""Gated-GCN's plain reference (`reference/gated_gcn.py`) on the CPU: its
chunked aggregate against one unchunked formula in value and gradients,
its planted faults, its least counts, the port's Gated-GCN on a
multigraph against it, and the readers of the new per-layer metrics
(`gated_roofline.train`, `gate_evals.train`)."""
import math
import re

import numpy as np
import pytest
import torch

from portbench.lib import plain, spans, spec
from portbench.lib.readers import Context
from portbench.lib.trace import TraceSummary

REF = spec.load_module("reference", "gated_gcn")


def _multigraph():
    """9 vertices, 15 edges with repeats (0 -> 8 three times); vertex 4
    receives nothing, vertex 8 sends nothing."""
    src = torch.tensor([0, 1, 0, 2, 3, 0, 4, 1, 5, 5, 6, 7, 2, 0, 0])
    dst = torch.tensor([8, 8, 8, 8, 6, 6, 6, 6, 1, 1, 1, 2, 3, 3, 8])
    return src, dst


def _operands(f=3, seed=0):
    gen = torch.Generator().manual_seed(seed)
    return [torch.randn((9, f), generator=gen, dtype=torch.float64)
            for _ in range(4)]


@pytest.mark.parametrize("chunk", [None, 1, 4, 6])
def test_chunked_gated_equals_one_formula(chunk):
    src, dst = _multigraph()
    ph0, pc0, x0, g = _operands()
    leaves = [a.clone().requires_grad_(True) for a in (ph0, pc0, x0)]
    y = REF.ChunkedGated.apply(*leaves, src, dst, 9, chunk, False)
    (y * g).sum().backward()
    ref = [a.clone().requires_grad_(True) for a in (ph0, pc0, x0)]
    ph, pc, x = ref
    msg = torch.sigmoid(ph[dst] + pc[src]) * x[src]
    full = torch.zeros((9, 3), dtype=torch.float64).index_add(0, dst, msg)
    (full * g).sum().backward()
    torch.testing.assert_close(y.detach(), full.detach(), rtol=1e-14,
                               atol=1e-14)
    for a, b in zip(leaves, ref):
        torch.testing.assert_close(a.grad, b.grad, rtol=1e-14, atol=1e-14)
    assert not y[4].any()                    # receives nothing
    assert not leaves[2].grad[8].any()       # sends nothing


def test_no_dx_where_the_input_takes_no_gradient():
    src, dst = _multigraph()
    ph0, pc0, x0, g = _operands()
    ph, pc = (a.clone().requires_grad_(True) for a in (ph0, pc0))
    (REF.ChunkedGated.apply(ph, pc, x0, src, dst, 9, 4, False)
     * g).sum().backward()
    assert ph.grad is not None and pc.grad is not None and x0.grad is None


def _grads(fault):
    src, dst = _multigraph()
    gen = torch.Generator().manual_seed(3)
    cfg = {"dims": [4, 8, 6], "graph": {"vertices": 9}}
    params = REF.init_params(cfg, gen, torch.device("cpu"))
    x = torch.randn((9, 4), generator=gen, dtype=torch.float64)
    wide = [{k: v.double().requires_grad_(True) for k, v in p.items()}
            for p in params]
    g = REF.Graph(src, dst, None, cfg)
    REF.forward(g, x, wide, fault=fault, chunk=5).square().sum().backward()
    return [{k: v.grad for k, v in p.items()} for p in wide]


def test_faults_move_the_first_layers_gate_gradients():
    """"scaled" doubles what the first layer's aggregate sends back (its
    gate weights' gradients, not its update's); "transposed" changes
    them; the second layer's are the sound run's."""
    sound, scaled, trans = (_grads(f) for f in (None, "scaled",
                                                 "transposed"))
    for k in ("w_h", "w_c"):
        assert sound[0][k].abs().max() > 0
        torch.testing.assert_close(scaled[0][k], 2 * sound[0][k])
        assert not torch.allclose(trans[0][k], sound[0][k])
    for grads in (scaled, trans):
        torch.testing.assert_close(grads[0]["w"], sound[0]["w"])
        for k in sound[1]:
            torch.testing.assert_close(grads[1][k], sound[1][k])
    with pytest.raises(ValueError):
        _grads("half_batch")


def test_work_counts_of_a_multigraph():
    src, dst = _multigraph()
    g = REF.Graph(src, dst, None, {"graph": {"vertices": 9}})
    assert g.work == {"n": 9, "entries": 12, "src_rows": 8, "dst_rows": 5,
                      "self_term": 0}
    assert g.astype(torch.float64) is g


def test_least_work_of_a_layer_and_a_step():
    work = {"n": 10, "entries": 40, "src_rows": 8, "dst_rows": 9,
            "self_term": 0}
    dims = [6, 4, 2]
    # the gated aggregates: 5 operations an (entry, feature) forward, 6
    # more backward, 2 more where the input is trained (layer 2)
    assert REF.gated_flops(dims, work, False) == 40 * (6 + 4) * 5
    assert REF.gated_flops(dims, work, True) == \
        40 * 6 * (5 + 6) + 40 * 4 * (5 + 6 + 2)
    fwd = 12 * 40 * 2 + 4 * 4 * 10 * (6 + 4)
    assert REF.gated_bytes(dims, work, False) == fwd
    assert REF.gated_bytes(dims, work, True) == \
        fwd + 12 * 40 * 2 + 4 * 10 * (6 * 6 + 7 * 4)
    assert REF.aggregate_bytes(dims, work, True) == \
        REF.gated_bytes(dims, work, True)
    mm = [2 * (9 + 8) * 6 * 6 + 2 * 10 * 6 * 4,
          2 * (9 + 8) * 4 * 4 + 2 * 10 * 4 * 2]
    assert REF.model_flops(dims, work, False) == \
        REF.gated_flops(dims, work, False) + sum(mm)
    assert REF.model_flops(dims, work, True) == \
        REF.gated_flops(dims, work, True) + 2 * mm[0] + 3 * mm[1]


def test_least_counts_stay_under_what_the_walks_do():
    """A least count never exceeds the work: the program's three walks
    gather three F-wide rows an entry each and evaluate a gate an entry
    and feature each, against the least bytes and operations."""
    work = {"n": 232965, "entries": 78789682, "src_rows": 218663,
            "dst_rows": 218663, "self_term": 0}
    dims = [602, 128, 41]
    walked = sum(3 * (12.0 * work["entries"] + 3 * 4.0 * work["entries"] * f)
                 for f in dims[:-1])
    assert REF.gated_bytes(dims, work, True) < walked
    # the walks' operations an (entry, feature), the exponential not
    # counted: the forward's gate (3), v z and its fused add (3); the
    # source walk's gate (3), v g, z (1 - z) (3) and two fused adds (4,
    # the one into dx included); the destination walk's gate (3), v x,
    # z (1 - z) (3) and a fused add (2)
    per_entry = 6 + 10 + 8
    assert REF.gated_flops(dims, work, True) < \
        per_entry * work["entries"] * sum(dims[:-1])


def test_ports_gated_gcn_matches_the_reference_on_a_multigraph():
    """Segment, blocked packed on its flat entries (the CPU plan) and on
    bucket groups (the card's carrier, built on CPU tensors): the loss and
    every gradient are the float64 reference's to float32's rounding of
    a two-layer stack, a relative 1e-5 on the loss and 1e-5 of each
    leaf's largest gradient element."""
    import repro_torch as rt
    from repro_torch.core.engn import upload_groups
    from repro_torch.core.models import apply_stack
    from repro_torch.graphs.format import COOGraph
    from repro_torch.graphs.generate import rmat_graph
    from repro_torch.graphs.partition import (build_tile_store,
                                              pack_tile_store)
    from repro_torch.kernels.rer_gather import prepare_packed_groups
    n, dims = 200, [12, 16, 5]
    g = rmat_graph(n, 3000, seed=4)
    g = COOGraph(n, g.src, g.dst)
    assert np.unique(g.dst.astype(np.int64) * n + g.src).size < g.num_edges
    gen = torch.Generator().manual_seed(7)
    params = REF.init_params({"dims": dims}, gen, torch.device("cpu"))
    x = torch.randn((n, dims[0]), generator=gen)
    labels = torch.randint(0, dims[-1], (n,), generator=gen)
    nodes = torch.arange(0, n, 3)

    rg = REF.Graph(torch.from_numpy(g.src), torch.from_numpy(g.dst), None,
                   {"graph": {"vertices": n}})
    wide = [{k: v.double().requires_grad_(True) for k, v in p.items()}
            for p in params]
    loss = plain.nll(REF.forward(rg, x.double(), wide, chunk=700), labels,
                     nodes)
    loss.backward()

    for backend, groups in (("segment", False), ("blocked", False),
                            ("blocked", True)):
        layers = rt.make_gnn_stack("gated_gcn", dims, backend=backend,
                                   tile=16, device="cpu")
        for layer in layers:
            layer.cfg.tile_format = "packed"
        plan = rt.prepare_graph(g, layers[0].cfg, device="cpu")
        if groups:
            plan = dict(plan.carrier)
            plan.pop("packed_flat")
            plan["packed_groups"] = upload_groups(prepare_packed_groups(
                pack_tile_store(build_tile_store(g, 16))), "cpu",
                source=True)
        ps = [{k: v.clone().requires_grad_(True) for k, v in p.items()}
              for p in params]
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


# -- the readers of the new per-layer metrics ---------------------------------

DIMS = [602, 128, 41]
WORK = {"n": 1000, "entries": 50000, "src_rows": 900, "dst_rows": 950,
        "self_term": 0}
PEAKS = {"hbm_bytes_per_s": 3.35e12, "fp32_flops_per_s": 67e12}
NS = "void (anonymous namespace)::"
FWD = NS + "gated_dst_kernel<false, 4>(long long const*)"
SRC = NS + "gated_src_kernel<true, 4, 4>(long long const*)"
B2 = NS + "rer_gather_kernel<false, 4>(long long const*)"


def _ctx(train, trace, root):
    return Context(train=train, dims=DIMS, work=WORK, iter_s=0.01,
                   trace=trace, peaks=PEAKS,
                   families=spec.kernel_families(root), prepare_s=1.0,
                   plan_bytes=0, build_s=0.1)


def _trace(ops):
    return TraceSummary(iters=2, window_s=0.1, busy_s=0.05, device_ops=ops,
                        gaps=[])


def test_the_gated_family_matches_only_the_gated_kernels(tiny_root):
    fams = {f["family"]: f for f in spec.kernel_families(tiny_root)}
    gated = [re.compile(p) for p in fams["rer_gather_gated"]["patterns"]]
    assert fams["rer_gather_gated"]["role"] == "gated"
    assert all(any(r.search(k) for r in gated) for k in (FWD, SRC))
    assert not any(r.search(B2) for r in gated)
    for name, fam in fams.items():
        if name != "rer_gather_gated":
            assert not any(re.search(p, k) for p in fam["patterns"]
                           for k in (FWD, SRC)), name


def test_gated_roofline_reads_the_gated_role(tiny_root):
    reader = spec.load_module("metrics", "gated_roofline.train", tiny_root)
    trace = _trace([(FWD, 0.0, 0.01), (SRC, 0.01, 0.04), (B2, 0.04, 0.05)])
    least = max(REF.gated_bytes(DIMS, WORK, True) / 3.35e12,
                REF.gated_flops(DIMS, WORK, True) / 67e12)
    assert math.isclose(reader.read(_ctx(True, trace, tiny_root)),
                        100.0 * least * 2 / 0.04)
    assert reader.read(_ctx(False, trace, tiny_root)) is None
    assert reader.read(_ctx(True, None, tiny_root)) is None
    # a cell of another model: no kernel of the role
    assert reader.read(_ctx(True, _trace([(B2, 0.0, 0.05)]),
                            tiny_root)) is None


def test_gate_evals_reads_the_counter(tiny_root, monkeypatch):
    reader = spec.load_module("metrics", "gate_evals.train", tiny_root)
    busy = _trace([(FWD, 0.0, 0.01)])
    evals = 3 * WORK["entries"] * (602 + 128) * 2
    monkeypatch.setattr(spans, "program_report", lambda: {
        "gated.gate_evals": {"calls": evals, "host_s": 0.0,
                             "device_s": None}})
    assert math.isclose(reader.read(_ctx(True, busy, tiny_root)), 3.0)
    assert reader.read(_ctx(False, busy, tiny_root)) is None
    idle = TraceSummary(iters=2, window_s=0.1, busy_s=0.0, device_ops=[],
                        gaps=[])
    assert reader.read(_ctx(True, idle, tiny_root)) is None
    # a port without the counter (the parent commit, another model)
    for report in (None, {}):
        monkeypatch.setattr(spans, "program_report", lambda r=report: r)
        assert reader.read(_ctx(True, busy, tiny_root)) is None


def test_least_work_of_the_cell_is_pinned():
    """The `work` gatedgcn-reddit.train printed on the card (graph seed 0:
    78,789,682 merged entries, 218,663 vertices that send, 218,712 that
    receive) and the least FLOPs, aggregate bytes and gated FLOPs the
    reference counts from it, forward and step, to the FLOP and the
    byte: the yardsticks of `mfu.train` and `gated_roofline.train` in
    that cell."""
    from portbench.lib import counts
    cfg = spec.load_data("configs", "gatedgcn-reddit")
    assert spec.load_module("reference", cfg["model"]).gated_bytes
    flops, agg_bytes = counts.least_work(REF)
    work = {"n": 232965, "entries": 78789682, "src_rows": 218663,
            "dst_rows": 218712, "self_term": 0}
    got = [(flops(cfg["dims"], work, t), agg_bytes(cfg["dims"], work, t),
            REF.gated_flops(cfg["dims"], work, t)) for t in (False, True)]
    assert got == [(657275045020.0, 4611983568.0, 287582339300.0),
                   (1409013821132.0, 10703760816.0, 652851305052.0)]
