"""Serving on the port (`repro_torch.serving`, `graphs/subgraph.py`,
`CSRGraph`, `zipf_traffic`) against the reference, on the CPU.

The host parts are numpy copies of the reference's, so their outputs are
exactly equal: the CSR, every extracted subgraph (exact and sampled,
typed and untyped), the traffic samples, the cache's rows, pins and
counters, the batcher's admissions, and the engine's budget price,
routes and counters.  Responses run the stack on torch and agree with
the reference's within rtol=1e-4, atol=1e-5 (the reduction order
differs); maxima exactly up to that.  The `cuda`-marked tests run on a
card only and skip here.
"""
import _torch_cpu  # noqa: F401  (this worker's share of the cores)
import numpy as np
import pytest
import torch

import jax

from repro.core import engn as j_engn
from repro.core import models as j_models
from repro.graphs import format as j_format
from repro.graphs import generate as j_generate
from repro.graphs import subgraph as j_subgraph
from repro.serving import batcher as j_batcher
from repro.serving import cache as j_cache
from repro.serving import engine as j_engine
import repro_torch as rt
from repro_torch import kernels as K
from repro_torch.core import engn as t_engn
from repro_torch.core.models import stack_params
from repro_torch.graphs import format as t_format
from repro_torch.graphs import generate as t_generate
from repro_torch.graphs import subgraph as t_subgraph
from repro_torch.graphs.format import COOGraph
from repro_torch.graphs.partition import merge_by_key
from repro_torch.interop import load_reference_params
from repro_torch.serving import (DegreeAwareCache, GNNBatcher,
                                 GNNServingEngine, Request, ServingConfig)

RTOL, ATOL = 1e-4, 1e-5


def _graph(n=300, e=2400, seed=0, relations=1, norm=True):
    """The reference's R-MAT graph (GCN-normalised when `norm`)."""
    g = j_generate.rmat_graph(n, e, seed=seed, num_relations=relations)
    return g.gcn_normalized() if norm else g


def _merged(g):
    """`g` with its multi-edges merged by summation: the tile carriers
    merge them before a max sees them and `segment` does not (ROADMAP
    §C, note 3), so only a merged graph holds a streamed max against a
    resident one."""
    n = g.num_vertices
    key, val = merge_by_key(g.dst.astype(np.int64) * n + g.src, g.weights())
    return j_format.COOGraph(n, (key % n).astype(np.int32),
                             (key // n).astype(np.int32), val)


def _port(g):
    """The same graph as the port's `COOGraph`."""
    return COOGraph(g.num_vertices, g.src, g.dst, g.val, g.rel,
                    g.num_relations)


def _stacks(model, dims, relations=1, seed=0, device="cpu"):
    """The reference stack and its init, and the port's stack carrying
    the same weights."""
    jl = j_models.make_gnn_stack(model, dims, num_relations=relations)
    jp = j_models.init_stack(jl, jax.random.key(seed))
    tl = rt.make_gnn_stack(model, dims, num_relations=relations,
                           device=device)
    load_reference_params(tl, [{k: np.asarray(v) for k, v in p.items()}
                               for p in jp])
    return jl, jp, tl


def _requests(n=12, n_vertices=300, seed=0, hi=50):
    rng = np.random.default_rng(seed)
    return [(i, rng.integers(0, n_vertices,
                             int(rng.integers(1, hi))).astype(np.int32))
            for i in range(n)]


def _serve(eng, reqs):
    for rid, ids in reqs:
        eng.submit(rid, ids)
    return {r.rid: r.outputs for r in eng.drain()}


def _assert_close(got, want):
    assert set(got) == set(want)
    for rid in want:
        np.testing.assert_allclose(got[rid], want[rid], rtol=RTOL, atol=ATOL)


# -- CSR, extraction, traffic: exactly the reference's ---------------------

@pytest.mark.parametrize("relations", [1, 3])
def test_coo_to_csr_equals_reference(relations):
    g = _graph(120, 900, seed=relations, relations=relations,
               norm=relations == 1)
    want = j_format.coo_to_csr(g)
    got = t_format.coo_to_csr(_port(g))
    assert got.num_vertices == want.num_vertices
    assert got.num_relations == want.num_relations
    for f in ("indptr", "indices", "val", "rel"):
        a, b = getattr(got, f), getattr(want, f)
        if b is None:
            assert a is None
            continue
        assert a.dtype == b.dtype and np.array_equal(a, b), f


def _assert_subgraph_eq(got, want):
    assert got.num_seeds == want.num_seeds
    assert np.array_equal(got.vertices, want.vertices)
    assert got.vertices.dtype == want.vertices.dtype
    assert np.array_equal(got.seed_local_ids, want.seed_local_ids)
    a, b = got.graph, want.graph
    assert (a.num_vertices, a.num_relations) == (b.num_vertices,
                                                 b.num_relations)
    for f in ("src", "dst", "val", "rel"):
        x, y = getattr(a, f), getattr(b, f)
        if y is None:
            assert x is None, f
            continue
        assert x.dtype == y.dtype and np.array_equal(x, y), f


@pytest.mark.parametrize("hops", [1, 2, 3])
@pytest.mark.parametrize("fanout", [None, 3])
@pytest.mark.parametrize("relations", [1, 4])
def test_subgraph_equals_reference(hops, fanout, relations):
    """The extractor's subgraph, seeds with duplicates in request order,
    exact and sampled (one `default_rng(seed)` a call), typed and
    untyped, is the reference's array for array."""
    g = _graph(200, 1600, seed=hops, relations=relations,
               norm=relations == 1)
    jx = j_subgraph.SubgraphExtractor(g)
    tx = t_subgraph.SubgraphExtractor(_port(g))
    rng = np.random.default_rng(hops)
    for call in range(3):
        seeds = rng.integers(0, 200, 12).astype(np.int32)
        seeds[5] = seeds[0]                       # a repeated seed
        _assert_subgraph_eq(tx.extract(seeds, hops, fanout, seed=call),
                            jx.extract(seeds, hops, fanout, seed=call))
    _assert_subgraph_eq(t_subgraph.extract_khop(_port(g), [7, 3, 7], hops,
                                                fanout),
                        j_subgraph.extract_khop(g, [7, 3, 7], hops, fanout))


def test_subgraph_of_an_isolated_seed_is_empty():
    g = COOGraph(5, np.array([0, 1], np.int32), np.array([1, 2], np.int32))
    sub = t_subgraph.extract_khop(g, [4], 2)
    jg = j_format.COOGraph(5, g.src, g.dst)
    _assert_subgraph_eq(sub, j_subgraph.extract_khop(jg, [4], 2))
    assert sub.graph.num_edges == 0 and sub.vertices.tolist() == [4]


@pytest.mark.parametrize("a", [1.1, 1.5])
@pytest.mark.parametrize("seed", [0, 3])
def test_zipf_traffic_equals_reference(a, seed):
    deg = _graph().degrees()
    jt = j_generate.zipf_traffic(deg, a=a, seed=seed)
    tt = t_generate.zipf_traffic(deg, a=a, seed=seed)
    for size in (1, 7, 64, 3):
        x, y = tt(size), jt(size)
        assert x.dtype == y.dtype and np.array_equal(x, y)


# -- the cache: one call sequence, the same state --------------------------

def _rows(ids, dim=3):
    ids = np.asarray(ids, np.int64)
    return np.stack([ids * (k + 1) for k in range(dim)], 1).astype(
        np.float32)


def _cache_script(cls):
    """Lookups, inserts, invalidations, a drift probe and two repins;
    returns every mask, output and counter along the way."""
    deg = np.random.default_rng(4).integers(0, 50, 40)
    c = cls(capacity=10, degrees=deg, reserved_frac=0.4)
    trace = [sorted(c.pinned_ids)]
    rng = np.random.default_rng(5)
    for step in range(30):
        ids = rng.integers(0, 40, 6)
        mask, out = c.lookup(ids)
        trace.append((mask.tolist(), None if out is None else out.tolist()))
        c.insert(ids[~mask], _rows(ids[~mask]))
        if step % 7 == 3:
            trace.append(c.invalidate(rng.integers(0, 40, 4)))
        if step % 10 == 9:
            deg = np.random.default_rng(step).integers(0, 50, 40)
            trace.append(c.pin_drift(deg))
            trace.append(c.repin(deg))
            trace.append(sorted(c.pinned_ids))
        trace.append(dict(c.stats))
        trace.append(len(c))
    trace.append(c.hit_rate())
    return trace


def test_cache_sequence_equals_reference():
    assert _cache_script(DegreeAwareCache) == _cache_script(
        j_cache.DegreeAwareCache)


def test_cache_hit_miss_and_eviction():
    deg = np.array([9, 1, 1, 1, 1], np.int64)    # vertex 0 is the hub
    c = DegreeAwareCache(capacity=3, degrees=deg, reserved_frac=0.34)
    assert c.pinned_ids == {0}
    mask, out = c.lookup(np.array([0, 1]))
    assert not mask.any() and out is None        # cold cache
    c.insert(np.array([0, 1, 2]), _rows([0, 1, 2]))
    mask, out = c.lookup(np.array([0, 1, 2, 3]))
    assert mask.tolist() == [True, True, True, False]
    np.testing.assert_allclose(out[1], _rows([1])[0])
    c.insert(np.array([3]), _rows([3]))
    assert c.stats["evictions"] == 1
    mask, _ = c.lookup(np.array([1, 2, 3]))
    assert mask.tolist() == [False, True, True]
    for v in range(10, 30):
        c.insert(np.array([v]), _rows([v]))
    mask, out = c.lookup(np.array([0]))
    assert mask[0] and c.stats["pinned_hits"] >= 1
    c.clear()
    mask, out = c.lookup(np.array([0]))
    assert not mask.any() and out is None


def test_cache_rejects_zero_capacity():
    with pytest.raises(ValueError, match="capacity"):
        DegreeAwareCache(0)


# -- the batcher: the same admissions ---------------------------------------

def _echo_infer(ids):
    return np.stack([ids, ids * 2, ids * 3], axis=1).astype(np.float32)


def _batcher_script(batcher_cls, request_cls, pad):
    """Submissions of mixed sizes (an oversized head, duplicates across
    requests, an empty request), admitted at fixed times with and
    without budget overrides, one batch failed; returns what each
    admission froze and every response."""
    b = batcher_cls(None, batch_size=8, pad=pad)
    rng = np.random.default_rng(2)
    sizes = [19, 3, 0, 5, 8, 1, 12, 2]
    for rid, k in enumerate(sizes):
        b.submit(request_cls(rid, rng.integers(0, 20, k).astype(np.int32),
                             t_submit=0.0))
    trace = []
    now = 1.0
    budgets = [None, 4, 16, None, None, 8, None, None, None]
    for i, budget in enumerate(budgets):
        batch = b.admit(now=now, budget=budget)
        if batch is None:
            break
        trace.append((batch.ids.tolist(), batch.batch_ids.tolist(),
                      batch.inv.tolist(),
                      [(r.rid, k) for r, k in batch.parts]))
        if i == 3:
            res = b.fail(batch, now=now)
        else:
            out = (_echo_infer(batch.batch_ids)[batch.inv] if batch.ids.size
                   else np.zeros((0, 0), np.float32))
            res = b.complete(batch, out, now=now + 0.5)
        trace.append([(r.rid, r.status, r.outputs.tolist(), r.latency_s,
                       r.queue_delay_s) for r in res])
        now += 1.0
    trace.append(dict(b.stats))
    trace.append(b.latency_stats())
    return trace


@pytest.mark.parametrize("pad", [False, True])
def test_batcher_admissions_equal_reference(pad):
    assert (_batcher_script(GNNBatcher, Request, pad)
            == _batcher_script(j_batcher.GNNBatcher, j_batcher.Request, pad))


def test_batcher_single_request():
    b = GNNBatcher(_echo_infer, batch_size=8)
    b.submit(Request(1, np.arange(5, dtype=np.int32)))
    res = b.step()
    assert len(res) == 1 and res[0].rid == 1
    np.testing.assert_allclose(res[0].outputs[:, 0], np.arange(5))
    assert b.stats["padded"] == 3


def test_batcher_oversized_request_split():
    b = GNNBatcher(_echo_infer, batch_size=4)
    ids = np.arange(11, dtype=np.int32)
    b.submit(Request(7, ids))
    assert b.step() == []
    assert b.step() == []
    res = b.step()
    assert len(res) == 1 and res[0].rid == 7
    np.testing.assert_allclose(res[0].outputs[:, 0], ids)
    assert b.stats["batches"] == 3 and b.stats["split_requests"] == 1


def test_batcher_oversized_head_does_not_stall_queue():
    b = GNNBatcher(_echo_infer, batch_size=4)
    b.submit(Request(0, np.arange(10, dtype=np.int32)))
    b.submit(Request(1, np.array([90, 91], np.int32)))
    b.submit(Request(2, np.array([80], np.int32)))
    res = b.drain()
    out = {r.rid: r.outputs for r in res}
    np.testing.assert_allclose(out[0][:, 0], np.arange(10))
    np.testing.assert_allclose(out[1][:, 0], [90, 91])
    np.testing.assert_allclose(out[2][:, 0], [80])
    assert b.stats["batches"] == 4 and not b.queue


def test_batcher_coalesces_overlapping_requests():
    calls = []

    def infer(ids):
        calls.append(np.array(ids))
        return _echo_infer(ids)

    b = GNNBatcher(infer, batch_size=8)
    b.submit(Request(0, np.array([5, 1, 5], np.int32)))
    b.submit(Request(1, np.array([1, 5, 2], np.int32)))
    res = b.step()
    np.testing.assert_allclose(res[0].outputs[:, 0], [5, 1, 5])
    np.testing.assert_allclose(res[1].outputs[:, 0], [1, 5, 2])
    assert b.stats["coalesced"] == 3 and len(calls) == 1


def test_batcher_latency_stats_and_empty_request():
    b = GNNBatcher(_echo_infer, batch_size=4)
    for i in range(6):
        b.submit(Request(i, np.array([i], np.int32)))
    b.submit(Request(6, np.zeros(0, np.int32)))
    res = b.drain()
    assert sorted(r.rid for r in res) == list(range(7))
    assert [r.outputs.shape[0] for r in res if r.rid == 6] == [0]
    ls = b.latency_stats()
    assert ls["count"] == 7 and 0.0 <= ls["p50_s"] <= ls["p99_s"]
    b.reset_stats()
    assert b.latency_stats()["count"] == 0 and b.stats["batches"] == 0


def test_batcher_step_needs_an_infer_fn():
    b = GNNBatcher(None)
    b.submit(Request(0, np.arange(2, dtype=np.int32)))
    with pytest.raises(RuntimeError, match="no infer_fn"):
        b.step()


# -- the engine --------------------------------------------------------------

def _engines(model="gcn", dims=(8, 16, 4), relations=1, graph=None,
             **cfg_kw):
    g = graph if graph is not None else _graph(
        relations=relations, norm=relations == 1)
    x = j_generate.random_features(g.num_vertices, dims[0], seed=1)
    jl, jp, tl = _stacks(model, list(dims), relations)
    jcfg_kw = dict(cfg_kw)
    engn_kw = jcfg_kw.pop("engn", None)
    je = j_engine.GNNServingEngine(
        g, x, jl, jp, j_engine.ServingConfig(
            engn=(j_engn.EnGNConfig(in_dim=0, out_dim=0, **engn_kw)
                  if engn_kw else None), **jcfg_kw))
    te = GNNServingEngine(
        _port(g), x, tl, None, ServingConfig(
            engn=(t_engn.EnGNConfig(in_dim=0, out_dim=0, **engn_kw)
                  if engn_kw else None), **jcfg_kw))
    return g, x, je, te


def _routes(eng, reqs):
    """(footprint, route) of every batch `eng` runs on `reqs`."""
    seen = []
    infer = eng._infer_batch

    def spy(sub, xs):
        before = eng.stats["tiled_batches"]
        y = infer(sub, xs)
        seen.append((eng._subgraph_footprint(sub.graph),
                     "tiled" if eng.stats["tiled_batches"] > before
                     else "resident"))
        return y
    eng._infer_batch = spy
    out = _serve(eng, reqs)
    del eng._infer_batch
    return out, seen


@pytest.mark.parametrize("case", [
    ("gcn", (8, 16, 4), 1, {}),                          # bucketed
    ("gcn", (8, 16, 4), 1, {"bucketing": False}),
    ("gs_pool", (8, 16, 4), 1, {}),                      # max: exact shapes
    ("rgcn", (8, 16, 4), 3, {}),                         # typed, bucketed
    ("gated_gcn", (8, 8, 8), 1, {}),
], ids=["gcn", "gcn_exact", "gs_pool", "rgcn", "gated_gcn"])
def test_engine_equals_reference(case):
    """Responses request for request within the fp32 tolerance; the
    budget price, the route of every batch and every engine counter
    (bucket shapes seen as `compiles`) exactly the reference's."""
    model, dims, relations, kw = case
    slow = model in ("gs_pool", "gated_gcn") or not kw.get("bucketing", 1)
    reqs = _requests(n=4 if slow else 12, hi=30)
    g, x, je, te = _engines(model, dims, relations, batch_size=32, **kw)
    want, jroutes = _routes(je, reqs)
    got, troutes = _routes(te, reqs)
    _assert_close(got, want)
    assert troutes == jroutes
    assert te.stats == je.stats
    assert te.telemetry()["batcher"] == je.telemetry()["batcher"]


def test_typed_padding_counts_only_at_the_dummy_row():
    """R-GCN's in-trace normalisation counts edges per (dst, rel): the
    bucketed path's rel-0 padding edges land at the dummy row only, so
    the padded run equals the exact-shape one and the reference's."""
    g, x, je, te = _engines("rgcn", (8, 16, 4), 3, batch_size=16)
    _, _, _, exact = _engines("rgcn", (8, 16, 4), 3, batch_size=16,
                              bucketing=False)
    reqs = _requests(n=6, hi=20)
    padded = _serve(te, reqs)
    assert te.stats["compiles"] > 0
    _assert_close(padded, _serve(exact, reqs))
    _assert_close(padded, _serve(je, reqs))


def test_engine_matches_full_graph_inference():
    g, x, _, te = _engines(batch_size=32)
    with torch.no_grad():
        full = rt.apply_stack(te.layers, rt.prepare_graph(
            _port(g), te.layers[0].cfg, device="cpu"),
            torch.from_numpy(x)).numpy()
    reqs = _requests(n=25, hi=50)
    got = _serve(te, reqs)
    for rid, ids in reqs:
        np.testing.assert_allclose(got[rid], full[ids], rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("fanout", [2, 4])
def test_engine_sampled_extraction_equals_reference(fanout):
    """Sampled fanout depends on batch composition; on the same traffic
    both packages sample the same subgraphs, so the responses agree."""
    g, x, je, te = _engines(batch_size=16, fanout=fanout)
    reqs = _requests(n=10, hi=30)
    _assert_close(_serve(te, reqs), _serve(je, reqs))
    assert te.stats == je.stats


def test_engine_params_list_runs_those_tensors():
    """params=None runs the layers' own weights; a list of per-layer
    dicts of tensors (the reference's `init_stack` output, or the port's
    `stack_params`) runs through `functional_call` with the same result."""
    g = _port(_graph())
    x = j_generate.random_features(300, 8, seed=1)
    jl, jp, tl = _stacks("gcn", [8, 16, 4])
    reqs = _requests(n=6)
    own = _serve(GNNServingEngine(g, x, tl, None, ServingConfig()), reqs)
    ref_params = [{k: torch.from_numpy(np.array(v)) for k, v in p.items()}
                    for p in jp]
    fresh = rt.make_gnn_stack("gcn", [8, 16, 4], device="cpu", seed=9)
    by_ref = _serve(GNNServingEngine(g, x, fresh, ref_params,
                                     ServingConfig()), reqs)
    by_port = _serve(GNNServingEngine(g, x, fresh, stack_params(tl),
                                      ServingConfig()), reqs)
    for rid in own:
        np.testing.assert_array_equal(by_ref[rid], own[rid])
        np.testing.assert_array_equal(by_port[rid], own[rid])


def test_engine_cache_consistent_and_hits():
    g, x, je, te = _engines(batch_size=32, cache_capacity=128)
    ids = np.array([7, 3, 250, 3], np.int32)
    first = _serve(te, [(0, ids)])[0]
    np.testing.assert_allclose(first, _serve(je, [(0, ids)])[0],
                               rtol=RTOL, atol=ATOL)
    second = _serve(te, [(1, ids)])[1]
    np.testing.assert_array_equal(second, first)
    assert te.cache.stats["hits"] > 0
    assert te.telemetry()["cache"]["hit_rate"] > 0.0


def test_engine_cache_sees_no_padding_probes():
    _, _, _, te = _engines(batch_size=32, cache_capacity=256)
    _serve(te, [(rid, np.arange(1 + rid * 30, 1 + (rid + 1) * 30,
                                dtype=np.int32)) for rid in range(8)])
    assert te.cache.stats["hits"] == 0 and te.cache.hit_rate() == 0.0
    assert te.telemetry()["batcher"]["padded"] == 0


def test_engine_telemetry_reset():
    _, _, _, te = _engines(cache_capacity=64)
    _serve(te, [(0, np.array([1, 2, 3], np.int32))])
    assert te.telemetry()["engine"]["subgraphs"] >= 1
    te.reset_telemetry()
    tel = te.telemetry()
    assert tel["engine"]["subgraphs"] == 0
    assert tel["batcher"]["batches"] == 0 and tel["cache"]["hits"] == 0


# -- the over-budget route --------------------------------------------------

@pytest.mark.parametrize("model", ["gcn", "gs_pool", "rgcn"])
def test_over_budget_batches_stream_like_the_reference(model):
    """A budget under every batch's price sends each batch to the
    streamed executor in both packages; the responses match the
    reference's budgeted engine and the port's unbudgeted one (GS-Pool's
    on a merged graph)."""
    relations = 3 if model == "rgcn" else 1
    graph = _merged(_graph()) if model == "gs_pool" else None
    kw = dict(batch_size=16, tiled_tile=32,
              engn={"device_budget_bytes": 60_000})
    g, x, je, te = _engines(model, (8, 16, 4), relations, graph, **kw)
    _, _, _, roomy = _engines(model, (8, 16, 4), relations, graph,
                              batch_size=16)
    reqs = _requests(n=3, hi=20)
    want, jroutes = _routes(je, reqs)
    got, troutes = _routes(te, reqs)
    assert troutes == jroutes
    assert {r for _, r in troutes} == {"tiled"}
    assert te.stats == je.stats
    assert te.stats["tiled_batches"] == te.batcher.stats["batches"]
    _assert_close(got, want)
    _assert_close(got, _serve(roomy, reqs))


# -- refusals ---------------------------------------------------------------

def test_engine_rejects_non_segment_backend():
    g = _port(_graph(40, 200))
    layers = rt.make_gnn_stack("gcn", [8, 4], backend="blocked", tile=16,
                               device="cpu")
    with pytest.raises(ValueError, match="segment-backend"):
        GNNServingEngine(g, j_generate.random_features(40, 8, 1), layers,
                         None)


def test_engine_rejects_invalid_requests():
    _, _, _, te = _engines()
    with pytest.raises(ValueError, match="empty"):
        te.submit(0, np.array([], np.int32))
    with pytest.raises(ValueError, match=r"\[0, 300\)"):
        te.submit(1, np.array([5, 999], np.int32))
    with pytest.raises(ValueError, match=r"\[0, 300\)"):
        te.submit(2, np.array([-1], np.int32))


def test_engine_rejects_layers_on_two_devices():
    g = _port(_graph())
    layers = rt.make_gnn_stack("gcn", [8, 16, 4], device="cpu")
    layers[1].w = torch.nn.Parameter(layers[1].w.to("meta"))
    with pytest.raises(ValueError, match="one device"):
        GNNServingEngine(g, np.zeros((300, 8), np.float32), layers, None)


def test_ring_gate_serves_over_budget_batches_on_the_ring():
    """With ring_shards set, a batch over the budget whose per-shard ring
    plan fits it is served on the ring, as the reference serves it (no
    batch streams); a batch under the budget serves as usual."""
    _, _, je, te = _engines(batch_size=8, engn={
        "device_budget_bytes": 100_000, "ring_shards": 2})
    reqs = [(0, np.arange(25, dtype=np.int32))]
    want, got = _serve(je, reqs), _serve(te, reqs)
    assert te.stats["ring_batches"] == je.stats["ring_batches"] > 0
    assert te.stats["tiled_batches"] == je.stats["tiled_batches"] == 0
    _assert_close(got, want)
    _, _, _, roomy = _engines(batch_size=8, engn={
        "device_budget_bytes": 10 ** 9, "ring_shards": 2})
    assert _serve(roomy, [(0, np.arange(5, dtype=np.int32))])[0].shape \
        == (5, 4)
    assert roomy.stats["ring_batches"] == 0


def test_ring_gate_skips_a_mixed_stack_as_the_reference_does():
    """A stack mixing aggregation ops has no ring plan in the reference
    either: the batch streams."""
    g = _graph()
    x = j_generate.random_features(300, 8, seed=1)
    layers = [rt.make_gnn("gcn", 8, 16, device="cpu"),
              rt.make_gnn("gs_pool", 16, 4, device="cpu")]
    eng = GNNServingEngine(g, x, layers, None, ServingConfig(
        batch_size=8, tiled_tile=32,
        engn=t_engn.EnGNConfig(in_dim=0, out_dim=0,
                               device_budget_bytes=50_000, ring_shards=2)))
    out = _serve(eng, [(0, np.arange(6, dtype=np.int32))])
    assert out[0].shape == (6, 4) and eng.stats["tiled_batches"] == 1


@pytest.mark.parametrize("spill", ["tiled", "ring"])
def test_a_spilled_max_batch_equals_the_resident_one_on_a_multigraph(spill):
    """GS-Pool on a graph with repeated edges: a batch over the budget,
    streamed or on the ring, aggregates over the distinct edges as the
    resident plans do, so its maxima equal the unbudgeted engine's
    (summed repeats would double some)."""
    g = _port(_graph())
    key = g.dst.astype(np.int64) * g.num_vertices + g.src
    assert np.unique(key).size < g.num_edges
    x = j_generate.random_features(300, 8, seed=1)

    def engine(**engn_kw):
        layers = rt.make_gnn_stack("gs_pool", [8, 16, 4], device="cpu",
                                   seed=0)
        return GNNServingEngine(g, x, layers, None, ServingConfig(
            batch_size=16, tiled_tile=32, engn=(t_engn.EnGNConfig(
                in_dim=0, out_dim=0, **engn_kw) if engn_kw else None)))
    if spill == "ring":
        spilled = engine(device_budget_bytes=100_000, ring_shards=2)
        reqs = [(0, np.arange(25, dtype=np.int32))]
    else:
        spilled = engine(device_budget_bytes=60_000)
        reqs = _requests(n=3, hi=20)
    got, want = _serve(spilled, reqs), _serve(engine(), reqs)
    other = "tiled" if spill == "ring" else "ring"
    assert spilled.stats[f"{spill}_batches"] > 0
    assert spilled.stats[f"{other}_batches"] == 0
    _assert_close(got, want)


# -- on the card ------------------------------------------------------------

def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _port_engines(model, dev, **cfg_kw):
    """The same stack on the card and on the CPU, one seed (GS-Pool's
    graph merged)."""
    g = _port(_merged(_graph()) if model == "gs_pool" else _graph())
    x = j_generate.random_features(300, 8, seed=1)
    cpu = rt.make_gnn_stack(model, [8, 16, 4], device="cpu")
    card = rt.make_gnn_stack(model, [8, 16, 4], device=dev)
    return (GNNServingEngine(g, x, card, None, ServingConfig(**cfg_kw)),
            GNNServingEngine(g, x, cpu, None, ServingConfig(**cfg_kw)))


@pytest.mark.cuda
@pytest.mark.parametrize("model,bucketing", [("gcn", True), ("gcn", False),
                                             ("gs_pool", True)])
def test_engine_on_card_matches_cpu(model, bucketing):
    dev = _card()
    card, cpu = _port_engines(model, dev, batch_size=32, bucketing=bucketing)
    reqs = _requests(n=12)
    _assert_close(_serve(card, reqs), _serve(cpu, reqs))
    assert card.stats == cpu.stats


@pytest.mark.cuda
def test_over_budget_route_on_card_launches_b2_tile_part():
    dev = _card()
    kw = dict(batch_size=16, tiled_tile=32, engn=t_engn.EnGNConfig(
        in_dim=0, out_dim=0, device_budget_bytes=60_000))
    reqs = _requests(n=3, hi=20)
    for model, op in (("gcn", "sum"), ("gs_pool", "max")):
        card, cpu = _port_engines(model, dev, **kw)
        K.reset_launch_counts()
        got = _serve(card, reqs)
        torch.cuda.synchronize()
        assert K.launch_counts()[f"rer_gather_tile_part_{op}"] > 0
        assert card.stats["tiled_batches"] == card.batcher.stats["batches"]
        _assert_close(got, _serve(cpu, reqs))
