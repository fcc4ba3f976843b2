"""The port's async serving pipeline, replicas, workload generator and
fault paths (`repro_torch.serving`) on the CPU, against the reference
where both run the same traffic: deadline shedding, bounded in-flight
batches, pipeline against the sync engine, the three balancers, the
traces of every workload shape (exactly the reference's), cache warm
fill, the `ServingConfig` / `EnGNConfig` split, and the non-chaos fault
paths (`GNNBatcher.fail`, the pipeline's mapping of inference and
extraction failures, replica eviction and requeue).  The chaos-driven
fault tests wait for the chaos injector's port (ROADMAP A11): here a
plain wrapper raises on the chosen calls."""
import time

import numpy as np
import pytest

import jax

from repro.core import models as j_models
from repro.graphs import generate as j_generate
from repro.serving import engine as j_engine
from repro.serving import pipeline as j_pipeline
from repro.serving import workload as j_workload
import repro_torch as rt
from repro_torch.core.engn import EnGNConfig
from repro_torch.graphs.format import COOGraph
from repro_torch.interop import load_reference_params
from repro_torch.serving import (GNNBatcher, GNNServingEngine,
                                 ReplicatedServer, Request, ServingConfig,
                                 ServingPipeline, WorkloadSpec, make_trace,
                                 replay_closed, replay_timed)
from repro_torch.serving.pipeline import EngineFailure

RTOL, ATOL = 1e-4, 1e-5


def _echo_infer(ids):
    return np.stack([ids, ids * 2], axis=1).astype(np.float32)


def _graph():
    return j_generate.rmat_graph(300, 2400, seed=0).gcn_normalized()


def _fixture(batch_size=16, cache_capacity=0, **cfg_kw):
    """The port's (graph, x, layers, params, config), with the weights of
    the reference's `init_stack(key 0)`."""
    g = _graph()
    x = j_generate.random_features(300, 8, seed=1)
    jl = j_models.make_gnn_stack("gcn", [8, 16, 4])
    jp = j_models.init_stack(jl, jax.random.key(0))
    layers = rt.make_gnn_stack("gcn", [8, 16, 4], device="cpu")
    load_reference_params(layers, [{k: np.asarray(v) for k, v in p.items()}
                                   for p in jp])
    cfg = ServingConfig(batch_size=batch_size,
                        cache_capacity=cache_capacity, **cfg_kw)
    tg = COOGraph(g.num_vertices, g.src, g.dst, g.val)
    return tg, x, layers, None, cfg


def _reference(cfg_kw, reqs):
    """The reference's pipeline over the same graph, weights and traffic."""
    g = _graph()
    x = j_generate.random_features(300, 8, seed=1)
    jl = j_models.make_gnn_stack("gcn", [8, 16, 4])
    jp = j_models.init_stack(jl, jax.random.key(0))
    pl = j_pipeline.ServingPipeline(j_engine.GNNServingEngine(
        g, x, jl, jp, j_engine.ServingConfig(**cfg_kw)))
    for rid, ids in reqs:
        pl.submit(rid, ids)
    out = {r.rid: r.outputs for r in pl.drain()}
    pl.close()
    return out


def _requests(n=24, n_vertices=300, seed=3):
    rng = np.random.default_rng(seed)
    return [(i, rng.integers(0, n_vertices,
                             rng.integers(1, 9)).astype(np.int32))
            for i in range(n)]


def _assert_close(got, want):
    assert set(got) == set(want)
    for rid in want:
        np.testing.assert_allclose(got[rid], want[rid], rtol=RTOL, atol=ATOL)


class _FailOn:
    """Wraps a stage function so that the given call indices raise."""

    def __init__(self, fn, calls, exc=RuntimeError):
        self.fn, self.calls, self.exc, self.n = fn, set(calls), exc, 0

    def __call__(self, *args, **kwargs):
        i, self.n = self.n, self.n + 1
        if i in self.calls:
            raise self.exc(f"injected failure on call {i}")
        return self.fn(*args, **kwargs)


# -- deadline shedding -------------------------------------------------------

def test_batcher_sheds_expired_requests():
    b = GNNBatcher(_echo_infer, batch_size=8)
    now = time.monotonic()
    b.submit(Request(1, np.arange(3, dtype=np.int32), deadline_s=now - 0.1))
    b.submit(Request(2, np.arange(3, dtype=np.int32), deadline_s=now + 60.0))
    b.submit(Request(3, np.arange(3, dtype=np.int32)))
    shed = b.shed_expired(now)
    assert [r.rid for r in shed] == [1]
    assert shed[0].status == "expired" and shed[0].outputs.size == 0
    assert b.stats["shed"] == 1
    served = b.drain()
    assert sorted(r.rid for r in served) == [2, 3]
    assert all(r.status == "ok" for r in served)


def test_batcher_shed_uses_eta_and_spares_inflight():
    b = GNNBatcher(_echo_infer, batch_size=4)
    now = time.monotonic()
    b.submit(Request(1, np.arange(10, dtype=np.int32), deadline_s=now + 1.0))
    b.step()
    b.submit(Request(2, np.arange(4, dtype=np.int32), deadline_s=now + 1.0))
    shed = b.shed_expired(now, eta_s=lambda ahead: float(ahead))
    assert [r.rid for r in shed] == [2]
    assert [r.rid for r in b.drain()] == [1]


def test_pipeline_sheds_late_request_with_expired_status():
    pl = ServingPipeline(GNNServingEngine(*_fixture()))
    pl.submit(0, np.arange(4, dtype=np.int32))
    pl.drain()                                           # trains the EWMA
    assert pl._ewma_s_per_vertex is not None
    pl.submit(1, np.arange(4, dtype=np.int32),
              deadline_s=time.monotonic() - 1.0)
    shed = pl.pump()
    assert [(r.rid, r.status) for r in shed] == [(1, "expired")]
    assert not any(r.rid == 1 for r in pl.drain())
    pl.close()


def test_pipeline_default_slo_applies_to_submissions():
    g, x, layers, params, _ = _fixture()
    cfg = ServingConfig(batch_size=16, default_slo_s=120.0)
    pl = ServingPipeline(GNNServingEngine(g, x, layers, params, cfg))
    pl.submit(0, np.arange(3, dtype=np.int32))
    assert pl.batcher.queue[0].deadline_s is not None
    pl.submit(1, np.arange(3, dtype=np.int32), deadline_s=None, slo_s=None)
    assert pl.batcher.queue[1].deadline_s is not None
    assert all(r.status == "ok" for r in pl.drain())
    pl.close()


# -- backpressure and equivalence -------------------------------------------

def test_pipeline_bounds_inflight_to_depth():
    g, x, layers, params, _ = _fixture()
    cfg = ServingConfig(batch_size=4, pipeline_depth=2, extract_workers=2,
                        adaptive_batching=False)
    pl = ServingPipeline(GNNServingEngine(g, x, layers, params, cfg))
    for rid, ids in _requests(n=30):
        pl.submit(rid, ids)
    for _ in range(5):
        pl.pump()
        assert len(pl.inflight) <= 2
    assert pl.stats["inflight_hwm"] == 2
    assert len(pl.drain()) == 30
    pl.close()


def test_pipeline_matches_sync_engine_and_reference():
    """The async pipeline (worker threads, adaptive merging) against the
    port's sync loop and against the reference's pipeline on the same
    traffic."""
    g, x, layers, params, cfg = _fixture()
    reqs = _requests()
    sync = GNNServingEngine(g, x, layers, params, cfg)
    for rid, ids in reqs:
        sync.submit(rid, ids)
    want = {r.rid: r.outputs for r in sync.drain()}
    acfg = dict(batch_size=16, pipeline_depth=3, extract_workers=2,
                adaptive_batching=True)
    pl = ServingPipeline(GNNServingEngine(g, x, layers, params,
                                          ServingConfig(**acfg)))
    for rid, ids in reqs:
        pl.submit(rid, ids)
    got = {r.rid: r.outputs for r in pl.drain()}
    pl.close()
    _assert_close(got, want)
    _assert_close(got, _reference(acfg, reqs))


def test_engine_step_drain_are_pipeline_wrappers():
    g, x, layers, params, cfg = _fixture()
    eng = GNNServingEngine(g, x, layers, params, cfg)
    eng.submit(0, np.arange(5, dtype=np.int32))
    res = eng.step()
    assert len(res) == 1 and res[0].status == "ok"
    assert eng._compat is not None
    assert eng._compat.stats["pumped_batches"] == 1
    assert eng._compat.pool is None


# -- replication --------------------------------------------------------------

def test_replicated_round_robin_balances_evenly():
    g, x, layers, params, cfg = _fixture()
    srv = ReplicatedServer(g, x, layers, params, replicas=3, config=cfg,
                           balancer="round_robin")
    reqs = _requests(n=30)
    for rid, ids in reqs:
        srv.submit(rid, ids)
    assert srv.routed.tolist() == [10, 10, 10]
    assert sorted(r.rid for r in srv.drain()) == sorted(r for r, _ in reqs)
    srv.close()


def test_replicated_least_outstanding_tracks_load():
    g, x, layers, params, cfg = _fixture()
    srv = ReplicatedServer(g, x, layers, params, replicas=2, config=cfg,
                           balancer="least_outstanding")
    srv.pipelines[0].submit(999, np.arange(64, dtype=np.int32))
    for rid, ids in _requests(n=8):
        srv.submit(rid, ids)
    assert srv.routed[1] > srv.routed[0]
    srv.drain()
    srv.close()


def test_replicated_hub_affinity_pins_hub_to_one_replica():
    g, x, layers, params, _ = _fixture()
    cfg = ServingConfig(batch_size=16, cache_capacity=64)
    srv = ReplicatedServer(g, x, layers, params, replicas=2, config=cfg,
                           balancer="hub_affinity")
    hub = int(np.argmax(g.degrees()))
    assert hub in srv.engines[0].cache.pinned_ids
    picks = {srv.submit(100 + i, np.array([hub], np.int32))
             for i in range(6)}
    assert len(picks) == 1
    srv.drain()
    srv.close()


def test_replicated_server_shares_one_store_and_stack():
    g, x, layers, params, cfg = _fixture()
    srv = ReplicatedServer(g, x, layers, params, replicas=2, config=cfg)
    a, b = srv.engines
    assert a.extractor is b.extractor is srv.extractor
    assert a.layers is b.layers and a.device == b.device
    with pytest.raises(ValueError, match="unknown balancer"):
        ReplicatedServer(g, x, layers, params, balancer="nope")
    with pytest.raises(ValueError, match="replicas"):
        ReplicatedServer(g, x, layers, params, replicas=0)
    srv.close()


def test_replicated_outputs_match_single_engine():
    g, x, layers, params, cfg = _fixture()
    reqs = _requests(n=12)
    single = GNNServingEngine(g, x, layers, params, cfg)
    for rid, ids in reqs:
        single.submit(rid, ids)
    want = {r.rid: r.outputs for r in single.drain()}
    srv = ReplicatedServer(g, x, layers, params, replicas=2, config=cfg)
    for rid, ids in reqs:
        srv.submit(rid, ids)
    got = {r.rid: r.outputs for r in srv.drain()}
    srv.close()
    _assert_close(got, want)


# -- the workload generator ---------------------------------------------------

@pytest.mark.parametrize("shape", ["constant", "diurnal", "flash_crowd",
                                   "hub_storm"])
@pytest.mark.parametrize("skew", ["zipf", "uniform"])
def test_trace_equals_reference(shape, skew):
    """Every shape and skew: the reference's arrival times, ids and SLOs,
    request for request, and deterministic in the seed."""
    deg = _graph().degrees()
    kw = dict(n_requests=60, duration_s=2.0, shape=shape, skew=skew,
              mean_size=5, slo_s=0.5, seed=7)
    got = make_trace(WorkloadSpec(**kw), deg)
    again = make_trace(WorkloadSpec(**kw), deg)
    want = j_workload.make_trace(j_workload.WorkloadSpec(**kw), deg)
    assert len(got) == len(want) == 60
    for a, b, c in zip(got, want, again):
        assert (a.rid, a.t_offset_s, a.slo_s) == (b.rid, b.t_offset_s,
                                                  b.slo_s)
        assert a.vertex_ids.dtype == b.vertex_ids.dtype
        assert np.array_equal(a.vertex_ids, b.vertex_ids)
        assert np.array_equal(a.vertex_ids, c.vertex_ids)


def test_workload_spec_rejects_unknown_shape_and_skew():
    with pytest.raises(ValueError, match="shape"):
        WorkloadSpec(shape="spiky")
    with pytest.raises(ValueError, match="skew"):
        WorkloadSpec(skew="pareto")


def test_workload_flash_crowd_spikes_the_middle():
    spec = WorkloadSpec(n_requests=400, duration_s=10.0,
                        shape="flash_crowd", burst_factor=6.0,
                        burst_frac=0.2, seed=1)
    t = np.array([r.t_offset_s for r in make_trace(spec, _graph().degrees())])
    assert ((t >= 4.0) & (t <= 6.0)).sum() / t.size > 0.4
    assert t.min() >= 0.0 and t.max() <= 10.0


def test_workload_hub_storm_targets_hubs_in_burst_window():
    deg = _graph().degrees()
    trace = make_trace(WorkloadSpec(n_requests=200, duration_s=10.0,
                                    shape="hub_storm", storm_hubs=8,
                                    seed=2), deg)
    hubs = set(np.argsort(-deg, kind="stable")[:8].tolist())
    burst = [r for r in trace if 4.0 <= r.t_offset_s <= 6.0]
    assert burst
    for r in burst:
        assert set(r.vertex_ids.tolist()) <= hubs


def test_workload_replay_closed_serves_everything():
    g, x, layers, params, cfg = _fixture(cache_capacity=64)
    pl = ServingPipeline(GNNServingEngine(g, x, layers, params, cfg))
    spec = WorkloadSpec(n_requests=40, duration_s=0.5, shape="diurnal",
                        seed=4)
    res = replay_closed(pl, make_trace(spec, g.degrees()), pump_every=4)
    assert sorted(r.rid for r in res if r.status == "ok") == list(range(40))
    pl.close()


def test_replay_timed_honours_arrivals():
    g, x, layers, params, cfg = _fixture()
    clock = iter(np.arange(0.0, 100.0, 0.01))
    pl = ServingPipeline(GNNServingEngine(g, x, layers, params, cfg))
    trace = make_trace(WorkloadSpec(n_requests=10, duration_s=0.2, seed=3),
                       g.degrees())
    res = replay_timed(pl, trace, now_fn=lambda: float(next(clock)))
    assert sorted(r.rid for r in res) == list(range(10))
    pl.close()


# -- cache warm fill ----------------------------------------------------------

def test_warm_fill_precomputes_pinned_hubs():
    g, x, layers, params, _ = _fixture()
    cfg = ServingConfig(batch_size=16, cache_capacity=64, warm_cache=True,
                        warm_cache_max=16)
    eng = GNNServingEngine(g, x, layers, params, cfg)
    assert eng.stats["warm_filled"] == 16
    eng.reset_telemetry()
    eng.submit(0, np.array([int(np.argmax(g.degrees()))], np.int32))
    assert len(eng.drain()) == 1
    assert eng.stats["subgraphs"] == 0
    assert eng.cache.stats["pinned_hits"] == 1


def test_warm_fill_matches_cold_inference():
    g, x, layers, params, _ = _fixture()
    cold = GNNServingEngine(g, x, layers, params,
                            ServingConfig(batch_size=16))
    warm = GNNServingEngine(
        g, x, layers, params,
        ServingConfig(batch_size=16, cache_capacity=64, warm_cache=True,
                      warm_cache_max=8))
    hubs = np.argsort(-g.degrees(), kind="stable")[:4].astype(np.int32)
    cold.submit(0, hubs)
    warm.submit(0, hubs)
    np.testing.assert_allclose(warm.drain()[0].outputs,
                               cold.drain()[0].outputs, rtol=RTOL, atol=ATOL)


# -- the config split ---------------------------------------------------------

def test_serving_config_embeds_engn_config():
    cfg = ServingConfig(engn=EnGNConfig(in_dim=0, out_dim=0,
                                        device_budget_bytes=123,
                                        ring_shards=2,
                                        streaming_mode="callback",
                                        tile_value_dtype="int8"))
    assert cfg.engn.device_budget_bytes == 123
    assert cfg.engn.ring_shards == 2
    assert cfg.engn.streaming_mode == "callback"
    assert cfg.engn.tile_value_dtype == "int8"
    assert ServingConfig().engn.backend == "segment"


@pytest.mark.parametrize("kw", ["device_budget_bytes", "ring_shards",
                                "tiled_streaming_mode", "tiled_value_dtype"])
def test_serving_config_has_no_mirror_fields(kw):
    with pytest.raises(TypeError):
        ServingConfig(**{kw: 1})
    assert not hasattr(ServingConfig(), kw)


def test_reset_telemetry_alias_is_consistent():
    b = GNNBatcher(_echo_infer, batch_size=4)
    b.submit(Request(0, np.arange(3, dtype=np.int32)))
    b.drain()
    assert b.stats["requests"] == 1
    b.reset_telemetry()
    assert b.stats["requests"] == 0
    b.submit(Request(1, np.arange(3, dtype=np.int32)))
    b.drain()
    b.reset_stats()
    assert b.stats["requests"] == 0


# -- faults (the non-chaos tests of tests/test_serving_fault.py) --------------

def test_batcher_fail_answers_with_error_status():
    b = GNNBatcher(None, batch_size=8)
    b.submit(Request(1, np.arange(3, dtype=np.int32)))
    b.submit(Request(2, np.arange(4, dtype=np.int32)))
    batch = b.admit()
    errs = b.fail(batch)
    assert sorted(r.rid for r in errs) == [1, 2]
    assert all(r.status == "error" and r.outputs.size == 0 for r in errs)
    assert b.stats["errors"] == 2 and not b.queue
    assert b.fail(batch) == []


def test_batcher_fail_removes_split_request_remainder():
    b = GNNBatcher(None, batch_size=4)
    b.submit(Request(7, np.arange(10, dtype=np.int32)))
    first = b.admit()
    second = b.admit()
    assert [r.rid for r in b.fail(second)] == [7]
    assert not b.queue
    assert b.complete(first, np.zeros((first.ids.size, 2), np.float32)) == []


def test_pipeline_maps_inference_failure_to_error_response():
    pl = ServingPipeline(GNNServingEngine(*_fixture()))
    pl.engine._infer_batch = _FailOn(pl.engine._infer_batch, calls=(1,))
    for rid, ids in _requests(12):
        pl.submit(rid, ids)
    responses = pl.drain()
    pl.close()
    statuses = [r.status for r in responses]
    assert "error" in statuses and "ok" in statuses
    assert len(responses) == 12 and pl.stats["batch_errors"] >= 1


@pytest.mark.parametrize("workers", [0, 2])
def test_pipeline_maps_extraction_failure_to_error_response(workers):
    """Inline, the extraction raises at admission; with worker threads it
    surfaces from the future at completion: the same mapping."""
    g, x, layers, params, cfg = _fixture(extract_workers=workers)
    pl = ServingPipeline(GNNServingEngine(g, x, layers, params, cfg))
    pl.engine._extract_batch = _FailOn(pl.engine._extract_batch, calls=(0,))
    for rid, ids in _requests(8):
        pl.submit(rid, ids)
    responses = pl.drain()
    pl.close()
    statuses = {r.status for r in responses}
    assert statuses == {"error", "ok"} and len(responses) == 8


def test_engine_failure_escalates_out_of_pipeline():
    pl = ServingPipeline(GNNServingEngine(*_fixture()))
    pl.engine._infer_batch = _FailOn(pl.engine._infer_batch,
                                     calls=range(100), exc=EngineFailure)
    for rid, ids in _requests(4):
        pl.submit(rid, ids)
    with pytest.raises(EngineFailure):
        pl.drain()
    assert pl.inflight                  # the ticket went back
    pl.close()


def _replicated(replicas=2, **cfg_kw):
    g, x, layers, params, cfg = _fixture(**cfg_kw)
    return ReplicatedServer(g, x, layers, params, replicas=replicas,
                            config=cfg, balancer="round_robin")


def _dead(*a, **k):
    raise EngineFailure("replica died")


def test_replicated_server_evicts_and_requeues():
    srv = _replicated(replicas=2)
    srv.engines[0]._infer_batch = _dead
    reqs = _requests(10)
    for rid, ids in reqs:
        srv.submit(rid, ids)
    assert int(srv.routed[0]) > 0
    responses = srv.drain()
    srv.close()
    assert {r.rid for r in responses if r.status == "ok"} == {
        rid for rid, _ in reqs}
    tele = srv.telemetry()
    assert tele["alive"] == [False, True]
    assert tele["evictions"] == 1 and tele["requeued"] > 0


def test_evicted_replica_receives_no_traffic():
    srv = _replicated(replicas=3)
    srv.engines[1]._infer_batch = _dead
    for rid, ids in _requests(9):
        srv.submit(rid, ids)
    srv.drain()
    routed_before = srv.routed.copy()
    for rid, ids in _requests(9, seed=5):
        srv.submit(1000 + rid, ids)
    assert srv.routed[1] == routed_before[1]
    responses = srv.drain()
    srv.close()
    assert all(r.status == "ok" for r in responses)


def test_all_replicas_evicted_raises():
    srv = _replicated(replicas=2)
    for e in srv.engines:
        e._infer_batch = _dead
    for rid, ids in _requests(4):
        srv.submit(rid, ids)
    with pytest.raises(RuntimeError, match="no replicas survive"):
        srv.drain()
    srv.close()
    with pytest.raises(RuntimeError, match="no alive replicas"):
        srv.submit(99, np.arange(3, dtype=np.int32))
