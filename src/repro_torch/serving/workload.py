"""Serving workload generator.

A flat stream of zipf-targeted requests has the right *vertex* skew
(hubs are hot, S3.2) but the wrong *arrival* shape: production request
rates breathe.  This
module generates timed request traces with both dimensions controlled:

target skew
    "zipf"      degree-rank-aligned Zipf targets (hubs hottest)
    "uniform"   uniform random targets (cache-hostile control)

arrival shape
    "constant"     Poisson arrivals at a fixed rate
    "diurnal"      one sinusoidal day compressed into `duration_s`:
                   rate swings rate*(1 ± diurnal_amp)
    "flash_crowd"  constant base rate with a `burst_factor`x rate spike
                   over the middle `burst_frac` of the trace
    "hub_storm"    flash crowd where the spike's requests additionally
                   all target the top `storm_hubs` hubs — the worst
                   case for a shared cache and the best case for the
                   DAVC pinned region and hub-affinity routing

A trace is a list of `TimedRequest` (arrival offset, vertex ids,
optional SLO) and is deterministic in `seed`, so benchmarks and tests
replay identical traffic across engines.  Two replay helpers cover the
two measurement regimes: `replay_closed` (drain as fast as possible —
throughput) and `replay_timed` (honour arrival times against the wall
clock — latency under load).  A seed gives `repro.serving.workload`'s
trace, request for request.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, List, Optional

import numpy as np

from repro_torch.graphs.generate import zipf_traffic

SHAPES = ("constant", "diurnal", "flash_crowd", "hub_storm")
SKEWS = ("zipf", "uniform")


@dataclasses.dataclass
class TimedRequest:
    rid: int
    t_offset_s: float                 # arrival, seconds from trace start
    vertex_ids: np.ndarray
    slo_s: Optional[float] = None     # relative deadline, None = no SLO


@dataclasses.dataclass
class WorkloadSpec:
    n_requests: int = 256
    duration_s: float = 1.0           # trace length (arrival window)
    mean_size: int = 4                # vertices per request (geometric)
    skew: str = "zipf"
    zipf_a: float = 1.1
    shape: str = "constant"
    diurnal_amp: float = 0.8          # diurnal: rate*(1 ± amp)
    burst_factor: float = 4.0         # flash crowd: spike rate multiplier
    burst_frac: float = 0.2           # fraction of duration spiked
    storm_hubs: int = 16              # hub_storm: spike target pool
    slo_s: Optional[float] = None     # attach this SLO to every request
    seed: int = 0

    def __post_init__(self):
        if self.shape not in SHAPES:
            raise ValueError(f"unknown shape {self.shape!r}; "
                             f"expected one of {SHAPES}")
        if self.skew not in SKEWS:
            raise ValueError(f"unknown skew {self.skew!r}; "
                             f"expected one of {SKEWS}")


def _arrival_times(spec: WorkloadSpec, rng) -> np.ndarray:
    """Inverse-transform sampling of `n_requests` arrivals under the
    shape's rate profile, scaled to fill `duration_s`."""
    n, d = spec.n_requests, spec.duration_s
    grid = np.linspace(0.0, d, 1024)
    if spec.shape == "constant":
        rate = np.ones_like(grid)
    elif spec.shape == "diurnal":
        rate = 1.0 + spec.diurnal_amp * np.sin(
            2 * np.pi * grid / max(d, 1e-9) - np.pi / 2)
    else:                              # flash_crowd / hub_storm
        rate = np.ones_like(grid)
        lo = d * (0.5 - spec.burst_frac / 2)
        hi = d * (0.5 + spec.burst_frac / 2)
        rate[(grid >= lo) & (grid <= hi)] = spec.burst_factor
    cdf = np.cumsum(rate)
    cdf /= cdf[-1]
    # jittered stratified samples keep the trace deterministic and the
    # arrival density proportional to the rate profile
    u = (np.arange(n) + rng.random(n)) / n
    return np.interp(u, cdf, grid)


def make_trace(spec: WorkloadSpec, degrees: np.ndarray
               ) -> List[TimedRequest]:
    """Generate the timed request trace for a graph with the given
    degree profile.  Deterministic in `spec.seed`."""
    degrees = np.asarray(degrees)
    rng = np.random.default_rng(spec.seed)
    times = _arrival_times(spec, rng)
    sizes = np.maximum(1, rng.geometric(
        1.0 / max(spec.mean_size, 1), spec.n_requests))
    if spec.skew == "zipf":
        sample = zipf_traffic(degrees, a=spec.zipf_a, seed=spec.seed)
    else:
        def sample(size):
            return rng.integers(0, degrees.size, size).astype(np.int32)
    hubs = None
    if spec.shape == "hub_storm":
        order = np.argsort(-degrees, kind="stable")
        hubs = order[:max(1, spec.storm_hubs)].astype(np.int32)
        lo = spec.duration_s * (0.5 - spec.burst_frac / 2)
        hi = spec.duration_s * (0.5 + spec.burst_frac / 2)
    trace: List[TimedRequest] = []
    for rid in range(spec.n_requests):
        k = int(sizes[rid])
        if (hubs is not None and lo <= times[rid] <= hi):
            ids = hubs[rng.integers(0, hubs.size, k)]
        else:
            ids = sample(k)
        trace.append(TimedRequest(rid, float(times[rid]),
                                  np.asarray(ids, np.int32),
                                  slo_s=spec.slo_s))
    return trace


# -- replay ----------------------------------------------------------------
def replay_closed(server, trace: List[TimedRequest], pump_every: int = 1):
    """Closed-loop replay: submit everything (ignoring arrival times,
    pumping the pipeline as the queue builds), then drain.  Measures
    peak throughput.  `server` is a ServingPipeline, ReplicatedServer,
    or anything with submit/pump/drain."""
    responses = []
    for i, r in enumerate(trace):
        server.submit(r.rid, r.vertex_ids, slo_s=r.slo_s)
        if pump_every and (i + 1) % pump_every == 0:
            responses.extend(server.pump())
            responses.extend(server.poll())
    responses.extend(server.drain())
    return responses


def replay_timed(server, trace: List[TimedRequest],
                 now_fn: Callable[[], float] = time.monotonic):
    """Open-loop replay: honour each request's arrival offset against
    the wall clock, pumping/polling while waiting.  Measures latency
    (and shedding) under the trace's load shape."""
    responses = []
    t0 = now_fn()
    for r in trace:
        while now_fn() - t0 < r.t_offset_s:
            responses.extend(server.pump())
            responses.extend(server.poll())
        server.submit(r.rid, r.vertex_ids, slo_s=r.slo_s)
    responses.extend(server.drain())
    return responses
