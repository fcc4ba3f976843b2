"""Async SLO-driven serving pipeline.

The synchronous engine serves one batch at a time: admit -> probe cache
-> extract L-hop subgraph (host numpy) -> run the stack (device) ->
scatter.  Extraction and inference are *different resources* — CPU
threads walking a CSR versus the card running the layer stack — so
running them in lockstep leaves each idle half the time.  The pipeline
splits them into overlapping stages with a bounded number of in-flight
batches (`pipeline_depth`, default 2: double buffering): while batch k
runs on the device, batch k+1's subgraph is being extracted on a worker
thread.

Stage placement is fixed by thread-safety, not preference: admission,
the cache probe and completion mutate shared state (queue, LRU/DAVC
cache, latency telemetry) and stay on the caller's thread; only
subgraph extraction — pure numpy over the read-only CSR, touching no
tensor — is offloaded to the `ThreadPoolExecutor`.  Every CUDA call
(upload, the layer stack, the read back) is made by `_complete_head`
on the thread that completes batches.  Completion is strictly FIFO so
split requests reassemble their chunks in admission order.

Two further mechanisms ride on the same loop:

* **Deadline admission control.**  Requests may carry an SLO; before
  each admission round the pipeline sheds queued requests whose
  deadline cannot be met, answering them `status="expired"` instead of
  wasting extraction/inference on work nobody will accept.  The ETA
  model is an EWMA of observed per-vertex service time times the queue
  depth ahead of the request (plus everything in flight).

* **Backlog-adaptive admission.**  Under backlog the pipeline merges up
  to `max_batch_factor` batch budgets into one admission ticket.  Hub
  neighbourhoods overlap under power-law traffic, so one large
  extraction deduplicates frontiers that separate batches would each
  walk — fewer CSR sweeps and fewer device dispatches per served
  vertex.  This is the main throughput lever on hosts where extraction
  threads cannot truly run in parallel with the device.
"""
from __future__ import annotations

import time
from collections import deque
from concurrent.futures import Future, ThreadPoolExecutor
from dataclasses import dataclass, field
from typing import Any, Deque, Dict, List, Optional

import numpy as np

from repro_torch.serving.batcher import AdmittedBatch, Request, Response

# EWMA smoothing for the per-vertex service-time estimate: high enough
# to track load shifts within a burst, low enough to ride out the
# per-batch noise of the subgraph sizes
_EWMA_ALPHA = 0.3


class EngineFailure(RuntimeError):
    """The whole engine (device/replica) is unusable — escalate instead
    of mapping to per-request errors.  `ReplicatedServer` catches this
    to evict the replica and requeue its requests; everything else
    raised inside a batch becomes ``Response.status == "error"``."""


@dataclass
class _Ticket:
    """One in-flight batch: the frozen admission record plus the probe
    result and the (possibly async) extraction handle."""
    batch: AdmittedBatch
    ids: np.ndarray
    mask: np.ndarray
    out: Optional[np.ndarray]
    miss: np.ndarray
    t_admit: float
    future: Optional[Future] = None      # pool extraction, else inline:
    extracted: Optional[Any] = field(default=None, repr=False)


class ServingPipeline:
    """Pipelined, deadline-aware front end over a `GNNServingEngine`.

    The engine owns the model, cache and batcher; the pipeline owns the
    overlap structure (in-flight tickets, extraction pool) and the SLO
    machinery.  `engine.step()/drain()` are thin wrappers over a
    depth-1, workerless instance of this class, so the sync and async
    paths share one admission/flush implementation.

    Usage::

        pl = ServingPipeline(engine)
        pl.submit(rid, ids, slo_s=0.05)
        ...
        done += pl.pump()        # shed + admit + dispatch extractions
        done += pl.poll()        # complete every finished batch
        done += pl.drain()       # run everything to completion
    """

    def __init__(self, engine, depth: Optional[int] = None,
                 extract_workers: Optional[int] = None,
                 adaptive_batching: Optional[bool] = None,
                 max_batch_factor: Optional[int] = None,
                 default_slo_s: Optional[float] = None):
        cfg = engine.config
        self.engine = engine
        self.batcher = engine.batcher
        self.depth = max(1, cfg.pipeline_depth if depth is None else depth)
        workers = (cfg.extract_workers if extract_workers is None
                   else extract_workers)
        self.pool = (ThreadPoolExecutor(
            max_workers=workers, thread_name_prefix="engn-extract")
            if workers > 0 else None)
        self.adaptive = (cfg.adaptive_batching if adaptive_batching is None
                         else adaptive_batching)
        self.max_batch_factor = max(1, cfg.max_batch_factor
                                    if max_batch_factor is None
                                    else max_batch_factor)
        self.default_slo_s = (cfg.default_slo_s if default_slo_s is None
                              else default_slo_s)
        self.inflight: Deque[_Ticket] = deque()
        self._ewma_s_per_vertex: Optional[float] = None
        self.stats: Dict[str, int] = {"pumped_batches": 0,
                                      "adaptive_merges": 0,
                                      "inflight_hwm": 0,
                                      "batch_errors": 0}

    # -- submission --------------------------------------------------------
    def submit(self, rid: int, vertex_ids: np.ndarray,
               deadline_s: Optional[float] = None,
               slo_s: Optional[float] = None):
        """Queue a request.  `deadline_s` is absolute (time.monotonic());
        `slo_s` is relative to now.  With neither, the config's
        `default_slo_s` applies (None = never shed)."""
        ids = self.engine._validate(rid, vertex_ids)
        if deadline_s is None:
            slo = slo_s if slo_s is not None else self.default_slo_s
            if slo is not None:
                deadline_s = time.monotonic() + slo
        self.batcher.submit(Request(rid, ids, deadline_s=deadline_s))

    # -- SLO estimate ------------------------------------------------------
    def eta_s(self, vertices_ahead: int) -> float:
        """Estimated seconds until a request behind `vertices_ahead`
        queued vertices completes, counting work already in flight."""
        per_v = self._ewma_s_per_vertex
        if per_v is None:
            return 0.0               # no observations yet: admit everything
        inflight_v = sum(t.batch.ids.size for t in self.inflight)
        return per_v * (vertices_ahead + inflight_v)

    def _observe(self, batch: AdmittedBatch, elapsed_s: float):
        if batch.ids.size == 0:
            return
        per_v = elapsed_s / batch.ids.size
        if self._ewma_s_per_vertex is None:
            self._ewma_s_per_vertex = per_v
        else:
            self._ewma_s_per_vertex += _EWMA_ALPHA * (
                per_v - self._ewma_s_per_vertex)

    # -- the pump: shed + admit + dispatch ---------------------------------
    def pump(self, force: bool = True) -> List[Response]:
        """Fill the pipeline: shed unmeetable requests, then admit
        batches (growing the budget under backlog) and dispatch their
        extractions until `depth` batches are in flight.  Returns the
        expired responses; served responses come from `poll`/`drain`."""
        now = time.monotonic()
        responses = self.batcher.shed_expired(now, self.eta_s)
        while len(self.inflight) < self.depth and self.batcher.queue:
            budget = self.batcher.batch_size
            if self.adaptive:
                backlog = self.batcher.pending_vertices()
                factor = min(self.max_batch_factor,
                             max(1, backlog // self.batcher.batch_size))
                if factor > 1:
                    budget *= factor
                    self.stats["adaptive_merges"] += 1
            batch = self.batcher.admit(now, force=force, budget=budget)
            if batch is None:
                break
            ids, mask, out, miss = self.engine._probe_batch(batch.batch_ids)
            t = _Ticket(batch, ids, mask, out, miss, t_admit=now)
            if miss.size:
                if self.pool is not None:
                    t.future = self.pool.submit(
                        self.engine._extract_batch, miss)
                else:
                    try:
                        t.extracted = self.engine._extract_batch(miss)
                    except EngineFailure:
                        raise
                    except Exception:  # noqa: BLE001 — per-request error
                        self.stats["batch_errors"] += 1
                        responses.extend(self.batcher.fail(batch, now))
                        continue
            self.inflight.append(t)
            self.stats["pumped_batches"] += 1
            self.stats["inflight_hwm"] = max(self.stats["inflight_hwm"],
                                             len(self.inflight))
            now = time.monotonic()
        return responses

    # -- completion (FIFO) -------------------------------------------------
    def _complete_head(self) -> List[Response]:
        t = self.inflight.popleft()
        try:
            if t.miss.size:
                sub, xs = (t.future.result() if t.future is not None
                           else t.extracted)
                y = self.engine._infer_batch(sub, xs)
                out = self.engine._finish_batch(t.ids, t.mask, t.out,
                                                t.miss, y)
            else:
                out = t.out
        except EngineFailure:
            # whole-replica failure: put the ticket back so an evicting
            # ReplicatedServer can requeue its requests, then escalate
            self.inflight.appendleft(t)
            raise
        except Exception:  # noqa: BLE001 — map to status="error"
            self.stats["batch_errors"] += 1
            return self.batcher.fail(t.batch, time.monotonic())
        now = time.monotonic()
        self._observe(t.batch, now - t.t_admit)
        if t.batch.ids.size:
            out = out[t.batch.inv]
        else:
            out = np.zeros((0, 0), np.float32)
        return self.batcher.complete(t.batch, out, now)

    def poll(self) -> List[Response]:
        """Complete every in-flight batch whose extraction has finished
        (head-of-line only past the first unfinished one — completion
        is FIFO so split requests reassemble in order)."""
        responses: List[Response] = []
        while self.inflight:
            head = self.inflight[0]
            if head.future is not None and not head.future.done():
                break
            responses.extend(self._complete_head())
        return responses

    def step(self, force: bool = True) -> List[Response]:
        """One synchronous round: pump, then run the pipeline head to
        completion.  With depth 1 and no workers this is exactly the
        engine's historical `step()`."""
        responses = self.pump(force=force)
        if self.inflight:
            responses.extend(self._complete_head())
        return responses

    def drain(self) -> List[Response]:
        """Serve everything: keep pumping and completing until the queue
        and the pipeline are empty."""
        responses: List[Response] = []
        while self.batcher.queue or self.inflight:
            responses.extend(self.pump(force=True))
            if self.inflight:
                responses.extend(self._complete_head())
        return responses

    def apply_updates(self, snapshot, x_new=None):
        """Apply one epoch of graph updates through the pipeline:
        drain everything in flight first (in-flight batches were
        extracted against the old graph; completing them before the
        swap keeps every response consistent with the graph it was
        admitted under), then delegate to the engine."""
        self.drain()
        return self.engine.apply_updates(snapshot, x_new=x_new)

    # -- telemetry / lifecycle ---------------------------------------------
    def reset_telemetry(self):
        for k in self.stats:
            self.stats[k] = 0
        self._ewma_s_per_vertex = None

    def telemetry(self) -> Dict:
        out = dict(self.engine.telemetry())
        out["pipeline"] = dict(self.stats,
                               inflight=len(self.inflight),
                               ewma_s_per_vertex=self._ewma_s_per_vertex)
        return out

    def close(self):
        if self.pool is not None:
            self.pool.shutdown(wait=True)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False
