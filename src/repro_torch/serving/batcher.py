"""Continuous request batching for GNN inference serving.

Requests ask for the GNN output of a set of vertices.  Unlike the classic
fixed-batch loop (pull whole requests until the next one doesn't fit —
which permanently stalls the queue head whenever a request is larger than
the batch), admission here is *continuous*: every step fills exactly one
`batch_size` budget, slicing the head request if it only partially fits.
A request's response is emitted once all of its slices have been served,
so oversized requests stream through over several steps while small
requests keep riding along in the leftover slots.

Within a batch, vertex ids are coalesced: requests for overlapping
frontiers (hub vertices again — zipf traffic) collapse to one inference
row each, and results are scattered back per request.  The batcher tracks
queue-delay and end-to-end latency percentiles (p50/p99).

The admission and completion halves are exposed separately (`admit` /
`complete`) so the async serving pipeline (serving/pipeline.py) can run
extraction and inference *between* them on different threads; the
synchronous `step()` is exactly `admit -> infer_fn ->
complete` — one flush path, shared by both regimes, so the two can never
diverge on telemetry counting.  Requests may carry an absolute deadline
(`deadline_s`, `time.monotonic()` clock); `shed_expired` removes queued
requests that cannot meet it and answers them with
``Response.status == "expired"`` — the admission-control half of the
SLO story (the ETA model itself lives in the pipeline).

Host numpy, copied from `repro.serving.batcher`: the same submissions
give the same admissions, splits and responses.
"""
from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import Callable, Deque, Dict, List, Optional, Tuple

import numpy as np


@dataclasses.dataclass
class Request:
    rid: int
    vertex_ids: np.ndarray
    t_submit: float = dataclasses.field(default_factory=time.monotonic)
    # absolute completion deadline on the time.monotonic() clock; None
    # means no SLO (never shed)
    deadline_s: Optional[float] = None
    # internal continuous-batching state
    consumed: int = 0                 # ids already admitted to a batch
    delivered: int = 0                # ids whose outputs have arrived
    chunks: List[np.ndarray] = dataclasses.field(default_factory=list)
    t_first_batch: Optional[float] = None
    failed: bool = False              # answered with status="error"


@dataclasses.dataclass
class Response:
    rid: int
    outputs: np.ndarray
    latency_s: float
    queue_delay_s: float = 0.0        # submit -> first batch admission
    # "ok" = served; "expired" = shed by admission control (deadline
    # unmeetable given the queue estimate); "error" = a per-request
    # inference/extraction failure (serving/pipeline.py maps the
    # exception here instead of crashing the stage loop) — outputs is
    # empty for both non-ok statuses
    status: str = "ok"


@dataclasses.dataclass
class AdmittedBatch:
    """One admitted batch budget, frozen at admission time: the raw id
    slices per contributing request plus the coalesced (and optionally
    padded) id vector inference actually runs on.  `complete` scatters
    an output row per raw id via `inv`."""
    ids: np.ndarray                     # raw concatenated new slices
    parts: List[Tuple[Request, int]]    # (request, slice length)
    batch_ids: np.ndarray               # unique ids (+ padding if pad)
    inv: np.ndarray                     # raw position -> unique row
    t_admit: float = 0.0


class GNNBatcher:
    """infer_fn(vertex_ids: (B,) int32) -> (B, out_dim) array.

    `batch_size` is the fixed inference batch (one vertex tile — the
    128-row PE array analogue); `max_wait_s` bounds how long a
    non-full batch may wait for more arrivals when stepping with
    ``force=False``.  `infer_fn` may be None for callers that drive
    `admit`/`complete` themselves (the async pipeline); `step` then
    raises if called.
    """

    def __init__(self, infer_fn: Optional[Callable], batch_size: int = 128,
                 max_wait_s: float = 0.005, coalesce: bool = True,
                 pad: bool = True):
        self.infer_fn = infer_fn
        self.batch_size = batch_size
        self.max_wait_s = max_wait_s
        self.coalesce = coalesce
        # pad=True keeps infer_fn's input shape fixed at batch_size (one
        # compile for simple jitted infer_fns).  Callers that manage
        # shapes themselves (the serving engine buckets subgraph shapes)
        # pass pad=False so padding rows never reach the cache/model.
        self.pad = pad
        self.queue: Deque[Request] = deque()
        self.stats: Dict[str, int] = {"batches": 0, "requests": 0,
                                      "padded": 0, "coalesced": 0,
                                      "split_requests": 0, "shed": 0,
                                      "errors": 0}
        self._latencies: List[float] = []
        self._queue_delays: List[float] = []

    # -- admission ---------------------------------------------------------
    def submit(self, req: Request):
        self.queue.append(req)

    def pending_vertices(self) -> int:
        return sum(r.vertex_ids.size - r.consumed for r in self.queue)

    def _admit(self, now: float, budget: int) -> List[Tuple[Request, int]]:
        """Fill one batch budget, slicing the head request if needed.
        Returns (request, ids taken) for each contributing request."""
        admitted: List[Tuple[Request, int]] = []
        while self.queue and budget > 0:
            r = self.queue[0]
            if r.t_first_batch is None:
                r.t_first_batch = now
                self._queue_delays.append(now - r.t_submit)
            remaining = r.vertex_ids.size - r.consumed
            take = min(remaining, budget)
            if take < remaining and r.consumed == 0:
                self.stats["split_requests"] += 1
            r.consumed += take
            budget -= take
            admitted.append((r, take))
            if r.consumed == r.vertex_ids.size:
                self.queue.popleft()
        return admitted

    def admit(self, now: Optional[float] = None, force: bool = True,
              budget: Optional[int] = None) -> Optional[AdmittedBatch]:
        """Form one batch (or None when empty / still within the batching
        wait).  `budget` overrides `batch_size` for a single admission —
        the pipeline grows it under backlog (adaptive batching) so a deep
        queue drains in fewer, larger subgraph extractions."""
        if not self.queue:
            return None
        now = time.monotonic() if now is None else now
        if (not force and self.pending_vertices() < self.batch_size
                and now - self.queue[0].t_submit < self.max_wait_s):
            return None
        budget = self.batch_size if budget is None else budget
        admitted = self._admit(now, budget)
        # freeze each request's newly-admitted slice now: with batches in
        # flight, `delivered` lags `consumed`, so the slice this batch owns
        # is [consumed - take : consumed), recorded at admission time
        parts: List[Tuple[Request, int]] = list(admitted)
        slices = [r.vertex_ids[r.consumed - k:r.consumed]
                  for r, k in admitted]
        ids = (np.concatenate(slices) if slices
               else np.zeros(0, np.int32))
        if ids.size:
            if self.coalesce:
                uniq, inv = np.unique(ids, return_inverse=True)
                self.stats["coalesced"] += ids.size - uniq.size
            else:
                uniq, inv = ids, np.arange(ids.size)
            pad = self.batch_size - uniq.size if self.pad else 0
            if pad > 0:
                self.stats["padded"] += pad
                batch_ids = np.concatenate([uniq, np.zeros(pad, uniq.dtype)])
            else:
                batch_ids = uniq
            self.stats["batches"] += 1
        else:                      # only empty requests were admitted
            batch_ids = ids
            inv = np.zeros(0, np.int64)
        return AdmittedBatch(ids, parts, batch_ids, inv, t_admit=now)

    # -- completion (the single flush path) --------------------------------
    def complete(self, batch: AdmittedBatch, out: np.ndarray,
                 now: Optional[float] = None) -> List[Response]:
        """Scatter `out` (one row per raw admitted id) back to the
        contributing requests and emit the responses that completed.
        Used by sync `step` and the async pipeline alike."""
        done = time.monotonic() if now is None else now
        responses: List[Response] = []
        off = 0
        for r, k in batch.parts:
            chunk = out[off:off + k]
            off += k
            if r.failed:
                continue        # already answered with status="error"
            r.chunks.append(chunk)
            r.delivered += k
            if r.delivered == r.vertex_ids.size:
                self.stats["requests"] += 1
                lat = done - r.t_submit
                self._latencies.append(lat)
                responses.append(Response(
                    r.rid, np.concatenate(r.chunks), lat,
                    (r.t_first_batch or done) - r.t_submit))
        return responses

    def fail(self, batch: AdmittedBatch, now: Optional[float] = None
             ) -> List[Response]:
        """Answer every request touched by `batch` with
        ``status="error"`` — the per-batch counterpart of `complete`
        for an inference/extraction failure.  A failed request's
        not-yet-admitted remainder is removed from the queue; slices
        already in flight in *other* batches are dropped silently when
        those batches complete."""
        done = time.monotonic() if now is None else now
        responses: List[Response] = []
        for r, _k in batch.parts:
            if r.failed:
                continue
            r.failed = True
            self.stats["errors"] += 1
            if r in self.queue:     # partially-admitted head request
                self.queue.remove(r)
            responses.append(Response(
                r.rid, np.zeros((0, 0), np.float32),
                done - r.t_submit,
                (r.t_first_batch or done) - r.t_submit,
                status="error"))
        return responses

    # -- deadline shedding (admission control) ---------------------------
    def shed_expired(self, now: Optional[float] = None,
                     eta_s: Optional[Callable[[int], float]] = None
                     ) -> List[Response]:
        """Remove queued requests whose deadline cannot be met and answer
        them with ``status="expired"``.  `eta_s(vertices_ahead)` is the
        caller's estimate of seconds until a request behind that many
        queued vertices completes (default 0 — only already-expired
        deadlines shed).  Partially-admitted requests are never shed:
        their earlier slices are already in flight."""
        now = time.monotonic() if now is None else now
        responses: List[Response] = []
        if not any(r.deadline_s is not None for r in self.queue):
            return responses
        kept: Deque[Request] = deque()
        ahead = 0
        for r in self.queue:
            size = r.vertex_ids.size - r.consumed
            if (r.deadline_s is not None and r.consumed == 0
                    and now + (eta_s(ahead + size) if eta_s else 0.0)
                    > r.deadline_s):
                self.stats["shed"] += 1
                responses.append(Response(
                    r.rid, np.zeros((0, 0), np.float32),
                    now - r.t_submit, now - r.t_submit,
                    status="expired"))
                continue
            kept.append(r)
            ahead += size
        self.queue = kept
        return responses

    # -- one serving step --------------------------------------------------
    def step(self, force: bool = True) -> List[Response]:
        """Run one batch; returns the responses that completed.

        With ``force=False`` a non-full batch is held back until the
        oldest request has waited `max_wait_s` (continuous-serving loop);
        the default serves immediately.
        """
        if self.infer_fn is None:
            raise RuntimeError(
                "this batcher has no infer_fn (it is driven through "
                "admit/complete by a serving pipeline); call the "
                "pipeline's pump/drain instead")
        batch = self.admit(force=force)
        if batch is None:
            return []
        if batch.ids.size:
            out = np.asarray(self.infer_fn(batch.batch_ids))[batch.inv]
        else:
            out = np.zeros((0, 0), np.float32)
        return self.complete(batch, out)

    def drain(self) -> List[Response]:
        out: List[Response] = []
        while self.queue:
            out.extend(self.step(force=True))
        return out

    # -- telemetry ---------------------------------------------------------
    def reset_telemetry(self):
        """Zero all counters and latency samples (queue contents are
        kept) — the engine-wide naming; `reset_stats` is the historical
        alias."""
        for k in self.stats:
            self.stats[k] = 0
        self._latencies.clear()
        self._queue_delays.clear()

    # historical name (pre-C12); kept callable forever, same semantics
    reset_stats = reset_telemetry

    def latency_stats(self) -> Dict[str, float]:
        """p50/p99 end-to-end latency and mean queue delay (seconds)."""
        if not self._latencies:
            return {"count": 0, "p50_s": 0.0, "p99_s": 0.0,
                    "mean_queue_delay_s": 0.0}
        lat = np.sort(np.asarray(self._latencies))
        return {
            "count": len(lat),
            "p50_s": float(lat[len(lat) // 2]),
            "p99_s": float(lat[min(int(len(lat) * 0.99), len(lat) - 1)]),
            "mean_queue_delay_s": float(np.mean(self._queue_delays)),
        }
