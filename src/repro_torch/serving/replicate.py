"""Replicated serving: N pipelined engines over one shared graph store.

One `GNNServingEngine` is single-accelerator by construction; past its
saturation point the only lever left is replication.  `ReplicatedServer`
runs N engines — each with its own batcher, cache and bucket set — over
ONE `SubgraphExtractor`, one feature array and one layer stack: the
CSR, the features and the weights are read-only at serving time, so
replicas share them instead of copying the graph per replica (the
dominant memory term for large graphs).  The engines share the stack's
device, so N replicas on one card interleave their batches there.

Requests are routed by a pluggable balancer:

* ``round_robin``       — cycle through replicas; ignores load.
* ``least_outstanding`` — pick the replica with the fewest queued +
  in-flight vertices; adapts to skewed request sizes.
* ``hub_affinity``      — hash the request's hottest (highest-degree)
  vertex to a replica, falling back to least-outstanding for requests
  touching no pinned hub.  Routes repeat traffic for a hub to the one
  replica whose cache already holds it, trading perfect balance for
  cache hit rate — the DAVC story (S7) applied across replicas.
"""
from __future__ import annotations

import itertools
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np

from repro_torch.graphs.format import COOGraph
from repro_torch.graphs.subgraph import SubgraphExtractor
from repro_torch.serving.batcher import Response
from repro_torch.serving.engine import GNNServingEngine, ServingConfig
from repro_torch.serving.pipeline import EngineFailure, ServingPipeline

# balancer: (pipelines, vertex_ids) -> replica index
Balancer = Callable[[Sequence[ServingPipeline], np.ndarray], int]


def round_robin() -> Balancer:
    counter = itertools.count()

    def pick(pipelines, ids):
        return next(counter) % len(pipelines)
    return pick


def _outstanding(pl: ServingPipeline) -> int:
    return (pl.batcher.pending_vertices()
            + sum(t.batch.ids.size for t in pl.inflight))


def least_outstanding() -> Balancer:
    def pick(pipelines, ids):
        return min(range(len(pipelines)),
                   key=lambda i: _outstanding(pipelines[i]))
    return pick


def hub_affinity(degrees: np.ndarray, pinned: frozenset) -> Balancer:
    """Stick each pinned hub to one replica (by id hash) so its cached
    embedding is probed where it was inserted; non-hub requests go to
    the least-loaded replica."""
    fallback = least_outstanding()

    def pick(pipelines, ids):
        hot = ids[np.argmax(degrees[ids])]
        if int(hot) in pinned:
            return int(hot) % len(pipelines)
        return fallback(pipelines, ids)
    return pick


BALANCERS: Dict[str, Callable] = {
    "round_robin": round_robin,
    "least_outstanding": least_outstanding,
    "hub_affinity": hub_affinity,
}


class ReplicatedServer:
    """N pipelined serving engines over one shared graph store.

    balancer: a `Balancer`, or one of "round_robin" /
    "least_outstanding" / "hub_affinity".
    """

    def __init__(self, graph: COOGraph, x: np.ndarray, layers, params,
                 replicas: int = 2,
                 config: Optional[ServingConfig] = None,
                 balancer="least_outstanding"):
        if replicas < 1:
            raise ValueError(f"replicas must be >= 1, got {replicas}")
        config = config if config is not None else ServingConfig()
        self.graph = graph
        # ONE extractor (and one feature array) shared by every replica:
        # both are read-only at serving time
        self.extractor = SubgraphExtractor(graph)
        self.engines: List[GNNServingEngine] = [
            GNNServingEngine(graph, x, layers, params, config,
                             extractor=self.extractor)
            for _ in range(replicas)]
        self.pipelines: List[ServingPipeline] = [
            ServingPipeline(e) for e in self.engines]
        if isinstance(balancer, str):
            if balancer not in BALANCERS:
                raise ValueError(
                    f"unknown balancer {balancer!r}; expected one of "
                    f"{sorted(BALANCERS)}")
            if balancer == "hub_affinity":
                pinned = frozenset().union(*(
                    e.cache.pinned_ids if e.cache is not None
                    else frozenset() for e in self.engines))
                balancer = hub_affinity(graph.degrees(), pinned)
            else:
                balancer = BALANCERS[balancer]()
        self.balancer: Balancer = balancer
        self.routed = np.zeros(replicas, np.int64)   # requests per replica
        self.alive: List[bool] = [True] * replicas
        self.stats: Dict[str, int] = {"evictions": 0, "requeued": 0}

    # -- API (mirrors the single-engine pipeline) --------------------------
    def submit(self, rid: int, vertex_ids: np.ndarray,
               deadline_s: Optional[float] = None,
               slo_s: Optional[float] = None) -> int:
        """Route and queue one request (alive replicas only); returns
        the replica index."""
        live = [i for i, ok in enumerate(self.alive) if ok]
        if not live:
            raise RuntimeError("no alive replicas (all evicted)")
        ids = np.asarray(vertex_ids, np.int32)
        j = self.balancer([self.pipelines[i] for i in live], ids)
        i = live[j % len(live)]
        self.pipelines[i].submit(rid, ids, deadline_s=deadline_s,
                                 slo_s=slo_s)
        self.routed[i] += 1
        return i

    # -- failure handling --------------------------------------------------
    def evict(self, i: int) -> None:
        """Remove replica `i` from the balancer and requeue its queued +
        in-flight requests onto the survivors.  Raises when no replica
        survives (the requests cannot be served anywhere)."""
        pl = self.pipelines[i]
        if not self.alive[i]:
            return
        self.alive[i] = False
        self.stats["evictions"] += 1
        # collect unique not-yet-answered requests: in-flight tickets
        # first (admission order), then the still-queued tail
        pending = {}
        for t in pl.inflight:
            for r, _k in t.batch.parts:
                if not r.failed and r.rid not in pending:
                    pending[r.rid] = r
        for r in pl.batcher.queue:
            if not r.failed and r.rid not in pending:
                pending[r.rid] = r
        pl.inflight.clear()
        pl.batcher.queue.clear()
        pl.close()
        if not any(self.alive):
            raise RuntimeError(
                f"replica {i} failed and no replicas survive; "
                f"{len(pending)} request(s) dropped")
        for r in pending.values():
            # resubmit the whole request fresh (at-least-once): slices
            # lost with the dead replica are re-extracted by a survivor
            self.submit(r.rid, r.vertex_ids, deadline_s=r.deadline_s)
            self.stats["requeued"] += 1

    def _each_alive(self):
        for i, pl in enumerate(self.pipelines):
            if self.alive[i]:
                yield i, pl

    def pump(self, force: bool = True) -> List[Response]:
        out: List[Response] = []
        for i, pl in self._each_alive():
            try:
                out.extend(pl.pump(force=force))
            except EngineFailure:
                self.evict(i)
        return out

    def poll(self) -> List[Response]:
        out: List[Response] = []
        for i, pl in self._each_alive():
            try:
                out.extend(pl.poll())
            except EngineFailure:
                self.evict(i)
        return out

    def drain(self) -> List[Response]:
        out: List[Response] = []
        progress = True
        while progress:
            progress = False
            for i, pl in self._each_alive():
                if not (pl.batcher.queue or pl.inflight):
                    continue
                progress = True
                try:
                    out.extend(pl.drain())
                except EngineFailure:
                    # evict() moves the dead replica's requests to the
                    # survivors, whose queues the next sweep drains
                    self.evict(i)
        return out

    def telemetry(self) -> Dict:
        return {"replicas": len(self.pipelines),
                "routed": self.routed.tolist(),
                "alive": list(self.alive),
                "evictions": self.stats["evictions"],
                "requeued": self.stats["requeued"],
                "engines": [pl.telemetry() for pl in self.pipelines]}

    def reset_telemetry(self):
        self.routed[:] = 0
        for e in self.engines:
            e.reset_telemetry()
        for pl in self.pipelines:
            pl.reset_telemetry()

    def close(self):
        for pl in self.pipelines:
            pl.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False
