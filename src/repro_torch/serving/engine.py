"""End-to-end GNN serving engine on the port.

Ties the serving stack together: requests enter the continuous
`GNNBatcher`; each batch probes the `DegreeAwareCache` for already-served
vertices; cache misses are answered by extracting the L-hop
in-neighbourhood of the miss set (`graphs/subgraph.py`) and running the
full multi-layer EnGN stack over just that subgraph on the stack's
device — true per-request GNN inference rather than a row lookup into a
precomputed table.

Per-batch subgraphs have data-dependent shapes.  The engine pads both
to power-of-two buckets (padding edges carry weight 0 and point at a
padded dummy vertex, so sum-aggregation is unaffected) with best-fit
reuse of a bucket already seen, exactly as `repro.serving.engine` does,
so padded shapes, the budget gate's price and the telemetry are the
reference's.  The port runs the stack eagerly (no compile, no CUDA
graph), so `stats["compiles"]` counts the bucket shapes seen for the
first time, where the reference compiles one program each.  Bucketing is
only applied when every layer uses sum aggregation; other ops run the
exact subgraph.

Host and device.  The graph, its CSR and the feature matrix stay on the
host, as in the reference: a batch gathers its subgraph's feature rows
on the host and uploads the padded (src, dst, val[, rel]) edge list and
the features once, runs the stack, and reads the seeds' rows back once.
That read is the batch's only synchronisation.  No full feature table is
held on the device, so the budget gate prices only what a batch holds.

The model stack must use the "segment" aggregation backend: the engine
feeds each layer a per-batch edge-list graph dict, and segment is the
backend that consumes (src, dst, val) directly.  Relation-typed graphs
are first-class: the extractor carries per-edge `rel` through the CSR
and into each subgraph, so R-GCN / Gated-GCN stacks serve and spill to
the streamed tiled executor like the untyped models.

Out-of-core guard: with `device_budget_bytes` set, a batch whose L-hop
subgraph would not fit on the device (hub seeds can pull in a large
fraction of the graph) is executed through the streamed tiled executor
instead — same results, bounded device footprint, counted in
`stats["tiled_batches"]`.  On a card its packed chunks run B2's tile
part (`rer_gather_part_launch`).

Shard-aware gate: with `ring_shards` set, an over-budget batch whose
per-shard ring plan fits the budget (the budget is per shard) runs on
the sharded ring backend instead of host streaming, counted in
`stats["ring_batches"]`; a stack mixing aggregation ops or stage
contracts skips the ring.  The ring's shards are co-located on the
engine's device, where the reference, short of devices, would stream.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch.core.engn import EnGNConfig, fold_rel_norm, max_plan_edges
from repro_torch.core.models import apply_stack
from repro_torch.core.tiled import TiledExecutor, dense_footprint_bytes
from repro_torch.graphs.format import COOGraph
from repro_torch.graphs.subgraph import SubgraphExtractor
from repro_torch.serving.batcher import GNNBatcher, Request, Response
from repro_torch.serving.cache import DegreeAwareCache


@dataclasses.dataclass
class ServingConfig:
    """Serving-loop knobs, with the *execution* knobs under an embedded
    `EnGNConfig` (`device_budget_bytes`, `ring_shards`, `streaming_mode`,
    `tile_value_dtype`), field for field the reference's."""

    batch_size: int = 128
    max_wait_s: float = 0.005
    num_hops: Optional[int] = None    # default: one hop per model layer
    fanout: Optional[int] = None      # per-hop neighbour sampling cap
    cache_capacity: int = 0           # 0 disables the result cache
    cache_reserved_frac: float = 0.5  # DAVC reserved-line fraction
    coalesce: bool = True
    bucketing: bool = True            # pad subgraphs to pow2 shape buckets
    # the embedded execution config: budget gate, ring shards, tiled
    # streaming regime and value quantisation all resolve from here
    engn: Optional[EnGNConfig] = None
    tiled_tile: int = 128             # interval size for tiled fallback
    ring_tile: int = 32               # tile size for per-batch ring plans
    # -- async pipeline (serving/pipeline.py) -----------------------------
    pipeline_depth: int = 2           # in-flight batches (double buffer)
    extract_workers: int = 2          # subgraph-extraction thread pool
    # under backlog, merge up to max_batch_factor batch budgets into one
    # admission ticket: fewer, larger extractions with cross-request
    # frontier dedup (hub neighbourhoods overlap under zipf traffic)
    adaptive_batching: bool = True
    max_batch_factor: int = 8
    # default SLO applied to requests submitted without a deadline
    # (None = no deadline; requests are never shed)
    default_slo_s: Optional[float] = None
    # speculatively precompute the pinned hub region of the cache at
    # startup from the DAVC degree profile (engine.warm_fill)
    warm_cache: bool = False
    warm_cache_max: int = 512         # cap on hub vertices warm-filled
    # -- dynamic graphs ---------------------------------------------------
    # after `apply_updates`, recompute the cache's pinned hub set when
    # more than this fraction of it lost top-degree status (and re-run
    # the warm fill if warm_cache is set); <=0 repins on every epoch
    hub_drift_threshold: float = 0.25

    def __post_init__(self):
        if self.engn is None:
            # dims are per-model and unused at the config-carrier level;
            # the engine reads them from its layer stack
            self.engn = EnGNConfig(in_dim=0, out_dim=0, backend="segment")


def _affected_vertices(old_graph: COOGraph, new_graph: COOGraph,
                       touched_dst: np.ndarray, num_hops: int
                       ) -> np.ndarray:
    """Vertices whose L-hop in-neighbourhood a graph delta reached: the
    forward closure of the changed edges' destinations, up to
    (num_hops - 1) hops, over the union of old and new edges (an edge
    present on either side can carry staleness).  O(hops * E) boolean
    masking — no adjacency index is built."""
    n = max(old_graph.num_vertices, new_graph.num_vertices)
    affected = np.zeros(n, bool)
    affected[touched_dst] = True
    srcs = np.concatenate([old_graph.src, new_graph.src])
    dsts = np.concatenate([old_graph.dst, new_graph.dst])
    for _ in range(max(num_hops - 1, 0)):
        grown = affected.copy()
        grown[dsts[affected[srcs]]] = True
        if np.array_equal(grown, affected):
            break
        affected = grown
    return np.nonzero(affected)[0].astype(np.int32)


def _next_pow2(n: int) -> int:
    return 1 << max(int(n) - 1, 0).bit_length()


class GNNServingEngine:
    """Serve vertex-embedding requests over a (normalised) graph.

    graph:  the full COOGraph, already normalised for the model (e.g.
            `gcn_normalized()` for GCN stacks).
    x:      (N, F) input features (host array; rows are gathered per
            subgraph).
    layers: an EnGN stack from `core.models.make_gnn_stack`, segment
            backend; the engine runs on its device.
    params: None runs the layers' own parameters; a list of per-layer
            dicts of tensors (the reference's `init_stack` layout, as
            `core.models.stack_params` gives it) runs the layers on those
            through `apply_stack(params=...)`.
    """

    def __init__(self, graph: COOGraph, x: np.ndarray, layers, params,
                 config: Optional[ServingConfig] = None,
                 extractor: Optional[SubgraphExtractor] = None):
        config = config if config is not None else ServingConfig()
        bad = [ly.name for ly in layers if ly.cfg.backend != "segment"]
        if bad:
            raise ValueError(
                f"serving requires segment-backend layers, got non-segment "
                f"backend on {bad} (the engine feeds per-batch edge-list "
                f"graph dicts that only the segment backend consumes)")
        devices = {ly.device for ly in layers}
        if len(devices) != 1:
            raise ValueError(f"the layers live on {sorted(map(str, devices))}"
                             f"; the engine serves from one device")
        self.device = devices.pop()
        self.graph = graph
        self.x = np.asarray(x)
        self.layers = layers
        self.params = (None if params is None else
                       [{k: v.to(self.device) for k, v in p.items()}
                        for p in params])
        self.config = config
        self.num_hops = config.num_hops or len(layers)
        # `extractor` may be shared across engines (ReplicatedServer runs
        # N engines over one graph store); extraction is read-only numpy
        # over the CSR, so sharing is thread-safe
        self.extractor = extractor or SubgraphExtractor(graph)
        self.cache: Optional[DegreeAwareCache] = None
        if config.cache_capacity > 0:
            self.cache = DegreeAwareCache(
                config.cache_capacity, graph.degrees(),
                config.cache_reserved_frac)
        # pad=False: the engine buckets subgraph shapes itself, and
        # padding ids must not reach the cache (phantom probes of a real
        # vertex would inflate the hit rate and trigger spurious work)
        self.batcher = GNNBatcher(self._infer_ids, config.batch_size,
                                  config.max_wait_s, config.coalesce,
                                  pad=False)
        self._can_bucket = config.bucketing and all(
            ly.cfg.aggregate_op == "sum" for ly in layers)
        self._buckets: set = set()    # (n_pad, e_pad) shapes seen
        # "compiles": bucket shapes seen for the first time (the
        # reference's compile count; the port runs eagerly)
        self.stats = {"subgraphs": 0, "subgraph_vertices": 0,
                      "subgraph_edges": 0, "compiles": 0,
                      "tiled_batches": 0, "ring_batches": 0,
                      "warm_filled": 0}
        self._compat = None           # lazy inline pipeline for step/drain
        if config.warm_cache:
            self.warm_fill(config.warm_cache_max)

    # -- public API --------------------------------------------------------
    def submit(self, rid: int, vertex_ids: np.ndarray,
               deadline_s: Optional[float] = None):
        ids = self._validate(rid, vertex_ids)
        self.batcher.submit(Request(rid, ids, deadline_s=deadline_s))

    def _validate(self, rid: int, vertex_ids: np.ndarray) -> np.ndarray:
        ids = np.asarray(vertex_ids, np.int32)
        if ids.size == 0:
            raise ValueError(f"request {rid}: vertex_ids is empty")
        if ids.min() < 0 or ids.max() >= self.graph.num_vertices:
            raise ValueError(
                f"request {rid}: vertex ids must be in "
                f"[0, {self.graph.num_vertices}), got "
                f"[{ids.min()}, {ids.max()}]")
        return ids

    def step(self, force: bool = True) -> List[Response]:
        """One synchronous serving step — a compatibility wrapper over
        the async pipeline run inline (depth 1, no worker threads, no
        adaptive merging), so both paths share one admission/flush
        implementation."""
        return self._sync_pipeline().step(force=force)

    def drain(self) -> List[Response]:
        return self._sync_pipeline().drain()

    def _sync_pipeline(self):
        if self._compat is None:
            from repro_torch.serving.pipeline import ServingPipeline
            self._compat = ServingPipeline(
                self, depth=1, extract_workers=0, adaptive_batching=False)
        return self._compat

    def warm_fill(self, max_vertices: Optional[int] = None) -> int:
        """Speculatively precompute embeddings for the cache's pinned hub
        region: the DAVC degree profile already names the vertices most
        likely to be requested under power-law traffic, so filling them
        at startup converts first-touch misses into hits.  Returns the
        number of vertices filled."""
        if self.cache is None or not self.cache.pinned_ids:
            return 0
        hubs = np.fromiter(self.cache.pinned_ids, np.int64,
                           len(self.cache.pinned_ids)).astype(np.int32)
        deg = self.graph.degrees()
        hubs = hubs[np.argsort(-deg[hubs], kind="stable")]
        if max_vertices is not None:
            hubs = hubs[:max_vertices]
        for i in range(0, hubs.size, self.config.batch_size):
            chunk = np.unique(hubs[i:i + self.config.batch_size])
            y = self._run_subgraph(chunk)
            self.cache.insert(chunk, y)
        self.stats["warm_filled"] += int(hubs.size)
        return int(hubs.size)

    def apply_updates(self, snapshot, x_new: Optional[np.ndarray] = None
                      ) -> Dict[str, float]:
        """Swap in one `EpochSnapshot` of graph updates.

        The serving graph and extractor move to the epoch graph; the
        result cache is surgically invalidated rather than cleared: a
        cached embedding of vertex v is stale iff a changed edge's
        destination lies within v's (num_hops - 1)-hop *forward*
        closure — those rows (and only those) are evicted from both
        tiers.  When the degree profile has drifted past
        `config.hub_drift_threshold`, the pinned hub set is recomputed
        and, under `warm_cache`, refreshed via `warm_fill`.

        `x_new` replaces the feature matrix (required when vertices
        were added and features exist for them); otherwise new vertices
        get zero feature rows.
        """
        old_graph = self.graph
        g = snapshot.graph
        if x_new is not None:
            x_new = np.asarray(x_new)
            if x_new.shape[0] != g.num_vertices:
                raise ValueError(
                    f"x_new has {x_new.shape[0]} rows, epoch graph has "
                    f"{g.num_vertices} vertices")
            self.x = x_new
        elif g.num_vertices > self.x.shape[0]:
            pad = np.zeros((g.num_vertices - self.x.shape[0],
                            self.x.shape[1]), self.x.dtype)
            self.x = np.concatenate([self.x, pad], axis=0)
        self.graph = g
        self.extractor = SubgraphExtractor(g)
        out = {"affected": 0, "invalidated": 0, "pin_drift": 0.0,
               "repinned": 0, "warm_refilled": 0}
        if self.cache is not None:
            affected = _affected_vertices(old_graph, g,
                                          snapshot.touched_dst,
                                          self.num_hops)
            out["affected"] = int(affected.size)
            out["invalidated"] = self.cache.invalidate(affected)
            deg = g.degrees()
            drift = self.cache.pin_drift(deg)
            out["pin_drift"] = float(drift)
            if drift > self.config.hub_drift_threshold:
                out["repinned"] = self.cache.repin(deg)
                if self.config.warm_cache:
                    out["warm_refilled"] = self.warm_fill(
                        self.config.warm_cache_max)
        self.stats["updates_applied"] = (
            self.stats.get("updates_applied", 0) + 1)
        return out

    def reset_telemetry(self):
        """Zero all counters (cache *contents* and seen buckets are
        kept) — call between warm-up and measured traffic."""
        self.batcher.reset_telemetry()
        if self.cache is not None:
            self.cache.reset_stats()
        if self._compat is not None:
            self._compat.reset_telemetry()
        for k in self.stats:
            self.stats[k] = 0

    def telemetry(self) -> Dict:
        out = {"batcher": dict(self.batcher.stats),
               "latency": self.batcher.latency_stats(),
               "engine": dict(self.stats)}
        if self.cache is not None:
            out["cache"] = dict(self.cache.stats,
                                hit_rate=self.cache.hit_rate())
        return out

    # -- pipeline stage functions ------------------------------------------
    # The async pipeline drives these directly: probe and finish touch the
    # cache, and infer (with `_run_batch`) every tensor; all three MUST
    # stay on the completion thread.  Extract is pure numpy over read-only CSR state and is safe
    # to run on pool workers.
    def _probe_batch(self, ids: np.ndarray):
        """Cache-probe stage: split a batch into hits and the miss set."""
        ids = np.asarray(ids, np.int32)
        if self.cache is not None:
            mask, out = self.cache.lookup(ids)
        else:
            mask, out = np.zeros(ids.size, bool), None
        miss = np.unique(ids[~mask])
        return ids, mask, out, miss

    def _extract_batch(self, miss: np.ndarray):
        """Extraction stage (thread-safe, host-side): L-hop subgraph of
        the miss set plus its gathered input features."""
        sub = self.extractor.extract(miss, self.num_hops,
                                     self.config.fanout)
        xs = self.x[sub.vertices]
        g = sub.graph
        self.stats["subgraphs"] += 1
        self.stats["subgraph_vertices"] += g.num_vertices
        self.stats["subgraph_edges"] += g.num_edges
        return sub, xs

    def _finish_batch(self, ids, mask, out, miss, y) -> np.ndarray:
        """Completion stage: insert fresh rows into the cache and scatter
        hits + misses back into batch order."""
        if self.cache is not None and miss.size:
            self.cache.insert(miss, y)
        if out is None:
            out = np.zeros((ids.size, y.shape[1]), np.float32)
        rows = ~mask
        out[rows] = y[np.searchsorted(miss, ids[rows])]
        return out

    # -- inference path (called by the batcher, one batch at a time) -------
    def _infer_ids(self, ids: np.ndarray) -> np.ndarray:
        ids, mask, out, miss = self._probe_batch(ids)
        if miss.size == 0:
            return out
        sub, xs = self._extract_batch(miss)
        y = self._infer_batch(sub, xs)                    # (|miss|, H)
        return self._finish_batch(ids, mask, out, miss, y)

    def _run_subgraph(self, seeds: np.ndarray) -> np.ndarray:
        return self._infer_batch(*self._extract_batch(seeds))

    def _upload(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a)).to(self.device)

    def _stack(self, gd, x) -> torch.Tensor:
        with torch.no_grad():
            return apply_stack(self.layers, gd, x, params=self.params)

    def _infer_batch(self, sub, xs: np.ndarray) -> np.ndarray:
        """Inference stage (device-side): run the stack over one
        extracted subgraph (`_run_batch`) and read the seeds' rows back,
        the batch's one synchronisation."""
        return self._run_batch(sub, xs)[:sub.num_seeds].cpu().numpy()

    def _run_batch(self, sub, xs: np.ndarray) -> torch.Tensor:
        """Upload one subgraph and its features and run the stack: the
        output on the device (a CPU tensor from the streamed route),
        over-budget batches routed through the ring or the streamed-tiled
        fallback."""
        g = sub.graph
        budget = self.config.engn.device_budget_bytes
        if budget and self._subgraph_footprint(g) > budget:
            ring_gd = self._try_ring_plan(g)
            if ring_gd is not None:
                return self._run_subgraph_ring(xs, ring_gd)
            return self._run_subgraph_tiled(sub, xs)
        if not self._can_bucket:
            gd = {"n": g.num_vertices, "src": self._upload(g.src),
                  "dst": self._upload(g.dst),
                  "val": self._upload(g.weights())}
            if g.rel is not None:
                gd["rel"] = self._upload(g.rel)
                gd["num_relations"] = g.num_relations
            return self._stack(gd, self._upload(np.asarray(xs, np.float32)))

        # pow2-bucketed shapes, best-fit reuse: prefer the smallest
        # already-seen bucket that fits; floored so small miss-sets
        # (cache hot) share one bucket
        n_need, e_need = g.num_vertices + 1, max(g.num_edges, 1)
        fits = [(n, e) for (n, e) in self._buckets
                if n >= n_need and e >= e_need]
        if fits:
            n_pad, e_pad = min(fits, key=lambda ne: ne[0] * ne[1])
        else:
            n_pad = max(_next_pow2(n_need), 256)
            e_pad = max(_next_pow2(e_need), 1024)
        dummy = n_pad - 1
        src = np.full(e_pad, dummy, np.int32)
        dst = np.full(e_pad, dummy, np.int32)
        val = np.zeros(e_pad, np.float32)        # padding edges weigh 0
        src[:g.num_edges] = g.src
        dst[:g.num_edges] = g.dst
        val[:g.num_edges] = g.weights()
        gd = {"n": n_pad, "src": self._upload(src), "dst": self._upload(dst),
              "val": self._upload(val)}
        if g.rel is not None:
            # padding edges are rel 0 at the dummy vertex: with weight 0
            # they add nothing, and the typed in-trace normalisation only
            # counts them at the dummy row the slice below discards
            rel = np.zeros(e_pad, np.int32)
            rel[:g.num_edges] = g.rel
            gd["rel"] = self._upload(rel)
            gd["num_relations"] = self.graph.num_relations
        xf = np.zeros((n_pad, xs.shape[1]), np.float32)
        xf[:xs.shape[0]] = xs

        key = (n_pad, e_pad)
        if key not in self._buckets:
            self._buckets.add(key)
            self.stats["compiles"] += 1
        return self._stack(gd, self._upload(xf))

    # -- out-of-core fallback ----------------------------------------------
    def _subgraph_footprint(self, g: COOGraph) -> int:
        """Device bytes the dense segment path would need for this
        subgraph, at the widest layer of the stack — priced at the
        pow2-bucketed shapes the bucketed path actually allocates, so
        padding cannot overshoot the budget undetected.  Serving is
        inference-only, so the gate prices forward buffers alone
        (training=False)."""
        n, e = g.num_vertices, g.num_edges
        if self._can_bucket:
            n = max(_next_pow2(n + 1), 256)
            e = max(_next_pow2(max(e, 1)), 1024)
        return max(dense_footprint_bytes(
            n, e, self._staged_feat_dim(layer), layer.cfg.out_dim,
            "segment", training=False)
            for layer in self.layers)

    @staticmethod
    def _staged_feat_dim(layer) -> int:
        """The widest per-vertex stream the layer stages: typed models
        carry the (N, R*H) stacked payload, gated ones the (pc || x) 2F
        stream — both wider than in_dim."""
        f = layer.cfg.in_dim
        if layer.cfg.stage_contract == "typed":
            f = max(f, layer.cfg.num_relations * layer.cfg.out_dim)
        elif layer.cfg.stage_contract == "gated":
            f = max(f, 2 * layer.cfg.in_dim)
        return f

    def _try_ring_plan(self, g: COOGraph):
        """Shard-aware footprint gate (DESIGN.md C2): price the per-shard
        ring plan of this batch's subgraph and return it prepared when
        it fits the per-shard budget, else None (the batch then streams).
        The ring aggregate is built per aggregation op, so mixed-op
        stacks skip the ring."""
        p = self.config.engn.ring_shards
        if not p:
            return None
        ops = {ly.cfg.aggregate_op for ly in self.layers}
        contracts = {ly.cfg.stage_contract for ly in self.layers}
        if len(ops) != 1 or len(contracts) != 1:
            return None
        contract = contracts.pop()
        from repro_torch.core.dataflow import (build_packed_ring_shards,
                                               build_ring_tile_shards,
                                               ring_stripe_bytes)
        from repro_torch.core.engn import prepare_ring
        from repro_torch.distributed.sharding import ring_mesh
        mesh = ring_mesh(p, device=self.device)
        cfg = EnGNConfig(in_dim=self.layers[0].cfg.in_dim,
                         out_dim=self.layers[-1].cfg.out_dim,
                         aggregate_op=ops.pop(), backend="ring",
                         tile=self.config.ring_tile, ring_shards=p,
                         stage_contract=contract,
                         num_relations=max(ly.cfg.num_relations
                                           for ly in self.layers),
                         rel_normalize=any(ly.cfg.rel_normalize
                                           for ly in self.layers))
        # typed contract: fold the per-(dst, rel) normalisation into the
        # edge weights before the plan build (prepare_ring is told not
        # to fold again)
        rel_normed = False
        if (g.rel is not None and g.num_relations > 1
                and any(ly.cfg.rel_normalize for ly in self.layers)):
            g = fold_rel_norm(g)
            rel_normed = True
        # a max plan is priced and built over the distinct edges
        g = max_plan_edges(g, cfg, mesh.device)
        # price both stripe carriers before building: an over-budget
        # batch pays nothing, and the cheaper format is built once
        dims = ([self._staged_feat_dim(self.layers[0])]
                + [ly.cfg.out_dim for ly in self.layers])
        dense_b = ring_stripe_bytes(g, p, tile=self.config.ring_tile,
                                    in_dim=max(dims), out_dim=max(dims),
                                    tile_format="dense")
        packed_b = ring_stripe_bytes(g, p, tile=self.config.ring_tile,
                                     in_dim=max(dims), out_dim=max(dims),
                                     tile_format="packed")
        if min(dense_b, packed_b) > self.config.engn.device_budget_bytes:
            return None
        if packed_b <= dense_b:
            plan = build_packed_ring_shards(g, p)
        else:
            plan = build_ring_tile_shards(g, p, tile=self.config.ring_tile)
        return prepare_ring(g, cfg, plan=plan, mesh=mesh,
                            rel_normed=rel_normed)

    def _run_subgraph_ring(self, xs: np.ndarray, gd) -> torch.Tensor:
        """Run the stack over the subgraph's ring plan: each shard holds
        its stripe, the feature shards rotate, so the per-shard budget
        admits subgraphs ~P x larger than one shard before host
        streaming is needed."""
        y = self._stack(gd, self._upload(np.asarray(xs, np.float32)))
        self.stats["ring_batches"] += 1
        return y

    def _run_subgraph_tiled(self, sub, xs: np.ndarray) -> torch.Tensor:
        """Run the stack through the streamed tiled executor: the
        subgraph's edge tiles stay in host memory and stream through
        the device under the budget (instead of running out of memory on
        hub seeds).  The tile store is rebuilt per batch."""
        g = sub.graph
        if (g.rel is not None and g.num_relations > 1
                and any(ly.cfg.rel_normalize for ly in self.layers)):
            # typed sums stream as plain sums: the per-(dst, rel) mean
            # is folded into the tile weights before the store build
            g = fold_rel_norm(g)
        if all(ly.cfg.aggregate_op == "max" for ly in self.layers):
            # the executor's tiles merge repeats by summing: a max stack
            # streams the distinct edges, as its resident plans hold them
            g = max_plan_edges(g, self.layers[0].cfg, self.device)
        dims = ([self._staged_feat_dim(layer) for layer in self.layers]
                + [layer.cfg.out_dim for layer in self.layers])
        ex = TiledExecutor(g, tile=self.config.tiled_tile,
                           budget_bytes=self.config.engn.device_budget_bytes,
                           dim_hint=max(dims),
                           streaming_mode=self.config.engn.streaming_mode,
                           value_dtype=self.config.engn.tile_value_dtype,
                           device=self.device)
        gd = {"n": g.num_vertices, "backend": "tiled", "tiled_exec": ex}
        y = self._stack(gd, np.asarray(xs, np.float32))
        self.stats["tiled_batches"] += 1
        return y
