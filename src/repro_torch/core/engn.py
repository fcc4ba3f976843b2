"""The EnGN processing model (paper S2.2, Algorithm 1) in PyTorch.

Every GNN is three stage functions over an edge-centric graph:

    feature_extraction(prop_src, prop_dst, W_feat) -> tmp       (per edge)
    aggregate(acc, tmp)                            -> acc       (reduce @ dst)
    update(prop_dst, acc, W_update)                -> prop'     (per vertex)

`EnGNLayer` is an `nn.Module` that owns the stage functions, the DASR
order decision (S5.2) and the aggregation backend:

  * "segment": the edge-centric reference (`index_add_` /
    `scatter_reduce`);
  * "blocked": dense T x T tiles through the `rer_spmm` kernel, or packed
    tiles through the `rer_gather` kernel once per pow2 nnz-bucket group;
  * "fused":   extraction fused into the aggregate sweep (`fused_engn`);
  * "tiled":   the streamed out-of-core executor (`core/tiled.py`): the
    tile store stays in host memory and streams to the device, so a
    tiled layer takes host or device features and returns a CPU float32
    tensor, while every reduce and stage function runs on the device.

`prepare_graph` builds the carrier on the plan's device: on `cuda` the
kernels' carriers, on the CPU (only when asked) the plain versions'.  A
graph over `device_budget_bytes` spills to "tiled" (`auto_spill=True`)
or raises `DeviceBudgetExceeded`.  `update_plan` carries a plan across
one epoch of edge updates: a tiled plan merges its host stores in
place, any other re-runs `prepare_graph`.

The resident backends train: their aggregates are autograd Functions
whose backwards walk the forward carrier itself (the dense tiles, or
the packed groups through their work table), sum and max alike, so a
backward builds no carrier of A^T and the plan holds after training
what it held after `prepare_graph` (`PreparedPlan.held_bytes`), as the
reference's, whose tiles XLA differentiates.  The budget gate prices
training as the reference does (`cfg.training=True` doubles the
activations).

The typed and gated stage contracts (R-GCN, Gated-GCN: `stage_spec`)
run on "segment", "blocked", "ring" and "tiled".  Typed dense
tiles keep one `rer_spmm` plan per relation, each launched on its own
contiguous H-wide payload slice; typed packed plans carry the flat
entries with a relation column, as the reference's do, and beside them
their distinct (src, relation) pairs (`typed_pairs`): the layer projects
only those, once each (`typed_pairs` kernels on the card), and the
entries gather their pair's row.  Gated packed plans on `cuda` carry a
sum plan's bucket groups and source table, which the gated kernels
(`rer_gather_gated`) walk: the gate of each entry and feature is
evaluated on chip, forward and backward, and never stored; on the CPU
they carry the flat entries, as the reference's do.  Gated dense tiles
run the reference's (nnzb, T, T, F) formulation, which on `cuda` is priced
first and refused with `DeviceBudgetExceeded` over the budget or the
card's free memory (ROADMAP B6).  The reference's `aggregate_fn`
refusal has no counterpart: `forward` takes no `aggregate_fn`.

The streamed "tiled" backend trains too (`_apply_tiled_diff`): under
autograd every tiled layer, R-GCN's and Gated-GCN's included, runs its
stage functions as ordinary autograd ops on device features and its
aggregate through the differentiable streamed wrappers of
`core/tiled.py`, whose backwards re-stream the graph from the host (or
run B5^T over the device queue); the layer then returns a device tensor.
Under `torch.no_grad()` / `torch.inference_mode()` a tiled layer keeps
its host-streamed inference path.

The sharded "ring" backend (`prepare_ring`, `core/dataflow.py`) splits
the destination vertices into P shards, each keeping its stripe of the
graph (dense tiles or packed entries) and its accumulator, while the
source-feature shards rotate: every model and contract runs on it,
forward and backward (the rotation is an autograd Function).  The P
shards live on the plan's device as P sets of tensors; the budget is per
shard, as in the reference, and on `cuda` the co-located shards are also
priced together against the card's free memory.
"""
from __future__ import annotations

import dataclasses
from contextlib import nullcontext
from functools import partial
from typing import Any, Dict, Optional

import numpy as np
import torch
from torch import nn

from repro_torch.core.plan import PreparedPlan, plan_carrier, wrap_plan
from repro_torch.core.tiled import (DeviceBudgetExceeded, TiledExecutor,
                                    dense_footprint_bytes,
                                    make_streamed_aggregate,
                                    make_streamed_gated,
                                    make_streamed_typed_sum)
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.distributed.compression import quantize_int8_np
from repro_torch.graphs.format import COOGraph, coo_to_blocked
from repro_torch.graphs.partition import distinct_edges, tile_schedule_order
from repro_torch.tracing import count, span, stage

AggregateOp = str  # "sum" | "max" | "mean"

def segment_aggregate(edge_vals: torch.Tensor, dst: torch.Tensor, n: int,
                      op: AggregateOp) -> torch.Tensor:
    """Edge-centric reduce at destination vertices — the reference path
    (Algorithm 1 lines 2-5 literally).  An empty max row is 0."""
    f = edge_vals.shape[1]
    dst = dst.long()
    if op in ("sum", "mean"):
        s = torch.zeros((n, f), dtype=edge_vals.dtype, device=edge_vals.device)
        s.index_add_(0, dst, edge_vals)
        if op == "sum":
            return s
        c = torch.zeros(n, dtype=torch.float32, device=edge_vals.device)
        c.index_add_(0, dst, torch.ones_like(dst, dtype=torch.float32))
        return s / torch.clamp_min(c, 1.0)[:, None]
    if op == "max":
        m = torch.full((n, f), -torch.inf, dtype=edge_vals.dtype,
                       device=edge_vals.device)
        m.scatter_reduce_(0, dst[:, None].expand(-1, f), edge_vals, "amax",
                          include_self=False)
        return torch.where(torch.isneginf(m), 0.0, m)
    raise ValueError(op)


@dataclasses.dataclass
class EnGNConfig:
    """The reference's layer configuration, field for field (see
    `repro.core.engn.EnGNConfig` for what each field selects)."""
    in_dim: int
    out_dim: int
    aggregate_op: AggregateOp = "sum"
    stage_order: str = "auto"          # "auto" | "fau" | "afu"
    backend: str = "segment"           # segment|blocked|fused|ring|tiled
    tile: int = 256                    # T for the tile backends
    tile_format: str = "auto"          # "dense" | "packed" | "auto"
    packed_bucket_floor: int = 8
    ring_shards: Optional[int] = None
    ring_axis: str = "ring"
    device_budget_bytes: Optional[int] = None
    auto_spill: bool = True
    tiled_chunk: int = 8
    streaming_mode: str = "auto"
    tile_value_dtype: str = "fp32"
    training: bool = False
    stage_contract: Optional[str] = None
    num_relations: int = 1
    rel_normalize: bool = False
    dtype: Any = torch.float32


class EnGNLayer(nn.Module):
    """One GNN propagation layer on the EnGN processing model.

    Parameters are created on `device` (`cuda` unless the caller passes
    "cpu") and drawn on the CPU from `generator`, so one seed gives the
    same weights on either device."""

    def __init__(self, cfg: EnGNConfig, name: str = "engn",
                 device: DeviceLike = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.cfg = cfg
        self.name = name
        dev = resolve_device(device)
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        for key, val in self.init_params(generator).items():
            self.register_parameter(key, nn.Parameter(val.to(dev)))

    @property
    def device(self) -> torch.device:
        return next(self.parameters()).device

    # -- parameters ------------------------------------------------------
    def init_params(self, gen: torch.Generator) -> Dict[str, torch.Tensor]:
        cfg = self.cfg
        scale = 1.0 / np.sqrt(cfg.in_dim)
        return {"w": torch.randn((cfg.in_dim, cfg.out_dim), generator=gen,
                                 dtype=cfg.dtype) * scale}

    def reset_parameters(self, generator: torch.Generator) -> None:
        with torch.no_grad():
            for key, val in self.init_params(generator).items():
                getattr(self, key).copy_(val)

    # -- stage functions (overridden per model) ---------------------------
    def feature_extraction(self, x_src: torch.Tensor) -> torch.Tensor:
        """Default: linear condense XW (GCN-style)."""
        return x_src @ self.w

    def update(self, x_self: torch.Tensor, agg: torch.Tensor) -> torch.Tensor:
        """Default: ReLU activation."""
        return torch.relu(agg)

    def extract(self, x_src: torch.Tensor, x_dst: torch.Tensor,
                edge_val: torch.Tensor, rel) -> torch.Tensor:
        """The canonical per-edge message: edge_val * extraction(x_src)."""
        return edge_val[:, None] * self.feature_extraction(x_src)

    # -- stage contract ------------------------------------------------------
    def stage_spec(self) -> Optional[Dict[str, Any]]:
        """None for the default contract (message = edge_val *
        feature_extraction(x_src)).  A model whose messages read the edge
        type or the destination endpoint returns its spec:
        {"kind": "typed", "num_relations": R, "channels": H, "normalize":
        bool} with `src_payload(x) -> (N, R*H)` and `pair_payload(x,
        pairs) -> (P, H)`, the rows of the pairs that send (R-GCN), or
        {"kind": "gated"} with `gate_dst` / `gate_src` (Gated-GCN).  Both
        aggregate by sum."""
        return None

    # -- DASR (S5.2): choose sigma(A(XW)) vs sigma((AX)W) -----------------
    def dasr_order(self) -> str:
        cfg = self.cfg
        if cfg.stage_order != "auto":
            return cfg.stage_order
        # aggregate cost is E*H if extraction first (Eq. 6) vs E*F if
        # aggregation first (Eq. 7): extract first iff H <= F
        return "fau" if cfg.out_dim <= cfg.in_dim else "afu"

    def dasr_op_counts(self, num_edges: int) -> Dict[str, float]:
        f, h = self.cfg.in_dim, self.cfg.out_dim
        return {
            "fau_aggregate_ops": float(num_edges) * h,
            "afu_aggregate_ops": float(num_edges) * f,
        }

    # -- forward ----------------------------------------------------------
    def forward(self, graph, x) -> torch.Tensor:
        """graph: a `PreparedPlan` from `prepare_graph`, or its carrier
        dict; x: (N, F) features (moved to the layer's device; a tiled
        plan keeps them on the host and returns a CPU tensor)."""
        graph = plan_carrier(graph)
        spec = self.stage_spec()
        if spec is not None:
            return self._apply_staged(graph, x, spec)
        backend = graph.get("backend", self.cfg.backend)
        if backend == "tiled":
            if self._differentiated(x):
                return self._apply_tiled_diff(graph, x)
            return self._apply_tiled(graph, x)
        x = torch.as_tensor(x, dtype=self.cfg.dtype, device=self.device)
        agg = partial(self._aggregate, graph)
        linear_sum = (self.cfg.aggregate_op == "sum"
                      and type(self).feature_extraction
                      is EnGNLayer.feature_extraction)
        if (linear_sum and backend == "fused"
                and self.dasr_order() == "fau"):
            # Fig. 8 stage overlap: P = X W lives only on chip per tile
            from repro_torch.kernels.fused_engn import fused_engn_layer
            y = fused_engn_layer(graph["blocks"], graph["block_row"],
                                 graph["block_col"], _pad_rows(graph, x),
                                 self.w, q=graph["blocks_meta"]["q"],
                                 columns=graph.get("fused_columns"))
            return self.update(x, y[:graph["n"]])
        return self._three_stages(agg, x, linear_sum)

    def _three_stages(self, agg, x, linear_sum: bool) -> torch.Tensor:
        """Extraction, `agg` and the update in DASR's order, each in its
        `engn.*` span: (AX)W for a linear sum the order puts aggregation
        first, A(XW) otherwise."""
        # each stage rebinds y, so an intermediate lives no longer than
        # in the nested calls
        if linear_sum and self.dasr_order() == "afu":
            with span("engn.aggregate"):
                y = agg(x)
            with span("engn.extract"):
                y = self.feature_extraction(y)                    # (AX)W
        else:
            with span("engn.extract"):
                y = self.feature_extraction(x)
            with span("engn.aggregate"):
                y = agg(y)                                        # A(XW)
        with span("engn.update"):
            return self.update(x, y)

    # -- staged models (typed and gated stage contracts) ------------------
    def _apply_staged(self, graph, x, spec) -> torch.Tensor:
        cfg = self.cfg
        backend = graph.get("backend", cfg.backend)
        if cfg.aggregate_op != "sum":
            raise ValueError(
                f"the {spec['kind']!r} stage contract aggregates by sum "
                f"(Eq. 3-4); got aggregate_op={cfg.aggregate_op!r}")
        if backend == "fused":
            raise ValueError(
                "the fused Fig. 8 kernel serves the default contract "
                "only; use blocked/tiled/ring for staged models")
        if spec["kind"] == "typed":
            return self._staged_typed(graph, x, spec, backend)
        if spec["kind"] == "gated":
            return self._staged_gated(graph, x, backend)
        raise ValueError(spec["kind"])

    def _staged_typed(self, graph, x, spec, backend) -> torch.Tensor:
        """Relation-typed messages (R-GCN, Eq. 3): the per-vertex payload
        is the (N, R*H) stack of every relation's projection; each typed
        carrier (tile, flat entry) takes its own relation's H-wide slice
        and the aggregate is a plain sum.  A blocked plan's flat entries
        take the (P, H) rows of the (src, relation) pairs that send
        instead (`typed_pairs`), which hold the same numbers: the
        `typed.pair_rows` counter counts the rows projected that way,
        `typed.payload_rows` those of the (N, R*H) payloads of the dense
        blocked route.  The per-(dst, rel)
        normalisation is folded into the carrier's weights by
        `prepare_graph` (`rel_normed`), or computed here on a raw
        segment dict."""
        n = graph["n"]
        r, h = spec["num_relations"], spec["channels"]
        if backend == "tiled":
            ex = self._tiled_executor(graph, x)
            if self._differentiated(x):
                xd = self._device_features(x)
                agg = make_streamed_typed_sum(ex)(self.src_payload(xd))
                return self.update(xd, agg)
            agg = ex.aggregate(x, "sum", order="auto",
                               extract_fn=self.src_payload,
                               extract_dim=r * h, out_dim_hint=h,
                               rel_channels=h)
            return ex.stream_map(self.update, x, agg)
        x = torch.as_tensor(x, dtype=self.cfg.dtype, device=self.device)
        if backend == "segment":
            src, dst, val = _segment_edges(graph, x.device)
            rel = graph["rel"].long()
            if spec.get("normalize") and not graph.get("rel_normed"):
                key = dst * r + rel
                cnt = torch.zeros(n * r, device=x.device).index_add_(
                    0, key, torch.ones_like(val))
                val = val / torch.clamp_min(cnt[key], 1.0)
            if self.dasr_order() == "afu":
                # aggregate per (dst, rel) first, then one batched
                # projection: Eq. 7's cheaper order when F < H
                agg_r = segment_aggregate(x[src] * val[:, None],
                                          dst * r + rel, n * r, "sum")
                agg = torch.einsum("nrf,rfh->nh",
                                   agg_r.reshape(n, r, x.shape[1]), self.wr)
            else:
                ev = self.extract(x[src], x[dst], val, rel)
                agg = segment_aggregate(ev, dst, n, "sum")
            return self.update(x, agg)
        if backend == "ring":
            y = graph["ring_fn"](*graph["ring_operands"],
                                 _pad_rows(graph, self.src_payload(x)),
                                 graph["ring_counts"])
            return self.update(x, y[:n])
        if backend != "blocked":
            raise ValueError(backend)
        if "typed_pairs" in graph:
            pairs = graph["typed_pairs"]
            count("typed.pair_rows", pairs.num_pairs)
            with span("engn.extract"):
                y = self.pair_payload(x, pairs)           # (P, h)
            with span("engn.aggregate"):
                agg = _typed_pair_sum(graph, y, n)
        else:
            count("typed.payload_rows", n * r)
            with span("engn.extract"):
                xw = self.src_payload(x)                  # (n, r*h)
            with span("engn.aggregate"):
                agg = _typed_blocked_sum(graph, xw, n, r, h)
        with span("engn.update"):
            return self.update(x, agg)

    def _staged_gated(self, graph, x, backend) -> torch.Tensor:
        """Dst+src sigmoid-gated messages (Gated-GCN, Eq. 4): message =
        val * sigmoid(ph[dst] + pc[src]) * x[src], ph = gate_dst(x),
        pc = gate_src(x), both per vertex."""
        n = graph["n"]
        if backend == "tiled":
            ex = self._tiled_executor(graph, x)
            if self._differentiated(x):
                xd = self._device_features(x)
                agg = make_streamed_gated(ex)(self.gate_dst(xd),
                                              self.gate_src(xd), xd)
                return self.update(xd, agg)
            ph = ex.stream_map(self.gate_dst, x)
            pc = ex.stream_map(self.gate_src, x)
            agg = ex.gated_aggregate(ph, pc, x)
            return ex.stream_map(self.update, x, agg)
        x = torch.as_tensor(x, dtype=self.cfg.dtype, device=self.device)
        if backend == "segment":
            src, dst, val = _segment_edges(graph, x.device)
            ev = self.extract(x[src], x[dst], val, None)
            return self.update(x, segment_aggregate(ev, dst, n, "sum"))
        pad = partial(_pad_rows, graph)
        if backend == "blocked" and ("packed_groups" in graph
                                     or "packed_flat" in graph):
            return self._gated_packed(graph, x)
        ph, pc = self.gate_dst(x), self.gate_src(x)
        if backend == "ring":
            # ph stays on its destination shard, (pc || x) rotates
            meta = graph["ring_meta"]
            if x.device.type == "cuda" and meta["tile_format"] == "dense":
                check_gated_ring(meta["shards"], meta["s_max"],
                                 meta["tile"], x.shape[1],
                                 self.cfg.device_budget_bytes, x.device)
            y = graph["ring_fn"](*graph["ring_operands"], pad(ph),
                                 torch.cat([pad(pc), pad(x)], dim=1),
                                 graph["ring_counts"])
            return self.update(x, y[:n])
        if backend != "blocked":
            raise ValueError(backend)
        meta = graph["blocks_meta"]
        pad_n = meta["padded"]
        q, t = meta["q"], meta["tile"]
        blocks = graph["blocks"]
        brow, bcol = graph["block_row"].long(), graph["block_col"].long()
        f = x.shape[1]
        if x.device.type == "cuda":
            check_gated_dense(gated_dense_bytes(blocks.shape[0], t, f),
                              self.cfg.device_budget_bytes,
                              torch.cuda.mem_get_info(x.device)[0])
        xt, pht, pct = (pad(a).reshape(q, t, -1) for a in (x, ph, pc))
        z = torch.sigmoid(pht[brow][:, :, None, :] + pct[bcol][:, None, :, :])
        b = blocks[..., None]
        contrib = torch.where(b != 0.0, b * z * xt[bcol][:, None, :, :], 0.0)
        part = contrib.sum(dim=2)                        # (nnzb, T, F)
        agg = torch.zeros((q, t, f), dtype=x.dtype, device=x.device)
        agg = agg.index_add(0, brow, part).reshape(pad_n, f)[:n]
        return self.update(x, agg)

    def _gated_packed(self, graph, x) -> torch.Tensor:
        """The gated contract on a packed blocked plan, in the `engn.*`
        spans: the two gate projections of the zero-padded features, the
        gated aggregate (a card's bucket groups through the
        `rer_gather_gated` kernels, whose backward recomputes the gates;
        a CPU plan's flat entries through the flat formula, as the
        reference's), the update."""
        from repro_torch.kernels.rer_gather_gated import (
            gated_flat_plain, gated_groups_aggregate)
        meta = graph["blocks_meta"]
        with span("engn.extract"):
            xf = _pad_rows(graph, x)
            ph, pc = self.gate_dst(xf), self.gate_src(xf)
        with span("engn.aggregate"):
            if "packed_groups" in graph:
                y = gated_groups_aggregate(graph["packed_groups"], ph, pc,
                                           xf, q=meta["q"])
            else:
                gsrc, gdst, gval = graph["packed_flat"]
                y = gated_flat_plain(gsrc, gdst, gval, ph, pc, xf,
                                     n=meta["padded"])
        with span("engn.update"):
            return self.update(x, y[:graph["n"]])

    # -- streamed out-of-core path (core/tiled.py) -------------------------
    def _tiled_executor(self, graph, x) -> TiledExecutor:
        """The plan's executor, after the check every tiled layer makes:
        it streams to the layer's device."""
        ex: TiledExecutor = graph["tiled_exec"]
        if ex.device != self.device:
            raise ValueError(f"the tiled plan streams to {ex.device}, the "
                             f"layer's parameters are on {self.device}")
        return ex

    def _differentiated(self, x) -> bool:
        """Whether autograd records this call: grad mode is on and a
        parameter (the layer's own or those `functional_call` swapped in)
        or x asks for a gradient."""
        return torch.is_grad_enabled() and (
            any(p.requires_grad for p in self.parameters())
            or (isinstance(x, torch.Tensor) and x.requires_grad))

    def _device_features(self, x) -> torch.Tensor:
        return torch.as_tensor(x, dtype=torch.float32, device=self.device)

    def _apply_tiled_diff(self, graph, x) -> torch.Tensor:
        """The trainable twin of `_apply_tiled`: extraction and update are
        ordinary autograd ops on device features, the aggregate is
        `make_streamed_aggregate` (its backward re-streams the graph from
        the host, or runs B5^T over the device queue).  Returns a device
        tensor; only the graph stays on the host."""
        cfg = self.cfg
        ex = self._tiled_executor(graph, x)
        agg = make_streamed_aggregate(ex, cfg.aggregate_op)
        x = self._device_features(x)
        linear_sum = (cfg.aggregate_op == "sum"
                      and type(self).feature_extraction
                      is EnGNLayer.feature_extraction)
        return self._three_stages(agg, x, linear_sum)

    def _apply_tiled(self, graph, x) -> torch.Tensor:
        """The layer through the streamed executor: extraction runs on
        each source interval as it is loaded, aggregation follows the
        adaptive tile schedule, and the update streams per destination
        interval.  Takes host or device x and returns a CPU float32
        tensor: the graph and the features stay on the host by design,
        every reduce and stage function runs on the executor's device."""
        cfg = self.cfg
        ex = self._tiled_executor(graph, x)
        order = tile_schedule_order(cfg.in_dim, cfg.out_dim)
        linear_sum = (cfg.aggregate_op == "sum"
                      and type(self).feature_extraction
                      is EnGNLayer.feature_extraction)
        if linear_sum and self.dasr_order() == "afu":
            ax = ex.aggregate(x, "sum", order=order,
                              out_dim_hint=cfg.out_dim)       # (AX)
            return ex.stream_map(
                lambda xb, ab: self.update(xb, self.feature_extraction(ab)),
                x, ax)
        agg = ex.aggregate(x, cfg.aggregate_op, order=order,
                           extract_fn=self.feature_extraction,
                           extract_dim=cfg.out_dim, out_dim_hint=cfg.out_dim)
        return ex.stream_map(self.update, x, agg)

    # -- aggregation backends ---------------------------------------------
    def _aggregate(self, graph, feat: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        graph = plan_carrier(graph)
        backend = graph.get("backend", cfg.backend)
        if backend == "segment":
            ev = feat[graph["src"].long()]
            if "val" in graph:
                ev = ev * graph["val"][:, None]
            return segment_aggregate(ev, graph["dst"], graph["n"],
                                     cfg.aggregate_op)
        if backend == "tiled":
            raise RuntimeError("the streamed tiled backend runs through "
                               "EnGNLayer._apply_tiled, not _aggregate")
        if backend == "ring":
            y = graph["ring_fn"](*graph["ring_operands"],
                                 _pad_rows(graph, feat), graph["ring_counts"])
            return y[:graph["n"]]
        if backend not in ("blocked", "fused"):
            raise ValueError(backend)
        n = graph["n"]
        # mean rides the sum machinery: sum, then divide by the in-edge
        # counts (the exact floats segment mean divides by)
        base_op = "sum" if cfg.aggregate_op == "mean" else cfg.aggregate_op

        def _finish(y):
            if cfg.aggregate_op != "mean":
                return y[:n]
            return y[:n] / torch.clamp_min(graph["in_counts"], 1.0)[:, None]
        xf = _pad_rows(graph, feat)
        if "packed_flat" in graph:
            # CPU plans (a gated plan's flat entries are read by
            # `_staged_gated`): one flat gather + segment reduce
            from repro_torch.kernels.rer_gather import packed_flat_plain
            gsrc, gdst, gval = graph["packed_flat"]
            scale = graph.get("packed_val_scale")
            if scale is not None:
                # int8 residency: the values dequantise where they are read
                gval = gval.to(torch.float32) * scale
            y = packed_flat_plain(gsrc, gdst, gval, xf, n=xf.shape[0],
                                  op=base_op)
            return _finish(y)
        if "packed_groups" in graph:
            # CUDA plans: one rer_gather launch over every pow2
            # nnz-bucket group (its work table built with the plan)
            from repro_torch.kernels.rer_gather import packed_groups_spmm
            y = packed_groups_spmm(
                graph["packed_groups"], xf, q=graph["blocks_meta"]["q"],
                op=base_op)
            return _finish(y)
        from repro_torch.kernels.rer_spmm import blocked_spmm
        y = blocked_spmm(graph["blocks"], graph["block_row"],
                         graph["block_col"], xf,
                         q=graph["blocks_meta"]["q"], op=base_op,
                         counts=graph.get("row_counts"))
        return _finish(y)


def _typed_pair_sum(graph: Dict[str, Any], y: torch.Tensor,
                    n: int) -> torch.Tensor:
    """The typed aggregate of a blocked plan's flat entries over the
    (P, H) pair rows: each entry gathers its pair's row, then one
    segment sum."""
    _, gdst, gval, _ = graph["typed_flat"]
    ev = gval[:, None] * y.index_select(0, graph["typed_pairs"].gpair)
    return segment_aggregate(ev, gdst, n, "sum")


def _typed_blocked_sum(graph: Dict[str, Any], xw: torch.Tensor, n: int,
                       r: int, h: int) -> torch.Tensor:
    """The typed aggregate of a dense blocked plan over the (n, R*H)
    payload: one B1 launch per relation's dense tiles."""
    from repro_torch.kernels.rer_spmm import blocked_spmm
    pad_n = graph["blocks_meta"]["padded"]
    # one contiguous (pad_n, H) slice per relation, the rows B1 reads;
    # its gradient reaches the payload (and W_r) through the unbind
    parts = (_pad_rows(graph, xw).reshape(pad_n, r, h)
             .permute(1, 0, 2).contiguous().unbind(0))
    y = None
    for blk in graph["typed_blocks"]:      # relations with tiles only
        part = blocked_spmm(blk["blocks"], blk["block_row"],
                            blk["block_col"], parts[blk["rel"]],
                            q=blk["q"], op="sum")
        y = part if y is None else y + part
    return (y[:n] if y is not None
            else torch.zeros((n, h), dtype=xw.dtype, device=xw.device))


def _segment_edges(graph: Dict[str, Any], dev: torch.device):
    """(src, dst, val) of a segment carrier as index and float32 tensors,
    val 1 where the graph is unweighted."""
    src, dst = graph["src"].long(), graph["dst"].long()
    val = graph.get("val")
    val = (torch.ones(src.shape[0], device=dev) if val is None
           else val.float())
    return src, dst, val


def _pad_rows(graph: Dict[str, Any], x: torch.Tensor) -> torch.Tensor:
    """x (n, F) zero-padded to the tile grid's q*T rows (the ring's P
    shards of n_loc)."""
    n = graph["n"]
    meta = graph.get("blocks_meta") or graph["ring_meta"]
    xf = torch.zeros((meta["padded"], x.shape[1]),
                     dtype=x.dtype, device=x.device)
    xf[:n] = x
    return xf


def _upload_stage(dev: DeviceLike):
    """The `plan.upload` stage where the target is a card."""
    return (stage("plan.upload") if torch.device(dev).type == "cuda"
            else nullcontext())


def _upload(a: np.ndarray, dev: DeviceLike) -> torch.Tensor:
    with _upload_stage(dev):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)


def upload_groups(groups, dev: DeviceLike, source: bool = False):
    """A plan's bucket groups on `dev`, with the `rer_gather` kernel's
    work table built from the host arrays beside them (`PlanGroups`),
    and with `source` the sum backward's source-order table."""
    from repro_torch.kernels.rer_gather import PlanGroups
    with _upload_stage(dev):
        return PlanGroups(groups, dev, source=source)


def fold_rel_norm(g: COOGraph) -> COOGraph:
    """Fold R-GCN's per-(dst, rel) mean normalisation 1/|N_r(dst)| into
    the edge weights (Eq. 3).  The count does not depend on the
    features, so folded on the host it makes the typed aggregate a plain
    sum on every backend."""
    if g.rel is None:
        raise ValueError("fold_rel_norm needs a relation-typed graph")
    key = g.dst.astype(np.int64) * g.num_relations + g.rel
    cnt = np.bincount(key, minlength=g.num_vertices * g.num_relations)
    val = (g.weights() / np.maximum(cnt[key], 1)).astype(np.float32)
    return COOGraph(g.num_vertices, g.src, g.dst, val, g.rel,
                    g.num_relations)


def max_plan_edges(g: COOGraph, cfg: EnGNConfig,
               dev: torch.device) -> COOGraph:
    """The edges a max layer's carriers hold: the distinct (src, dst)
    pairs (`graphs/partition.py::distinct_edges`, sorted on the plan's
    device; the `plan.distinct` stage, its dropped repeats counted in
    `plan.distinct_dropped`), so that a tile entry's max is the max over
    the neighbour set that `segment` takes.  Sum and mean plans take the
    graph as it is: their carriers merge repeats by summing, which is
    their result."""
    if cfg.aggregate_op != "max":
        return g
    with stage("plan.distinct"):
        g, dropped = distinct_edges(g, dev)
    count("plan.distinct_dropped", dropped)
    return g


def _maybe_fold_rel_norm(g: COOGraph, cfg: EnGNConfig, rel_normed: bool):
    """(graph, rel_normed) after applying the config's normalisation at
    most once across the prepare_* call chain."""
    if (cfg.rel_normalize and not rel_normed and g.rel is not None
            and g.num_relations > 1):
        with stage("plan.fold"):
            return fold_rel_norm(g), True
    return g, rel_normed


# (nnzb, T, T, F) float32 tensors the gated dense formulation holds at
# once under autograd: the gate, its weighted product, that times x, and
# the masked contribution
_GATED_DENSE_LIVE = 4


def gated_dense_bytes(nnzb: int, tile: int, f: int) -> int:
    """Device bytes the gated dense formulation (`_staged_gated` on dense
    tiles) materialises: `_GATED_DENSE_LIVE` (nnzb, T, T, F) float32
    tensors."""
    return _GATED_DENSE_LIVE * 4 * nnzb * tile * tile * f


def check_gated_dense(nbytes: int, budget: Optional[int],
                      free: Optional[int]) -> None:
    """Refuse a gated dense aggregate on the card whose formulation needs
    more than the device budget or the card's free memory, before
    anything is allocated.  No route is taken in its place: the gated
    walk of B1's dense tiles is ROADMAP B6; packed tiles
    (`tile_format="packed"` or "auto") run the gated contract today."""
    over = []
    if budget and nbytes > budget:
        over.append(f"the device budget ({budget} B)")
    if free is not None and nbytes > free:
        over.append(f"the card's free memory ({free} B)")
    if over:
        raise DeviceBudgetExceeded(
            f"the gated contract on dense tiles materialises (nnzb, T, T, "
            f"F) tensors, {nbytes} B, over {' and '.join(over)}; a gated "
            f"walk of the dense tiles is not built yet (ROADMAP B6): use "
            f"tile_format='packed' or 'auto'")


def check_gated_ring(p: int, s_max: int, tile: int, f: int,
                     budget: Optional[int], dev: torch.device) -> None:
    """`check_gated_dense` for a dense ring stripe on the card: a shard's
    aggregate materialises (s_max, T, T, F) tensors for each of its P
    steps, priced against the per-shard budget, and the P co-located
    shards together against the card's free memory."""
    per_shard = gated_dense_bytes(p * s_max, tile, f)
    check_gated_dense(per_shard, budget, None)
    check_gated_dense(p * per_shard, None, torch.cuda.mem_get_info(dev)[0])


def typed_dense_bytes(g: COOGraph, tile: int, in_dim: int, out_dim: int,
                      training: bool = False) -> int:
    """Device bytes of a typed dense plan (`_prepare_blocked_typed` with
    tile_format "dense"), which the untyped closed form under-prices: a
    T x T tile and its two int32 indexes for every typed key (dst
    interval, src interval, relation) present, a pad tile per relation for
    every destination interval it has no tile in (`prepare_blocks`), and
    the activations x, the (N, R*H) payload and the output (doubled for
    training, as `dense_footprint_bytes` doubles them)."""
    n, r, t = g.num_vertices, g.num_relations, tile
    q = -(-n // t)
    key = (((g.dst // t).astype(np.int64) * q + g.src // t) * r
           + g.rel.astype(np.int64))
    uniq = np.unique(key)
    rel, row = uniq % r, uniq // r // q
    rows_held = np.unique(rel * q + row).size     # (relation, dst) pairs
    tiles = uniq.size + np.unique(rel).size * q - rows_held
    act = 2 if training else 1
    return ((4 * t * t + 8) * tiles
            + act * 4 * n * (in_dim + out_dim + r * out_dim))


def gate_bytes(g: COOGraph, cfg: EnGNConfig, out_dim: int) -> int:
    """What the budget gate of `prepare_graph` prices a resident plan of
    `cfg` at: a typed dense plan at its typed keys and pads
    (`typed_dense_bytes`; the untyped closed form under-prices it), any
    other at `dense_footprint_bytes`, the reference's closed form."""
    if (cfg.backend == "blocked" and cfg.stage_contract == "typed"
            and cfg.tile_format == "dense" and g.rel is not None
            and g.num_relations > 1):
        return typed_dense_bytes(g, cfg.tile, cfg.in_dim, out_dim,
                                 cfg.training)
    return dense_footprint_bytes(g.num_vertices, g.num_edges, cfg.in_dim,
                                 out_dim, cfg.backend, tile=cfg.tile,
                                 has_val=g.val is not None,
                                 tile_format=cfg.tile_format,
                                 training=cfg.training,
                                 value_dtype=cfg.tile_value_dtype)


def prepare_graph(g: COOGraph, cfg: EnGNConfig,
                  out_dim: Optional[int] = None,
                  device: DeviceLike = None) -> PreparedPlan:
    """Host-side 'format converter': build the `PreparedPlan` (typed
    attributes + the carrier dict of device tensors) for the configured
    backend, on `device` (`cuda` unless the caller passes "cpu"),
    spilling to the streamed "tiled" backend when the graph exceeds
    `cfg.device_budget_bytes` (or raising, without `auto_spill`).  A
    max plan's carriers (blocked, fused, tiled, ring) hold the graph's
    distinct edges (`max_plan_edges`), so it serves max layers only."""
    dev = resolve_device(device)
    backend = cfg.backend
    h = out_dim if out_dim is not None else cfg.out_dim
    g, rel_normed = _maybe_fold_rel_norm(g, cfg, False)
    if cfg.device_budget_bytes and backend not in ("tiled", "ring"):
        need = gate_bytes(g, cfg, h)
        if need > cfg.device_budget_bytes:
            if not cfg.auto_spill:
                raise DeviceBudgetExceeded(
                    f"backend {backend!r} needs ~{need} device bytes, "
                    f"budget is {cfg.device_budget_bytes} (set "
                    f"auto_spill=True or backend='tiled' to stream "
                    f"tiles out-of-core)")
            backend = "tiled"
    if backend == "tiled":
        return prepare_tiled(g, cfg, out_dim, device=dev,
                             rel_normed=rel_normed)
    if backend == "ring":
        return prepare_ring(g, cfg, out_dim, rel_normed=rel_normed,
                            device=dev)
    d: Dict[str, Any] = {"n": g.num_vertices, "backend": backend,
                         "device": dev}
    if backend == "segment":
        d["src"] = _upload(g.src, dev)
        d["dst"] = _upload(g.dst, dev)
        if g.val is not None:
            d["val"] = _upload(g.val, dev)
        if g.rel is not None:
            d["rel"] = _upload(g.rel, dev)
            d["num_relations"] = g.num_relations
            d["rel_normed"] = rel_normed
        return wrap_plan(d)
    if backend not in ("blocked", "fused"):
        raise ValueError(backend)
    g = max_plan_edges(g, cfg, dev)
    if (backend == "blocked" and cfg.stage_contract == "typed"
            and g.rel is not None and g.num_relations > 1):
        return _prepare_blocked_typed(g, cfg, d, h, dev)
    # the adaptive order (Table 3) is recorded for the I/O analysis; the
    # kernels walk dst-sorted tiles whatever it says
    order = tile_schedule_order(cfg.in_dim, h)
    if cfg.aggregate_op == "mean":
        d["in_counts"] = _upload(
            np.bincount(g.dst, minlength=g.num_vertices).astype(np.float32),
            dev)
    # the fused kernel eats dense tiles, as does an explicit "dense"
    choice = None
    if backend == "blocked" and cfg.tile_format != "dense":
        from repro_torch.graphs.partition import (build_tile_store,
                                                  pack_tile_store)
        from repro_torch.kernels.autotune import choose_tile_format
        with stage("plan.tiles"):
            store = build_tile_store(g, cfg.tile)
        with stage("plan.pack"):
            packed = pack_tile_store(store)
        with stage("plan.format"):
            choice = choose_tile_format(
                cfg.tile_format, packed, backend="blocked",
                bucket_floor=cfg.packed_bucket_floor)
        if choice.fmt == "packed":
            return _prepare_packed(g, cfg, d, h, store, packed, choice,
                                   order, dev, rel_normed)
    from repro_torch.kernels.rer_spmm import prepare_blocks
    b = coo_to_blocked(g, cfg.tile, order="column")
    blocks, brow, bcol = prepare_blocks(b.blocks, b.block_row, b.block_col,
                                        b.q)
    if (backend == "blocked" and cfg.stage_contract == "gated"
            and dev.type == "cuda"):
        # priced before the tiles go up: nothing is allocated on a refusal
        check_gated_dense(gated_dense_bytes(blocks.shape[0], b.tile,
                                            cfg.in_dim),
                          cfg.device_budget_bytes,
                          torch.cuda.mem_get_info(dev)[0])
    d["blocks"] = _upload(blocks, dev)
    d["block_row"] = _upload(brow, dev)
    d["block_col"] = _upload(bcol, dev)
    if dev.type == "cuda":
        # the kernels' host tables, built once with the plan (CPU plans
        # run the plain versions, which need neither)
        if backend == "fused":
            from repro_torch.kernels.fused_engn import column_table
            d["fused_columns"] = column_table(bcol, b.q, dev)
        if cfg.aggregate_op == "max":
            from repro_torch.kernels.rer_spmm_bwd import upload_row_counts
            d["row_counts"] = upload_row_counts(blocks, brow, b.q, dev)
    d["blocks_meta"] = {"q": b.q, "padded": b.padded_vertices,
                        "order": order, "tile": b.tile,
                        "tile_format": "dense", "format_choice": choice}
    return wrap_plan(d)


def prepare_tiled(g: COOGraph, cfg: EnGNConfig,
                  out_dim: Optional[int] = None,
                  impl: Optional[str] = None,
                  device: DeviceLike = None,
                  rel_normed: bool = False) -> PreparedPlan:
    """The `PreparedPlan` of the streamed out-of-core backend: the Q x Q
    tile store stays in host memory, tile and chunk fitted to the
    device budget at the layer's wider feature width, streaming to
    `device` (`cuda` unless the caller passes "cpu")."""
    dev = resolve_device(device)
    h = out_dim if out_dim is not None else cfg.out_dim
    g, _ = _maybe_fold_rel_norm(g, cfg, rel_normed)
    g = max_plan_edges(g, cfg, dev)
    # the typed contract streams the (N, R*H) stacked payload, the gated
    # one a 2F-wide (pc || x) stream
    dim_hint = max(cfg.in_dim, h) * (2 if cfg.training else 1)
    if cfg.stage_contract == "typed":
        dim_hint = max(dim_hint, cfg.num_relations * h)
    elif cfg.stage_contract == "gated":
        dim_hint = max(dim_hint, 2 * cfg.in_dim)
    value_dtype = (cfg.tile_value_dtype if cfg.tile_format != "dense"
                   else "fp32")
    ex = TiledExecutor(g, tile=cfg.tile, chunk=cfg.tiled_chunk,
                       budget_bytes=cfg.device_budget_bytes, impl=impl,
                       dim_hint=dim_hint, tile_format=cfg.tile_format,
                       bucket_floor=cfg.packed_bucket_floor,
                       streaming_mode=cfg.streaming_mode,
                       value_dtype=value_dtype, device=dev)
    # which streaming regime this config and graph land in (the plan is
    # per feature width; the layer's wider width is priced)
    qplan = ex.queue_plan(max(cfg.in_dim, h), "sum")
    return wrap_plan(
        {"n": g.num_vertices, "backend": "tiled", "device": dev,
         "tiled_exec": ex,
         "tiled_meta": {"q": ex.store.q, "tile": ex.store.tile,
                        "chunk": ex.chunk,
                        "order": tile_schedule_order(cfg.in_dim, h),
                        "host_bytes": ex.store.nbytes(),
                        "tile_format": ex.tile_format,
                        "format_choice": ex.format_choice,
                        "streaming_mode": ex.streaming_mode,
                        "value_dtype": ex.value_dtype,
                        "queue_plan": (dataclasses.asdict(qplan)
                                       if qplan else None),
                        "trainable": True,
                        "training": cfg.training,
                        "resident_feature_bytes":
                            (2 if cfg.training else 1) * 4
                            * g.num_vertices * (cfg.in_dim + h)}})


def prepare_ring(g: COOGraph, cfg: EnGNConfig,
                 out_dim: Optional[int] = None, plan=None, mesh=None,
                 rel_normed: bool = False,
                 device: DeviceLike = None) -> PreparedPlan:
    """The `PreparedPlan` of the sharded ring backend (C2): destination
    vertices (and their stripe of edges) split into P shards, each
    keeping its stripe and accumulator while the source-feature shards
    rotate (`core/dataflow.py`).  The shards live on the mesh's device
    (`device`, `cuda` unless the caller passes "cpu", when no `mesh` is
    given), P sets of tensors on one device: shard d holds one tensor an
    operand for each source shard s, up to that pair's last live slot
    (`dataflow.pair_counts`; the reference pads every pair to one
    length, a price the budget gate still charges).

    `cfg.tile_format` picks the stripe carrier: dense T x T tiles,
    packed (row, col, val) entries at pow2 nnz buckets, or "auto",
    whichever stages fewer bytes (priced by `ring_stripe_bytes` before
    any build).  A prebuilt `plan` (either class) pins the format and
    is taken as built: a max plan's caller builds it from
    `max_plan_edges`'s graph, as this function and serving's ring gate
    do.

    `device_budget_bytes` is per shard and is checked against the plan as
    built: over it the plan spills to the streamed tiled executor
    (`auto_spill`) or raises, as the reference's does.  On `cuda` the P
    co-located shards must also fit the card's free memory together,
    else `DeviceBudgetExceeded` before anything is allocated; a gated
    dense stripe is priced by `check_gated_ring` (ROADMAP B6)."""
    from repro_torch.core import dataflow as df
    from repro_torch.distributed.sharding import ring_mesh
    h = out_dim if out_dim is not None else cfg.out_dim
    g, rel_normed = _maybe_fold_rel_norm(g, cfg, rel_normed)
    typed = (cfg.stage_contract == "typed" and g.rel is not None
             and g.num_relations > 1)
    if mesh is None:
        mesh = ring_mesh(cfg.ring_shards, cfg.ring_axis, device=device)
    dev, p = mesh.device, mesh.num_shards
    if plan is None:
        g = max_plan_edges(g, cfg, dev)
        fmt = cfg.tile_format
        if fmt == "auto":
            dense_b = df.ring_stripe_bytes(g, p, tile=cfg.tile,
                                           tile_format="dense")
            packed_b = df.ring_stripe_bytes(
                g, p, tile=cfg.tile, tile_format="packed",
                bucket_floor=cfg.packed_bucket_floor,
                value_dtype=cfg.tile_value_dtype)
            fmt = "packed" if packed_b < dense_b else "dense"
        if fmt == "packed":
            plan = df.build_packed_ring_shards(
                g, p, bucket_floor=cfg.packed_bucket_floor)
        else:
            plan = df.build_ring_tile_shards(g, p, tile=cfg.tile)
    packed = isinstance(plan, df.PackedRingShards)
    # the staged contracts widen the rotating shard: typed rotates the
    # (N, R*H) stacked payload, gated the (pc || x) 2F stream
    feat_f = cfg.in_dim
    if typed:
        feat_f = max(feat_f, g.num_relations * h)
    elif cfg.stage_contract == "gated":
        feat_f = max(feat_f, 2 * cfg.in_dim)
    feat_need = df.ring_feature_bytes(plan.n_loc, feat_f, h)
    if cfg.training:
        feat_need *= 2          # cotangent twins of the rotating shards
    need = plan.device_bytes() + feat_need
    if cfg.device_budget_bytes and need > cfg.device_budget_bytes:
        if not cfg.auto_spill:
            raise DeviceBudgetExceeded(
                f"ring backend needs ~{need} device bytes per shard "
                f"({p} shards), budget is {cfg.device_budget_bytes} "
                f"per shard (more shards shrink the stripe; "
                f"auto_spill=True streams tiles out-of-core instead)")
        return prepare_tiled(g, cfg, out_dim, device=dev,
                             rel_normed=rel_normed)
    if dev.type == "cuda":
        free = torch.cuda.mem_get_info(dev)[0]
        if p * need > free:
            raise DeviceBudgetExceeded(
                f"the ring's {p} shards are co-located on {dev}: {p} x "
                f"{need} B per shard is over the card's free memory "
                f"({free} B)")
        if cfg.stage_contract == "gated" and not packed:
            check_gated_ring(p, plan.s_max, plan.tile, cfg.in_dim,
                             cfg.device_budget_bytes, dev)
    if packed:
        operands = [plan.rows, plan.cols, plan.vals]
        if typed:
            if plan.rels is None:
                raise ValueError(
                    "typed stage contract needs a relation-typed ring "
                    "plan (build from the typed COOGraph)")
            operands.append(plan.rels)
            ring_fn = df.make_ring_typed_sum_packed(
                mesh, cfg.ring_axis, plan.n_loc, g.num_relations)
        elif cfg.stage_contract == "gated":
            ring_fn = df.make_ring_gated_packed(mesh, cfg.ring_axis,
                                                plan.n_loc)
        else:
            ring_fn = df.make_ring_packed_aggregate(
                mesh, cfg.ring_axis, cfg.aggregate_op, plan.n_loc)
    else:
        operands = [plan.blocks, plan.tile_row, plan.tile_col]
        if typed:
            if plan.tile_rel is None:
                raise ValueError(
                    "typed stage contract needs a relation-typed ring "
                    "plan (build from the typed COOGraph)")
            operands.append(plan.tile_rel)
            ring_fn = df.make_ring_typed_sum_tiled(
                mesh, cfg.ring_axis, plan.q_loc, plan.tile,
                g.num_relations)
        elif cfg.stage_contract == "gated":
            ring_fn = df.make_ring_gated_tiled(mesh, cfg.ring_axis,
                                               plan.q_loc, plan.tile)
        else:
            ring_fn = df.make_ring_tiled_aggregate(
                mesh, cfg.ring_axis, cfg.aggregate_op, plan.q_loc,
                plan.tile)

    # each shard pair's slots are uploaded up to its last live one: the
    # pads after it only exist to give the reference's stripes one static
    # shape, and swept eagerly they would all land on local row 0
    live = df.pair_counts(plan)

    def pairs(a: np.ndarray):
        """Shard d's operand: one tensor per source shard s."""
        return [[_upload(a[d, s, :live[d, s]], dev) for s in range(p)]
                for d in range(p)]
    return wrap_plan({
        "n": g.num_vertices, "backend": "ring", "device": dev,
        "ring_operands": tuple(pairs(a) for a in operands),
        "ring_counts": [_upload(c, dev) for c in plan.in_counts],
        "ring_fn": ring_fn,
        "ring_meta": {"shards": p, "padded": plan.padded_vertices,
                      "mesh": mesh, "tile": plan.tile,
                      "q_loc": plan.q_loc, "s_max": plan.s_max,
                      "nnzb": plan.nnzb, "device_bytes": need,
                      "tile_format": "packed" if packed else "dense",
                      "stats": plan.stats(cfg.in_dim, h)}})


def update_plan(plan: PreparedPlan, snapshot, cfg: EnGNConfig,
                out_dim: Optional[int] = None) -> PreparedPlan:
    """Re-price a `PreparedPlan` for one `EpochSnapshot` of graph
    updates, on the plan's own device.

    The streamed tiled backend absorbs the delta in place: the
    executor's stores merge incrementally (`TiledExecutor.
    apply_updates`, bitwise equal to a fresh build), then the budget
    gate re-fits the streaming step and re-prices the chunk-queue plan
    for the grown store (queue pricing is n- and nnz-dependent, so
    growth can demote a chunk-queue plan to the callback loop).  If the
    update-time width no longer fits the fitted step (e.g. a plan priced
    for inference updated under a training config, whose backward
    streams double the width), the plan falls back to a full
    `prepare_tiled`, which re-fits the tile: a re-plan, never a silent
    overflow.  Typed plans with `rel_normalize` rebuild too: the folded
    relation norms are degree-dependent, so a delta changes them all.

    Device-resident backends keep no mergeable host store, so the epoch
    graph re-runs `prepare_graph`, which re-prices the footprint and
    spills to tiled exactly as it would at cold start."""
    plan = wrap_plan(plan)
    dev = plan.device
    h = out_dim if out_dim is not None else cfg.out_dim
    if plan.backend != "tiled":
        return prepare_graph(snapshot.graph, cfg, out_dim, device=dev)
    if (cfg.rel_normalize and snapshot.graph.rel is not None
            and snapshot.graph.num_relations > 1):
        return prepare_tiled(snapshot.graph, cfg, out_dim, device=dev)
    ex: TiledExecutor = plan.carrier["tiled_exec"]
    ex.apply_updates(snapshot)
    dim = max(cfg.in_dim, h)
    try:
        ex.effective_chunk(dim * (2 if cfg.training else 1))
    except DeviceBudgetExceeded:
        # the grown graph broke the fitted step: a full re-plan re-fits
        # tile and chunk (and the spill chain) for the new size
        stats = ex.stats
        new = prepare_tiled(snapshot.graph, cfg, out_dim, device=dev)
        nex: TiledExecutor = new.carrier["tiled_exec"]
        nex.stats.delta_merges = stats.delta_merges
        nex.stats.store_builds += stats.store_builds
        return new
    qplan = ex.queue_plan(dim, "sum")
    meta = plan.carrier["tiled_meta"]
    meta.update(q=ex.store.q, host_bytes=ex.store.nbytes(),
                queue_plan=(dataclasses.asdict(qplan)
                            if qplan else None),
                resident_feature_bytes=(2 if cfg.training else 1) * 4
                * snapshot.graph.num_vertices * (cfg.in_dim + h))
    plan.carrier["n"] = snapshot.graph.num_vertices
    # re-derive the typed summary over the refreshed carrier
    return wrap_plan(dict(plan.carrier))


def _prepare_packed(g, cfg, d, h, store, packed, choice, order,
                    dev, rel_normed=False) -> PreparedPlan:
    """Packed carriers: pow2-bucket groups on CUDA, for the `rer_gather`
    kernels and, in a gated plan, the `rer_gather_gated` kernels, which
    gather both endpoints' projections per entry themselves; flat entry
    arrays for the plain versions on the CPU.  A gated plan takes flat
    entries on the CPU only.  A sum or gated plan on the card holds B2^T's
    source table too (the backward's source walk; a max plan's backward
    walks the work table).

    `tile_value_dtype="int8"` quantises the flat route's values once (one
    f32 scale for the whole graph, `packed_val_scale`: uploaded once, so
    no error feedback), dequantised in `_aggregate`, as the reference's
    XLA flat route does.  The gated contract keeps fp32 (its per-entry
    gates compound the rounding), and so do a CUDA plan's bucket groups,
    as the reference's TPU groups do: `blocks_meta["value_dtype"]` says
    which the plan holds."""
    from repro_torch.kernels import rer_gather
    if dev.type == "cpu":
        with stage("plan.groups"):
            flat = rer_gather.flat_entries(packed)
        if (cfg.tile_value_dtype == "int8"
                and cfg.stage_contract != "gated"):
            qv, sc, _ = quantize_int8_np(flat[2])
            d["packed_flat"] = tuple(_upload(a, dev)
                                     for a in (flat[0], flat[1], qv))
            d["packed_val_scale"] = sc
            tile_bytes = flat[0].nbytes + flat[1].nbytes + qv.nbytes + 4
        else:
            d["packed_flat"] = tuple(_upload(a, dev) for a in flat)
            tile_bytes = sum(a.nbytes for a in flat)
    else:
        with stage("plan.groups"):
            groups = rer_gather.prepare_packed_groups(
                packed, cfg.packed_bucket_floor)
        # a sum or gated plan on a card holds B2^T's table too, built
        # once with the plan
        d["packed_groups"] = upload_groups(
            groups, dev,
            source=dev.type == "cuda" and cfg.aggregate_op != "max")
        tile_bytes = sum(gr.nbytes() for gr in groups)
    # re-check the plan as built (the closed-form gate prices nnz bounds)
    act = 2 if cfg.training else 1
    need = tile_bytes + act * 4 * g.num_vertices * (cfg.in_dim + h)
    if cfg.device_budget_bytes and need > cfg.device_budget_bytes:
        if not cfg.auto_spill:
            raise DeviceBudgetExceeded(
                f"packed blocked plan needs ~{need} device bytes, budget "
                f"is {cfg.device_budget_bytes} (auto_spill=True streams "
                f"tiles out-of-core instead)")
        return prepare_tiled(g, cfg, h, device=dev, rel_normed=rel_normed)
    d["blocks_meta"] = {
        "q": store.q, "padded": store.padded_vertices,
        "order": order, "tile": store.tile,
        "tile_format": "packed", "format_choice": choice,
        "device_bytes": tile_bytes,
        "value_dtype": "int8" if "packed_val_scale" in d else "fp32"}
    return wrap_plan(d)


def _prepare_blocked_typed(g: COOGraph, cfg: EnGNConfig, d: Dict[str, Any],
                           h: int, dev: torch.device) -> PreparedPlan:
    """Carriers of the typed contract on "blocked".  tile_format "dense"
    keeps one `rer_spmm` plan per relation that has edges (each
    contracts its own H-wide slice of the stacked payload: the bitwise
    dense oracle, and one B1 launch per relation); "packed" / "auto"
    carry the flat merged entries with a per-entry relation column, one
    gather and one segment sum in all, and their (src, relation) pairs
    (`typed_pairs`: the rows the layer projects, and each entry's pair),
    built in the same `plan.groups` stage."""
    from repro_torch.graphs.partition import build_tile_store, pack_tile_store
    n, r, t = g.num_vertices, g.num_relations, cfg.tile
    order = tile_schedule_order(cfg.in_dim, h)
    q = -(-n // t)
    if cfg.tile_format == "dense":
        from repro_torch.kernels.rer_spmm import prepare_blocks
        w = g.weights()
        d["typed_blocks"] = []
        for rr in range(r):
            m = g.rel == rr
            if not m.any():
                continue
            b = coo_to_blocked(COOGraph(n, g.src[m], g.dst[m], w[m]), t,
                               order="column")
            blocks, brow, bcol = prepare_blocks(b.blocks, b.block_row,
                                                b.block_col, b.q)
            d["typed_blocks"].append(
                {"rel": rr, "q": b.q, "blocks": _upload(blocks, dev),
                 "block_row": _upload(brow, dev),
                 "block_col": _upload(bcol, dev)})
        d["blocks_meta"] = {"q": q, "padded": q * t, "order": order,
                            "tile": t, "tile_format": "dense",
                            "format_choice": None, "num_relations": r}
        return wrap_plan(d)
    from repro_torch.kernels.rer_gather import flat_entries
    from repro_torch.kernels.typed_pairs import TypedPairs, pair_table
    with stage("plan.tiles"):
        store = build_tile_store(g, t)
    with stage("plan.pack"):
        ps = pack_tile_store(store)
    del store
    with stage("plan.groups"):
        gsrc, gdst, gval = flat_entries(ps)
        tile_of = np.repeat(np.arange(ps.nnzb, dtype=np.int64),
                            np.diff(ps.entry_ptr))
        grel = ps.block_rel[tile_of].astype(np.int32)
        del tile_of
        pairs = pair_table(gsrc, grel, n, r)
    d["typed_flat"] = tuple(_upload(a, dev)
                            for a in (gsrc, gdst, gval, grel))
    with _upload_stage(dev):
        d["typed_pairs"] = TypedPairs(*pairs, dev)
    d["blocks_meta"] = {"q": ps.q, "padded": ps.padded_vertices,
                        "order": order, "tile": ps.tile,
                        "tile_format": "packed", "format_choice": None,
                        "num_relations": r}
    return wrap_plan(d)
