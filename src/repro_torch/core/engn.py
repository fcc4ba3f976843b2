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
or raises `DeviceBudgetExceeded`.

The resident backends train: their aggregates are autograd Functions
whose backwards walk the forward carrier itself (the dense tiles, or
the packed groups through their work table), sum and max alike, so a
backward builds no carrier of A^T and the plan holds after training
what it held after `prepare_graph` (`PreparedPlan.held_bytes`), as the
reference's, whose tiles XLA differentiates.  The budget gate prices
training as the reference does (`cfg.training=True` doubles the
activations).

The sharded "ring" backend, the typed/gated stage contracts and
training through "tiled" are not ported yet and raise
`NotImplementedError` naming their ROADMAP item; nothing falls back to
another backend.
"""
from __future__ import annotations

import dataclasses
from functools import partial
from typing import Any, Dict, Optional

import numpy as np
import torch
from torch import nn

from repro_torch.core.plan import PreparedPlan, plan_carrier, wrap_plan
from repro_torch.core.tiled import (DeviceBudgetExceeded, TiledExecutor,
                                    dense_footprint_bytes)
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.graphs.format import COOGraph, coo_to_blocked
from repro_torch.graphs.partition import tile_schedule_order

AggregateOp = str  # "sum" | "max" | "mean"

_NOT_PORTED = {
    "ring": "the sharded 'ring' backend is not ported yet (ROADMAP A8)",
    "train_tiled": "training through the streamed 'tiled' backend is not "
                   "ported yet (ROADMAP A5, A7); run inference under "
                   "torch.no_grad() or torch.inference_mode()",
    "staged": "the typed/gated stage contracts (R-GCN, Gated-GCN) are not "
              "ported yet (ROADMAP A3)",
    "int8": "int8 tile values are not ported yet (ROADMAP A7)",
}


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
    backend: str = "segment"           # "segment" | "blocked" | "fused"
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
        backend = graph.get("backend", self.cfg.backend)
        if backend == "tiled":
            return self._apply_tiled(graph, x)
        if backend == "ring":
            raise NotImplementedError(_NOT_PORTED[backend])
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
        if linear_sum and self.dasr_order() == "afu":
            return self.update(x, self.feature_extraction(agg(x)))  # (AX)W
        return self.update(x, agg(self.feature_extraction(x)))      # A(XW)

    # -- streamed out-of-core path (core/tiled.py) -------------------------
    def _apply_tiled(self, graph, x) -> torch.Tensor:
        """The layer through the streamed executor: extraction runs on
        each source interval as it is loaded, aggregation follows the
        adaptive tile schedule, and the update streams per destination
        interval.  Takes host or device x and returns a CPU float32
        tensor: the graph and the features stay on the host by design,
        every reduce and stage function runs on the executor's device."""
        cfg = self.cfg
        ex: TiledExecutor = graph["tiled_exec"]
        if ex.device != self.device:
            raise ValueError(f"the tiled plan streams to {ex.device}, the "
                             f"layer's parameters are on {self.device}")
        if torch.is_grad_enabled() and (
                any(p.requires_grad for p in self.parameters())
                or (isinstance(x, torch.Tensor) and x.requires_grad)):
            raise NotImplementedError(_NOT_PORTED["train_tiled"])
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
            raise NotImplementedError(_NOT_PORTED[backend])
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
            # CPU plans: one flat gather + segment reduce
            from repro_torch.kernels.rer_gather import packed_flat_plain
            y = packed_flat_plain(*graph["packed_flat"], xf,
                                  n=xf.shape[0], op=base_op)
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


def _pad_rows(graph: Dict[str, Any], x: torch.Tensor) -> torch.Tensor:
    """x (n, F) zero-padded to the tile grid's q*T rows."""
    n = graph["n"]
    xf = torch.zeros((graph["blocks_meta"]["padded"], x.shape[1]),
                     dtype=x.dtype, device=x.device)
    xf[:n] = x
    return xf


def _upload(a: np.ndarray, dev: torch.device) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a)).to(dev)


def upload_groups(groups, dev: torch.device):
    """A plan's bucket groups on `dev`, with the `rer_gather` kernel's
    work table built from the host arrays beside them (`PlanGroups`)."""
    from repro_torch.kernels.rer_gather import PlanGroups
    return PlanGroups(groups, dev)


def prepare_graph(g: COOGraph, cfg: EnGNConfig,
                  out_dim: Optional[int] = None,
                  device: DeviceLike = None) -> PreparedPlan:
    """Host-side 'format converter': build the `PreparedPlan` (typed
    attributes + the carrier dict of device tensors) for the configured
    backend, on `device` (`cuda` unless the caller passes "cpu"),
    spilling to the streamed "tiled" backend when the graph exceeds
    `cfg.device_budget_bytes` (or raising, without `auto_spill`)."""
    dev = resolve_device(device)
    backend = cfg.backend
    h = out_dim if out_dim is not None else cfg.out_dim
    if cfg.stage_contract is not None or cfg.rel_normalize:
        raise NotImplementedError(_NOT_PORTED["staged"])
    if cfg.device_budget_bytes and backend not in ("tiled", "ring"):
        need = dense_footprint_bytes(g.num_vertices, g.num_edges,
                                     cfg.in_dim, h, backend,
                                     tile=cfg.tile,
                                     has_val=g.val is not None,
                                     tile_format=cfg.tile_format,
                                     training=cfg.training,
                                     value_dtype=cfg.tile_value_dtype)
        if need > cfg.device_budget_bytes:
            if not cfg.auto_spill:
                raise DeviceBudgetExceeded(
                    f"backend {backend!r} needs ~{need} device bytes, "
                    f"budget is {cfg.device_budget_bytes} (set "
                    f"auto_spill=True or backend='tiled' to stream "
                    f"tiles out-of-core)")
            backend = "tiled"
    if backend == "tiled":
        return prepare_tiled(g, cfg, out_dim, device=dev)
    if backend == "ring":
        raise NotImplementedError(_NOT_PORTED[backend])
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
            d["rel_normed"] = False
        return wrap_plan(d)
    if backend not in ("blocked", "fused"):
        raise ValueError(backend)
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
        store = build_tile_store(g, cfg.tile)
        packed = pack_tile_store(store)
        choice = choose_tile_format(
            cfg.tile_format, packed, backend="blocked",
            bucket_floor=cfg.packed_bucket_floor)
        if choice.fmt == "packed":
            return _prepare_packed(g, cfg, d, h, store, packed, choice,
                                   order, dev)
    from repro_torch.kernels.rer_spmm import prepare_blocks
    b = coo_to_blocked(g, cfg.tile, order="column")
    blocks, brow, bcol = prepare_blocks(b.blocks, b.block_row, b.block_col,
                                        b.q)
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
                  device: DeviceLike = None) -> PreparedPlan:
    """The `PreparedPlan` of the streamed out-of-core backend: the Q x Q
    tile store stays in host memory, tile and chunk fitted to the
    device budget at the layer's wider feature width, streaming to
    `device` (`cuda` unless the caller passes "cpu")."""
    dev = resolve_device(device)
    h = out_dim if out_dim is not None else cfg.out_dim
    if cfg.stage_contract is not None or cfg.rel_normalize:
        raise NotImplementedError(_NOT_PORTED["staged"])
    dim_hint = max(cfg.in_dim, h) * (2 if cfg.training else 1)
    value_dtype = (cfg.tile_value_dtype if cfg.tile_format != "dense"
                   else "fp32")
    if value_dtype == "int8":
        raise NotImplementedError(_NOT_PORTED["int8"])
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
                        # the streamed backward is not ported yet (A5)
                        "trainable": False,
                        "training": cfg.training,
                        "resident_feature_bytes":
                            (2 if cfg.training else 1) * 4
                            * g.num_vertices * (cfg.in_dim + h)}})


def _prepare_packed(g, cfg, d, h, store, packed, choice, order,
                    dev) -> PreparedPlan:
    """Packed carriers: pow2-bucket groups for the `rer_gather` kernel on
    CUDA, flat entry arrays for the plain version on the CPU."""
    from repro_torch.kernels import rer_gather
    if cfg.tile_value_dtype == "int8":
        raise NotImplementedError(_NOT_PORTED["int8"])
    if dev.type == "cpu":
        flat = rer_gather.flat_entries(packed)
        d["packed_flat"] = tuple(_upload(a, dev) for a in flat)
        tile_bytes = sum(a.nbytes for a in flat)
    else:
        groups = rer_gather.prepare_packed_groups(packed,
                                                  cfg.packed_bucket_floor)
        d["packed_groups"] = upload_groups(groups, dev)
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
        return prepare_tiled(g, cfg, h, device=dev)
    d["blocks_meta"] = {
        "q": store.q, "padded": store.padded_vertices,
        "order": order, "tile": store.tile,
        "tile_format": "packed", "format_choice": choice,
        "device_bytes": tile_bytes, "value_dtype": "fp32"}
    return wrap_plan(d)
