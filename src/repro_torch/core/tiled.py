"""The streamed out-of-core `tiled` backend (paper S5.1-S5.3).

Every other backend places the whole graph on the device.  Here the Q x Q
grid of edge tiles stays in host memory (`graphs.partition.EdgeTileStore`,
or its packed form) and `TiledExecutor` streams it to the device along
the adaptive tile schedule (Table 3 / Eq. 8):

  * column order (dst-stationary): one destination interval's (T, d)
    accumulator stays on the device for its whole sweep and is copied
    back once — the paper's Q x H writes;
  * row order (src-stationary): one source interval stays resident and
    every tile's partial is copied back to the host — the paper's
    Q^2 x H write term, as real device-to-host copies.

Host and device.  The graph and the features live on the host; every
reduce and every stage function runs on the executor's device (`cuda`
unless the caller asks for the CPU).  `aggregate` and `stream_map` take
host or device arrays and return CPU float32 tensors.

Double buffering: the next chunk's tiles are packed into pinned host
memory and copied on a copy stream before the current chunk's reduce is
issued; the compute stream waits on the copy's event only where it uses
the tiles.  Source intervals are copied from a pinned copy of the
features on the compute stream itself (they are small, and extraction
runs on them at once).

Chunk queue: when the packed entries and the features fit the budget
(`queue_plan`), `streaming_mode="auto"` stages the whole stream once and
a sum runs as one sweep with no per-chunk round trip — on the card
through the `chunk_queue` kernel over a ragged `TileQueue`.  A max on the
card takes the callback loop (the queue kernel is sum-only, as the TPU
kernel is); on the CPU it sweeps the slab queue, as the reference does.

`impl`: None runs the plain product for dense chunks and the kernels for
packed chunks and the queue on `cuda` (plain versions on the CPU);
"plain" runs the plain versions; "cuda" runs the kernels, dense chunks
through `rer_spmm` as one-interval launches.

Staged models stream too, for inference: `aggregate(rel_channels=H)`
runs R-GCN's typed sum in one sweep (each staged tile takes its own
relation's H-wide slice of the (C, T, R*H) payload stack once, before
the chunk product or B2's tile part), and `gated_aggregate` Gated-GCN's
gated sum (ph resident per destination interval, (pc || x) streamed;
plain PyTorch on every device, as the reference's are XLA).

Not ported yet, each raising `NotImplementedError` naming its ROADMAP
item: int8 tile values (A7), the transposed views and the streamed
backward, typed and gated included (A5/A7), `apply_updates` (A10), the
measured tile-format autotune (B queue).
"""
from __future__ import annotations

import dataclasses
from collections import OrderedDict
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.device import DeviceLike, resolve_device
from repro_torch.graphs.format import COOGraph
from repro_torch.graphs.partition import (EdgeTileStore, PackedTileStore,
                                          build_tile_store, chunk_tile_row,
                                          pack_tile_store,
                                          tile_schedule_order)
from repro_torch.kernels.autotune import packed_entry_bytes

_TRAINING = ("the streamed backward (transposed tile views, the max "
             "residual and the autograd wrappers) is not ported yet "
             "(ROADMAP A5, A7)")
_NOT_PORTED = {
    "int8": "int8 tile values are not ported yet (ROADMAP A7)",
    "updates": "incremental graph updates are not ported yet (ROADMAP A10)",
}


class DeviceBudgetExceeded(RuntimeError):
    """A dense execution path needs more device memory than the budget."""


def dense_footprint_bytes(num_vertices: int, num_edges: int, in_dim: int,
                          out_dim: int, backend: str = "segment",
                          tile: int = 256, has_val: bool = True,
                          num_shards: int = 1,
                          tile_format: str = "dense",
                          training: bool = False,
                          value_dtype: str = "fp32") -> int:
    """Device bytes a graph-resident backend needs — the gate that
    decides when to spill to the streamed executor.  `training=True`
    doubles every activation-shaped term (cotangent twins); the tile
    formats are priced in the bytes they stage (dense 4 T^2 per tile,
    packed pow2-bucketed entries, "auto" the cheaper); ring is priced
    per shard of a `num_shards`-device ring."""
    n, e, f, h = num_vertices, num_edges, in_dim, out_dim
    act = 2 if training else 1
    feat = act * 4 * n * (f + h)
    scale_b = 4 if value_dtype == "int8" else 0
    if backend == "segment":
        edges = e * (8 + (4 if has_val else 0))
        return feat + edges + act * 4 * e * max(f, h)
    if backend in ("blocked", "fused"):
        q = -(-n // tile)
        nnzb_ub = min(q * q, max(e, 1))
        dense = feat + 4 * nnzb_ub * tile * tile
        packed = (feat
                  + packed_entry_bytes(2 * e + 8 * nnzb_ub, value_dtype)
                  + (8 + scale_b) * nnzb_ub)
        if tile_format == "dense" or backend == "fused":
            return dense
        return packed if tile_format == "packed" else min(dense, packed)
    if backend == "ring":
        p = max(num_shards, 1)
        n_loc_raw = -(-n // p)
        t = max(1, min(tile, n_loc_raw))
        q_loc = -(-n_loc_raw // t)
        n_loc = q_loc * t
        q = p * q_loc
        per_dev_tiles = min(q_loc * q, p * max(e, 1))
        feat_ring = act * 4 * n_loc * (2 * f + h)
        dense = feat_ring + 4 * per_dev_tiles * t * t + 8 * per_dev_tiles
        packed = (feat_ring
                  + packed_entry_bytes(2 * e + 8 * p, value_dtype)
                  + scale_b * p + 4 * n_loc)
        if tile_format == "dense":
            return dense
        return packed if tile_format == "packed" else min(dense, packed)
    raise ValueError(backend)


def _step_bytes(tile: int, chunk: int, dim: int, x_cache: int) -> int:
    """Device bytes one streaming step holds: double-buffered tile
    chunks + the source-interval cache + the destination accumulator."""
    return 4 * (2 * (chunk * tile * tile + chunk * tile * dim)
                + x_cache * tile * dim
                + 2 * tile * dim)


def fit_tile_plan(budget_bytes: Optional[int], dim: int, tile: int = 256,
                  chunk: int = 8, x_cache: int = 2) -> Tuple[int, int]:
    """Largest (tile, chunk) whose streaming step fits the budget."""
    if not budget_bytes:
        return tile, chunk
    while _step_bytes(tile, chunk, dim, x_cache) > budget_bytes:
        if chunk > 1:
            chunk = chunk // 2
        elif tile > 8:
            tile = tile // 2
        else:
            raise DeviceBudgetExceeded(
                f"budget {budget_bytes}B cannot hold even a single "
                f"8x8 tile step at feature dim {dim}")
    return tile, chunk


# -- per-chunk steps ------------------------------------------------------

def _chunk_step_sum(acc, blocks, xs):
    # blocks (C, T, T) @ xs (C, T, d), reduced over the chunk -> (T, d)
    return acc.add_(torch.einsum("ktu,kuf->tf", blocks, xs))


def _chunk_step_max(acc, blocks, xs):
    # materialises (C, T, T, d): 134 MB at T=256, C=8, d=64
    b = blocks[..., None]
    vals = torch.where(b != 0.0, b * xs[:, None, :, :], -torch.inf)
    return torch.maximum(acc, vals.amax(dim=(0, 2)), out=acc)


def _finish_max(acc):
    return torch.where(torch.isneginf(acc), 0.0, acc)


# (C, device) -> (block_row zeros(C), block_col arange(C)) of a chunk
# launched as a one-interval blocked product: built once per width, so
# the kernel wrapper's memoised checks read back to the host only once
_CHUNK_INDEX: Dict[Tuple[int, str], Tuple[torch.Tensor, torch.Tensor]] = {}


def _chunk_index(c: int, dev: torch.device):
    key = (c, str(dev))
    hit = _CHUNK_INDEX.get(key)
    if hit is None:
        hit = (torch.zeros(c, dtype=torch.int32, device=dev),
               torch.arange(c, dtype=torch.int32, device=dev))
        _CHUNK_INDEX[key] = hit
    return hit


def _chunk_step_kernel(acc, blocks, xs, *, op: str, impl: str, q: int):
    """The chunk as a 1-destination-interval block-sparse product
    through `rer_spmm` (its kernel for impl "cuda" on a card, its plain
    version otherwise)."""
    from repro_torch.kernels.rer_spmm import ops as spmm_ops
    t, d = blocks.shape[1], xs.shape[-1]
    rows, cols = _chunk_index(q, xs.device)
    x2 = xs.reshape(q * t, d)
    if impl == "cuda":     # forward only: the streamed backward is not ported
        y = spmm_ops.blocked_spmm(blocks, rows, cols, x2, q=q, op=op)
    else:
        y = spmm_ops.blocked_spmm_plain(blocks, rows, cols, x2, q=q, op=op)
    y = y[:t]
    if op == "sum":
        return acc.add_(y)
    covered = (blocks != 0.0).any(dim=0).any(dim=1)
    return torch.where(covered[:, None], torch.maximum(acc, y), acc)


def _select_rel(xs, rels, *, r: int, h: int):
    """Per-tile relation slice of a stacked source payload: xs is the
    (C, T, R*H) interval stack, rels the chunk's (C,) tile edge types;
    returns the contiguous (C, T, H) stack each tile's product reads.
    The relation picks its slice once per staged tile, never in the
    inner loop."""
    c, t, ds = xs.shape
    if ds != r * h:
        raise ValueError((ds, r, h))
    idx = torch.arange(c, device=xs.device)
    return xs.reshape(c, t, r, h)[idx, :, rels].contiguous()


def _chunk_step_gated(acc, blocks, stream, res):
    """Gated forward chunk step on dense tiles: stream is the (C, T, 2F)
    (pc || x) source stack, res the resident (T, F) ph of the
    destination interval; accumulates sum val * sigmoid(ph[dst] +
    pc[src]) * x[src].  Materialises (C, T, T, F), as the reference."""
    f = res.shape[-1]
    pc, xs = stream[..., :f], stream[..., f:]
    z = torch.sigmoid(res[None, :, None, :] + pc[:, None, :, :])
    b = blocks[..., None]
    contrib = torch.where(b != 0.0, b * z * xs[:, None, :, :], 0.0)
    return acc.add_(contrib.sum(dim=(0, 2)))


def _packed_step_gated(acc, rows, cols, vals, stream, res):
    """Packed twin of `_chunk_step_gated`: gather both streamed halves at
    the entries' columns, recompute the gate, segment-sum over the
    resident interval's rows."""
    c, s = rows.shape
    t, f = res.shape
    gcols = (torch.arange(c, device=stream.device)[:, None] * t
             + cols.long()).reshape(c * s)
    flat = stream.reshape(c * t, stream.shape[-1])[gcols]
    rowsf = rows.reshape(c * s).long()
    v = vals.reshape(c * s)
    z = torch.sigmoid(res[rowsf] + flat[:, :f])
    contrib = torch.where((v != 0.0)[:, None], v[:, None] * z * flat[:, f:],
                          0.0)
    return acc.index_add_(0, rowsf, contrib)


def _tile_part_sum(blk, xj):
    return blk @ xj


def _tile_part_max(blk, xj):
    b = blk[:, :, None]
    vals = torch.where(b != 0.0, b * xj[None, :, :], -torch.inf)
    return vals.amax(dim=1)      # keeps -inf: the host merge is a max


# -- the executor ---------------------------------------------------------

@dataclasses.dataclass
class TiledStats:
    """Traffic counters, field for field the reference's."""
    steps: int = 0
    tiles: int = 0
    h2d_tile_bytes: int = 0
    h2d_x_bytes: int = 0
    d2h_bytes: int = 0
    x_loads: int = 0
    x_reuse_hits: int = 0
    # staged entries vs padded slots uploaded (dense slots T^2 per
    # tile, packed slots the pow2 nnz bucket)
    staged_nnz: int = 0
    staged_slots: int = 0
    packed_tile_bytes: int = 0
    dense_tile_bytes: int = 0
    # the streamed backward's traffic (not ported yet: stays 0)
    bwd_steps: int = 0
    bwd_tiles: int = 0
    bwd_h2d_tile_bytes: int = 0
    bwd_h2d_x_bytes: int = 0
    bwd_d2h_bytes: int = 0
    # chunk-queue staging: queues built, their slabs, eager sweeps, and
    # the bytes staged once.  On the card the ragged TileQueue the sum
    # kernel walks is counted too, at its real size (12 B per entry plus
    # the span pointers), where the reference counts its padded (K, S)
    # layout; on the CPU neither package builds one.
    queue_builds: int = 0
    queue_steps: int = 0
    queue_launches: int = 0
    queue_h2d_bytes: int = 0
    # value-plane bytes moved vs their f32 size (equal in fp32)
    quant_val_bytes: int = 0
    raw_val_bytes: int = 0
    # store builds vs incremental merges (merges not ported yet)
    store_builds: int = 0
    delta_merges: int = 0

    def fill_factor(self) -> float:
        """Real entries / padded slots staged so far."""
        if not self.staged_slots:
            return 1.0
        return self.staged_nnz / self.staged_slots

    def value_compression(self) -> float:
        if not self.raw_val_bytes:
            return 1.0
        return self.quant_val_bytes / self.raw_val_bytes

    def as_dict(self) -> Dict[str, float]:
        d = dataclasses.asdict(self)
        d["fill_factor"] = self.fill_factor()
        d["value_compression"] = self.value_compression()
        return d


@dataclasses.dataclass(frozen=True)
class QueuePlan:
    """A feasible chunk-queue staging: `steps` slabs of `slab` entries,
    `device_bytes` total resident footprint under the budget."""
    slab: int
    steps: int
    device_bytes: int


def _host_f32(a) -> np.ndarray:
    """A host float32 C-contiguous array of a numpy array or a tensor on
    any device."""
    if isinstance(a, torch.Tensor):
        a = a.detach().to("cpu", torch.float32).numpy()
    return np.ascontiguousarray(np.asarray(a, np.float32))


class TiledExecutor:
    """Streamed aggregate over a host-resident `EdgeTileStore` on one
    device.

    graph:          the COO graph to partition (tiles are built once).
    tile, chunk:    interval size T and tiles per device step; shrunk by
                    `fit_tile_plan` when `budget_bytes` is set.
    budget_bytes:   device bytes the streaming step must respect.
    impl:           None | "plain" | "cuda" (module docstring).
    tile_format:    "dense" | "packed" | "auto" (the byte cost model).
    streaming_mode: "auto" | "callback" | "chunk_queue".
    value_dtype:    "fp32" ("int8" is not ported yet).
    device:         `cuda` unless the caller passes "cpu".
    """

    def __init__(self, graph: COOGraph, tile: int = 256, chunk: int = 8,
                 budget_bytes: Optional[int] = None,
                 impl: Optional[str] = None, double_buffer: bool = True,
                 x_cache: int = 2, dim_hint: Optional[int] = None,
                 tile_format: str = "auto", bucket_floor: int = 8,
                 autotune_measure: bool = False,
                 streaming_mode: str = "auto",
                 value_dtype: str = "fp32", device: DeviceLike = None):
        from repro_torch.kernels.autotune import choose_tile_format
        if streaming_mode not in ("auto", "callback", "chunk_queue"):
            raise ValueError(streaming_mode)
        if value_dtype not in ("fp32", "int8"):
            raise ValueError(value_dtype)
        if value_dtype == "int8":
            raise NotImplementedError(_NOT_PORTED["int8"])
        if impl not in (None, "plain", "cuda"):
            raise ValueError(f"impl must be None, 'plain' or 'cuda', got "
                             f"{impl!r}")
        self.device = resolve_device(device)
        if self.device.type == "cuda" and self.device.index is None:
            # "cuda" names the current card; tensors report its index
            self.device = torch.device("cuda", torch.cuda.current_device())
        dim = dim_hint if dim_hint is not None else 128
        tile, chunk = fit_tile_plan(budget_bytes, dim, tile, chunk, x_cache)
        self.store: EdgeTileStore = build_tile_store(graph, tile)
        self.packed: Optional[PackedTileStore] = None
        if tile_format != "dense":
            self.packed = pack_tile_store(self.store)
            # the kernels read out of bounds on a bad index: check the
            # host store once, so no staged chunk reads back to the host
            for a in (self.packed.row_local, self.packed.col_local):
                if a.size and (int(a.min()) < 0 or int(a.max()) >= tile):
                    raise ValueError(f"packed entries outside [0, {tile})")
        self.format_choice = choose_tile_format(
            tile_format, self.packed, backend="tiled",
            bucket_floor=bucket_floor, measure=autotune_measure,
            value_dtype=value_dtype)
        self.tile_format = self.format_choice.fmt
        self.bucket_floor = self.format_choice.bucket_floor
        self.chunk = chunk
        self.budget_bytes = budget_bytes
        self.impl = impl
        self.double_buffer = double_buffer
        self.x_cache_cap = max(2, x_cache)
        self.streaming_mode = streaming_mode
        self.value_dtype = value_dtype
        self.stats = TiledStats(store_builds=1)
        self._xcache: OrderedDict = OrderedDict()
        # H of a typed aggregate in flight (`aggregate(rel_channels=H)`)
        self._rel_select: Optional[int] = None
        self._queue_cache: Dict[int, object] = {}
        self._tq = None
        self._counts_dev = None
        self._copy = (torch.cuda.Stream(self.device)
                      if self.device.type == "cuda" else None)

    # -- not ported yet ------------------------------------------------
    def transposed(self):
        raise NotImplementedError(_TRAINING)

    def aggregate_max_forward(self, x):
        raise NotImplementedError(_TRAINING)

    def max_vjp(self, x, y, cnt, g):
        raise NotImplementedError(_TRAINING)

    def apply_updates(self, snapshot):
        raise NotImplementedError(_NOT_PORTED["updates"])

    # -- public API ----------------------------------------------------
    def reset_stats(self):
        self.stats = TiledStats(store_builds=self.stats.store_builds,
                                delta_merges=self.stats.delta_merges)

    def effective_chunk(self, dim: int) -> int:
        """Re-fit the chunk for this call's feature dim.  The tile is
        fixed by the store, so only the chunk can shrink; if even one
        tile per step exceeds the budget the executor refuses."""
        if not self.budget_bytes:
            return self.chunk
        t, c = self.store.tile, self.chunk
        while (c > 1 and _step_bytes(t, c, dim, self.x_cache_cap)
                > self.budget_bytes):
            c = c // 2
        if _step_bytes(t, c, dim, self.x_cache_cap) > self.budget_bytes:
            raise DeviceBudgetExceeded(
                f"store tile {t} at feature dim {dim} exceeds the "
                f"{self.budget_bytes}B budget even with chunk=1; "
                f"rebuild the executor with dim_hint>={dim}")
        return c

    def queue_plan(self, d: int, op: str = "sum") -> Optional[QueuePlan]:
        """Can this aggregate run as a device-resident chunk queue?
        Prices the queue plus the sweep's working set — the resident
        (N, d) features, the (N+1, d) accumulator and per-slab output,
        one (slab, d) gather — against the budget, halving the slab
        (floor 256) until it fits.  None means the callback loop runs:
        streaming_mode="callback", no packed store, or over budget
        ("chunk_queue" raises instead)."""
        if self.streaming_mode == "callback" or self.packed is None:
            return None
        from repro_torch.kernels.chunk_queue.ops import queue_bytes
        m = max(self.packed.nnz, 1)
        n = self.store.num_vertices
        d = max(int(d), 1)

        def total(slab: int) -> Tuple[int, int, int]:
            slab = min(slab, m)
            steps = -(-m // slab)
            work = 4 * d * (slab + 2 * (n + 1)) + 4 * n * d
            return queue_bytes(m, slab, self.value_dtype) + work, slab, steps

        b, slab, steps = total(m)
        if self.budget_bytes:
            while b > self.budget_bytes and slab > 256:
                b, slab, steps = total(max(slab // 2, 256))
            if b > self.budget_bytes:
                if self.streaming_mode == "chunk_queue":
                    raise DeviceBudgetExceeded(
                        f"chunk queue needs {b}B at the floor slab, "
                        f"budget is {self.budget_bytes}B")
                return None
        return QueuePlan(slab, steps, b)

    def _kernels(self) -> bool:
        """Whether the queue sum runs the CUDA walker's route."""
        return self.impl == "cuda" or (self.impl is None
                                       and self.device.type == "cuda")

    def _device_queue(self, slab: int):
        """Build (once per slab size) the slab queue on the device and
        account its one-time staging."""
        q = self._queue_cache.get(slab)
        if q is None:
            from repro_torch.kernels.chunk_queue.ops import build_chunk_queue
            q = build_chunk_queue(self.packed, slab=slab,
                                  value_dtype=self.value_dtype,
                                  device=self.device)
            self._queue_cache[slab] = q
            st = self.stats
            st.queue_builds += 1
            st.queue_steps += q.steps
            st.queue_h2d_bytes += q.device_bytes()
            st.quant_val_bytes += q.vals.numel() * q.vals.element_size()
            st.raw_val_bytes += q.raw_value_bytes()
        return q

    def _tile_queue(self):
        """The ragged tile layout the CUDA walker sweeps (built once, on
        the kernels' route only)."""
        if self.value_dtype != "fp32" or not self._kernels():
            return None
        if self._tq is None:
            from repro_torch.kernels.chunk_queue.ops import build_tile_queue
            self._tq = build_tile_queue(self.packed, self.bucket_floor,
                                        device=self.device)
            self.stats.queue_h2d_bytes += self._tq.device_bytes()
        return self._tq

    def _counts_col(self) -> torch.Tensor:
        """(N, 1) in-edge counts, at least 1, on the device (built once):
        the divisor of a mean."""
        if self._counts_dev is None:
            self._counts_dev = torch.from_numpy(
                np.maximum(self.store.in_counts, 1.0))[:, None].to(
                    self.device)
        return self._counts_dev

    def _queue_eager(self, x: np.ndarray, op: str,
                     plan: QueuePlan) -> np.ndarray:
        """One queue sweep: x to the device once, the staged sweep (a
        mean divided there too), the result back."""
        from repro_torch.kernels.chunk_queue.ops import chunk_queue_aggregate
        base = "sum" if op == "mean" else op
        q = self._device_queue(plan.slab)
        self.stats.h2d_x_bytes += x.nbytes
        self.stats.x_loads += 1
        y = chunk_queue_aggregate(
            q, torch.from_numpy(x).to(self.device), op=base, impl=self.impl,
            tile_queue=self._tile_queue() if base == "sum" else None)
        self.stats.queue_launches += 1
        if op == "mean":
            y = y / self._counts_col()
        out = y.cpu().numpy()
        self.stats.d2h_bytes += out.nbytes
        return out

    def aggregate(self, x, op: str, order: str = "auto",
                  extract_fn: Optional[Callable] = None,
                  extract_dim: Optional[int] = None,
                  out_dim_hint: Optional[int] = None,
                  rel_channels: Optional[int] = None) -> torch.Tensor:
        """A(x), or A(extract(x)), streamed tile by tile; returns a CPU
        float32 (N, d) tensor.  `order` follows the adaptive scheduler
        when "auto": column iff F < 2H (Eq. 8), F the streamed width and
        H `out_dim_hint`.  `extract_fn` runs on the device on every
        source interval as it is loaded.

        `rel_channels=H` is the relation-typed sum: the streamed payload
        (x, or extract's output) is an (N, R*H) stack of per-relation
        messages and every staged tile reads the H-wide slice of its own
        `block_rel`, so a typed aggregate is one sweep, not R.  It needs
        a store built from a typed graph."""
        x = _host_f32(x)
        if x.shape[0] != self.store.num_vertices:
            raise ValueError((x.shape, self.store.num_vertices))
        d = extract_dim if extract_fn is not None else x.shape[1]
        if rel_channels is not None:
            if self.store.block_rel is None:
                raise ValueError(
                    "rel_channels needs a relation-typed tile store "
                    "(graph built with rel ids and num_relations > 1)")
            if d != self.store.num_relations * rel_channels:
                raise ValueError((d, self.store.num_relations,
                                  rel_channels))
            d = rel_channels
        if order == "auto":
            h = out_dim_hint if out_dim_hint is not None else d
            order = tile_schedule_order(x.shape[1], h)
        base_op = "sum" if op == "mean" else op
        if base_op not in ("sum", "max"):
            raise ValueError(op)
        # the queue kernel is sum-only: a max on the card streams
        queue_ok = base_op == "sum" or not (self.device.type == "cuda"
                                            and self.impl != "plain")
        if extract_fn is None and rel_channels is None and queue_ok:
            plan = self.queue_plan(d, base_op)
            if plan is not None:
                return torch.from_numpy(self._queue_eager(x, op, plan))
        self._xcache = OrderedDict()
        self._rel_select = rel_channels
        xh = self._pad_host(x)
        try:
            if order == "column":
                out = self._sweep_column(xh, base_op, extract_fn, d)
            elif order == "row":
                out = self._sweep_row(xh, base_op, extract_fn, d)
            else:
                raise ValueError(order)
        finally:
            self._rel_select = None
        self._xcache = OrderedDict()
        if op == "mean":
            out = out / np.maximum(self.store.in_counts, 1.0)[:, None]
        return torch.from_numpy(np.ascontiguousarray(out))

    def stream_map(self, fn: Callable, *arrays) -> torch.Tensor:
        """Apply `fn` interval by interval on the device (the update
        stage of a tiled layer): slices of the host arrays stream in,
        results stream back; one interval is resident at a time.
        Returns a CPU float32 tensor."""
        st = self.store
        hosts = [self._pad_host(_host_f32(a)) for a in arrays]

        def stage(i):
            return [self._h2d(self._interval(h, i)) for h in hosts]

        outs: List[np.ndarray] = []
        staged = stage(0)
        for i in range(st.q):
            cur = staged
            if self.double_buffer and i + 1 < st.q:
                staged = stage(i + 1)
            y = fn(*[self._ready(a, ev) for a, ev in cur])
            outs.append(y.cpu().numpy())
            self.stats.d2h_bytes += outs[-1].nbytes
            if not self.double_buffer and i + 1 < st.q:
                staged = stage(i + 1)
        return torch.from_numpy(np.concatenate(outs)[:st.num_vertices])

    def gated_aggregate(self, ph, pc, x) -> torch.Tensor:
        """Streamed gated sum (Eq. 4): y[d] = sum over edges (s -> d) of
        val * sigmoid(ph[d] + pc[s]) * x[s], in column order.  The
        dst-side gate input ph is the resident interval, so the gate
        costs no streaming beyond the doubled source payload (pc || x).
        Returns a CPU float32 (N, F) tensor."""
        ph, pc, x = (_host_f32(a) for a in (ph, pc, x))
        stream = np.ascontiguousarray(np.concatenate([pc, x], axis=1))
        return torch.from_numpy(self._sweep_gated(stream, ph))

    def _sweep_gated(self, stream: np.ndarray,
                     resident: np.ndarray) -> np.ndarray:
        """The gated forward's column sweep: `stream` is the two-half
        source payload staged per chunk, `resident` the per-destination
        interval half (ph), copied once per interval."""
        st = self.store
        t, q = st.tile, st.q
        f = resident.shape[1]
        chunk = self.effective_chunk(max(stream.shape[1], f))
        out = np.zeros((st.padded_vertices, f), np.float32)
        steps: List[Tuple[int, np.ndarray]] = []
        for i in range(q):
            for c in chunk_tile_row(st.row_tiles(i), chunk,
                                    snake=(i % 2 == 1)):
                steps.append((i, c))
        if not steps:
            return out[:st.num_vertices]
        self._xcache = OrderedDict()
        sh, rh = self._pad_host(stream), self._pad_host(resident)

        def flush(i, acc):
            hb = acc.cpu().numpy()
            self.stats.d2h_bytes += hb.nbytes
            out[i * t:(i + 1) * t] = hb

        staged = self._stage_chunk(steps[0][1], sh, None, chunk)
        acc = res = None
        cur_row: Optional[int] = None
        for s, (i, idx) in enumerate(steps):
            (payload, ev), xs = staged
            if i != cur_row:
                if cur_row is not None:
                    flush(cur_row, acc)
                acc = torch.zeros((t, f), dtype=torch.float32,
                                  device=self.device)
                hb = self._interval(rh, i)
                self.stats.h2d_x_bytes += 4 * t * f
                self.stats.x_loads += 1
                res = (torch.from_numpy(hb) if isinstance(hb, np.ndarray)
                       else hb.to(self.device, non_blocking=True))
                cur_row = i
            if self.double_buffer and s + 1 < len(steps):
                staged = self._stage_chunk(steps[s + 1][1], sh, None, chunk)
            payload = self._ready(payload, ev)
            if self.tile_format == "packed":
                acc = _packed_step_gated(acc, *payload, xs, res)
            else:
                acc = _chunk_step_gated(acc, payload, xs, res)
            self.stats.steps += 1
            if not self.double_buffer and s + 1 < len(steps):
                self._sync()
                staged = self._stage_chunk(steps[s + 1][1], sh, None, chunk)
        flush(cur_row, acc)
        self._xcache = OrderedDict()
        return out[:st.num_vertices]

    # -- host <-> device -----------------------------------------------
    def _pad_host(self, a: np.ndarray):
        """`a` zero-padded to the q*T rows of the tile grid; pinned when
        the device is a card, so interval copies are direct DMA."""
        rows = self.store.padded_vertices
        if self.device.type == "cpu":
            if a.shape[0] == rows:
                return a
            out = np.zeros((rows,) + a.shape[1:], np.float32)
            out[:a.shape[0]] = a
            return out
        out = torch.zeros((rows,) + a.shape[1:], dtype=torch.float32,
                          pin_memory=True)
        out[:a.shape[0]] = torch.from_numpy(a)
        return out

    def _interval(self, h, j: int):
        t = self.store.tile
        return h[j * t:(j + 1) * t]

    def _h2d(self, host):
        """Copy a host block to the device: on a card, from pinned
        memory on the copy stream, returning (tensor, event); the
        compute stream waits on the event where it uses the tensor."""
        if self.device.type == "cpu":
            return (torch.from_numpy(host) if isinstance(host, np.ndarray)
                    else host), None
        src = torch.from_numpy(host) if isinstance(host, np.ndarray) \
            else host
        if not src.is_pinned():
            src = src.pin_memory()
        compute = torch.cuda.current_stream(self.device)
        # allocated for the compute stream; the copy waits for the
        # compute issued so far, so a recycled block is never written
        # while an earlier reduce still reads it
        dst = torch.empty(src.shape, dtype=src.dtype, device=self.device)
        self._copy.wait_stream(compute)
        with torch.cuda.stream(self._copy):
            dst.copy_(src, non_blocking=True)
        ev = torch.cuda.Event()
        ev.record(self._copy)
        return dst, ev

    def _ready(self, tensor, ev):
        if ev is not None:
            torch.cuda.current_stream(self.device).wait_event(ev)
        return tensor

    def _src_interval(self, xh, j: int, ext):
        dev = self._xcache.get(j)
        if dev is not None:
            self.stats.x_reuse_hits += 1
            return dev
        hb = self._interval(xh, j)
        self.stats.h2d_x_bytes += 4 * self.store.tile * xh.shape[1]
        self.stats.x_loads += 1
        # on the compute stream: extraction runs on it at once
        dev = (torch.from_numpy(hb) if isinstance(hb, np.ndarray)
               else hb.to(self.device, non_blocking=True))
        if ext is not None:
            dev = ext(dev)
        self._xcache[j] = dev
        while len(self._xcache) > self.x_cache_cap:
            self._xcache.popitem(last=False)
        return dev

    def _stage_packed(self, idx, width: int, bucket: int):
        """Upload one group of packed tiles as one int32 block holding
        (rows, cols, vals) at the given bucket; returns ((payload,
        event), host bytes moved)."""
        rows, cols, vals = self.packed.pack(idx, width, bucket)
        tb = rows.nbytes + cols.nbytes + vals.nbytes
        self.stats.quant_val_bytes += vals.nbytes
        self.stats.raw_val_bytes += vals.nbytes
        block, ev = self._h2d(np.stack([rows, cols, vals.view(np.int32)]))
        return ((block[0], block[1], block[2].view(torch.float32)), ev), tb

    def _stage_dense(self, idx, width: int):
        t = self.store.tile
        blocks = self.store.densify(idx, np.zeros((width, t, t), np.float32))
        return self._h2d(blocks), blocks.nbytes

    def _stage_chunk(self, idx: np.ndarray, xh, ext, chunk: int):
        """Host->device for one chunk of tiles: the tile payload (dense
        (C, T, T), or packed (C, S) entries at the chunk's pow2 nnz
        bucket) and the (C, T, d) stack of their source intervals."""
        st = self.store
        t = st.tile
        k = idx.size
        if self.tile_format == "packed":
            ps = self.packed
            bucket = ps.bucket_of(idx, self.bucket_floor)
            staged, tb = self._stage_packed(idx, chunk, bucket)
            self.stats.packed_tile_bytes += tb
            self.stats.staged_nnz += int(
                (ps.entry_ptr[idx + 1] - ps.entry_ptr[idx]).sum())
            self.stats.staged_slots += chunk * bucket
        else:
            staged, tb = self._stage_dense(idx, chunk)
            self.stats.dense_tile_bytes += tb
            self.stats.staged_nnz += int(
                (st.edge_ptr[idx + 1] - st.edge_ptr[idx]).sum())
            self.stats.staged_slots += chunk * t * t
        self.stats.h2d_tile_bytes += tb
        self.stats.tiles += k
        xs = [self._src_interval(xh, int(j), ext) for j in st.block_col[idx]]
        # pad with a repeat of the first interval: its tiles are empty,
        # so it contributes nothing
        xs.extend(xs[0] for _ in range(chunk - k))
        xs = torch.stack(xs)
        if self._rel_select is not None:
            # typed store: each tile takes its relation's H-wide slice of
            # the (C, T, R*H) stack (pad tiles are empty: rel 0 is fine)
            rels = np.zeros(chunk, np.int64)
            rels[:k] = st.block_rel[idx]
            xs = _select_rel(xs, torch.from_numpy(rels).to(self.device),
                             r=st.num_relations, h=self._rel_select)
        return staged, xs

    def _packed_part(self, payload, xs, op: str):
        from repro_torch.kernels.rer_gather import ops as gather_ops
        rows, cols, vals = payload
        if self.impl == "plain":
            return gather_ops.packed_tile_part_plain(rows, cols, vals, xs,
                                                     op=op)
        return gather_ops.packed_tile_part(rows, cols, vals, xs, op=op,
                                           checked=True)

    def _chunk_step(self, acc, payload, xs, op: str, chunk: int):
        if self.tile_format == "packed":
            part = self._packed_part(payload, xs, op)
            return (acc.add_(part) if op == "sum"
                    else torch.maximum(acc, part, out=acc))
        if self.impl is not None:
            return _chunk_step_kernel(acc, payload, xs, op=op,
                                      impl=self.impl, q=chunk)
        if op == "sum":
            return _chunk_step_sum(acc, payload, xs)
        return _chunk_step_max(acc, payload, xs)

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.current_stream(self.device).synchronize()

    def _sweep_column(self, xh, op, ext, d) -> np.ndarray:
        """dst-stationary: the accumulator stays on the device for one
        destination interval; its tiles stream in S-shape chunks."""
        st = self.store
        t, q = st.tile, st.q
        chunk = self.effective_chunk(d)
        out = np.zeros((st.padded_vertices, d), np.float32)
        steps: List[Tuple[int, np.ndarray]] = []
        for i in range(q):
            for c in chunk_tile_row(st.row_tiles(i), chunk,
                                    snake=(i % 2 == 1)):
                steps.append((i, c))
        if not steps:
            return out[:st.num_vertices]

        def init_acc():
            fill = -torch.inf if op == "max" else 0.0
            return torch.full((t, d), fill, dtype=torch.float32,
                              device=self.device)

        def flush(i, acc):
            h = (_finish_max(acc) if op == "max" else acc).cpu().numpy()
            self.stats.d2h_bytes += h.nbytes
            out[i * t:(i + 1) * t] = h

        staged = self._stage_chunk(steps[0][1], xh, ext, chunk)
        acc = None
        cur_row: Optional[int] = None
        for s, (i, idx) in enumerate(steps):
            (payload, ev), xs = staged
            if i != cur_row:
                if cur_row is not None:
                    flush(cur_row, acc)
                acc = init_acc()
                cur_row = i
            if self.double_buffer and s + 1 < len(steps):
                # the next H2D is issued before this reduce (C7)
                staged = self._stage_chunk(steps[s + 1][1], xh, ext, chunk)
            acc = self._chunk_step(acc, self._ready(payload, ev), xs, op,
                                   chunk)
            self.stats.steps += 1
            if not self.double_buffer and s + 1 < len(steps):
                self._sync()
                staged = self._stage_chunk(steps[s + 1][1], xh, ext, chunk)
        flush(cur_row, acc)
        return out[:st.num_vertices]

    def _sweep_row(self, xh, op, ext, d) -> np.ndarray:
        """src-stationary: one source interval resident per column
        sweep; every tile's partial is copied back to the host (the
        paper's Q^2 x H writes)."""
        st = self.store
        t, q = st.tile, st.q
        fill = -np.inf if op == "max" else 0.0
        out = np.full((st.padded_vertices, d), fill, np.float32)
        steps: List[Tuple[int, int]] = []
        for j in range(q):
            tiles = st.col_tiles(j)
            if j % 2 == 1:
                tiles = tiles[::-1]
            steps.extend((j, int(k)) for k in tiles)
        if not steps:
            return np.zeros((st.num_vertices, d), np.float32)

        def stage(step):
            j, k = step
            self.stats.tiles += 1
            if self.tile_format == "packed":
                ps = self.packed
                bucket = ps.bucket_of([k], self.bucket_floor)
                staged, tb = self._stage_packed([k], 1, bucket)
                self.stats.packed_tile_bytes += tb
                self.stats.staged_nnz += int(ps.entry_ptr[k + 1]
                                             - ps.entry_ptr[k])
                self.stats.staged_slots += bucket
            else:
                staged, tb = self._stage_dense([k], 1)
                self.stats.dense_tile_bytes += tb
                self.stats.staged_nnz += int(st.edge_ptr[k + 1]
                                             - st.edge_ptr[k])
                self.stats.staged_slots += t * t
            self.stats.h2d_tile_bytes += tb
            x_dev = self._src_interval(xh, j, ext)
            if self._rel_select is not None:
                h = self._rel_select
                r_k = int(st.block_rel[k])
                x_dev = x_dev[:, r_k * h:(r_k + 1) * h].contiguous()
            return staged, x_dev

        staged = stage(steps[0])
        for s, (j, k) in enumerate(steps):
            (payload, ev), x_dev = staged
            if self.double_buffer and s + 1 < len(steps):
                staged = stage(steps[s + 1])
            part = self._tile_part(self._ready(payload, ev), x_dev, op)
            self.stats.steps += 1
            hp = part.cpu().numpy()                   # partial spill (D2H)
            self.stats.d2h_bytes += hp.nbytes
            i = int(st.block_row[k])
            rows = slice(i * t, (i + 1) * t)
            if op == "sum":
                out[rows] += hp
            else:
                np.maximum(out[rows], hp, out=out[rows])
            if not self.double_buffer and s + 1 < len(steps):
                staged = stage(steps[s + 1])
        if op == "max":
            out = np.where(np.isneginf(out), 0.0, out).astype(np.float32)
        return out[:st.num_vertices]

    def _tile_part(self, blk, x_dev, op: str):
        if self.tile_format == "packed":
            return self._packed_part(blk, x_dev[None], op)
        if self.impl is not None:
            # a single-tile chunk through rer_spmm; the -inf / zero init
            # makes the result exactly the raw partial
            t, d = blk.shape[1], x_dev.shape[1]
            fill = -torch.inf if op == "max" else 0.0
            init = torch.full((t, d), fill, dtype=torch.float32,
                              device=x_dev.device)
            return _chunk_step_kernel(init, blk, x_dev[None], op=op,
                                      impl=self.impl, q=1)
        if op == "sum":
            return _tile_part_sum(blk[0], x_dev)
        return _tile_part_max(blk[0], x_dev)


def make_streamed_aggregate(ex: TiledExecutor, op: str):
    raise NotImplementedError(_TRAINING)


def make_streamed_typed_sum(ex: TiledExecutor):
    raise NotImplementedError(_TRAINING)


def make_streamed_gated(ex: TiledExecutor):
    raise NotImplementedError(_TRAINING)
