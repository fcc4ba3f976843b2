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
Where the queue kernels do not take the store's interval height
(`chunk_queue.queue_kernels_take`: T above 32,768), the kernel route
declines the queue and the callback loop runs.

int8 tile values (`value_dtype="int8"`, packed stores only): the packed
values travel as int8 with one f32 scale per staged tile (or per queue
slab), quantised on the host with error feedback (the executor's
`quantizer`, a `StreamingTileQuantizer` over the packed store's
entries; the transposed executor has its own), and dequantise on the
device (`q.float() * s[:, None]`), so B2's tile part and the plain steps
see fp32 values.  A staged group goes up as one byte buffer.  An int8
queue keeps the slab sweep on every device, the reference's route: its
walker is fp32-only, and its int8 sweep is XLA, not Pallas.
`stats.quant_val_bytes` / `raw_val_bytes` count the value bytes moved
against their f32 size.

`impl`: None runs the plain product for dense chunks and the kernels for
packed chunks and the queue on `cuda` (plain versions on the CPU);
"plain" runs the plain versions; "cuda" runs the kernels, dense chunks
through `rer_spmm` as one-interval launches.

Staged models stream too: `aggregate(rel_channels=H)` runs R-GCN's
typed sum in one sweep (each staged tile takes its own relation's H-wide
slice of the (C, T, R*H) payload stack once, before the chunk product or
B2's tile part), and `gated_aggregate` Gated-GCN's gated sum (ph resident
per destination interval, (pc || x) streamed; plain PyTorch on every
device, as the reference's are XLA).

Training.  `make_streamed_aggregate`, `make_streamed_typed_sum` and
`make_streamed_gated` are the differentiable aggregates (autograd
Functions over device tensors; only the graph stays on the host).  On
the queue route a sum's backward is B5^T over the forward `TileQueue`;
on the callback route the backward re-streams the transposed stores
(`transposed()`, a zero-copy swap of the host arrays), recomputing each
max's winners (`aggregate_max_forward` keeps the tie counts) and each
gate instead of keeping edge-shaped residuals; its traffic is counted in
`stats.bwd_*`.  The step helpers of the max, typed and gated passes are
plain PyTorch on every device, as the reference's are XLA.

`autotune_measure=True` times the tile formats on the executor's device
(`kernels.autotune.measured_choice`).

Dynamic graphs.  `apply_updates` merges one epoch's edge delta into the
host stores in place (`graphs/updates.py`: bitwise equal to a fresh
build of the epoch graph) and drops every piece of state derived from
the old stores: the x-cache, the transposed view, the differentiable
callables, the slab queues and their max closures, the `TileQueue`
(with B5's row-sorted copy and B5^T's source table), its price, the
mean's device counts and the int8 quantiser, rebuilt for the new
store's entries.  Each is rebuilt lazily on the next call.
"""
from __future__ import annotations

import copy
import dataclasses
from collections import OrderedDict
from functools import partial
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.device import DeviceLike, resolve_device
from repro_torch.distributed.compression import StreamingTileQuantizer
from repro_torch.graphs.format import COOGraph
from repro_torch.graphs.partition import (EdgeTileStore, PackedTileStore,
                                          build_tile_store, chunk_tile_row,
                                          pack_tile_store,
                                          tile_schedule_order,
                                          transpose_packed_store,
                                          transpose_tile_store)
from repro_torch.kernels.autotune import packed_entry_bytes

# the card allocates in 512 B blocks: the queue route's two dozen-odd
# tensors round up by this much at most
_ALLOC_SLACK = 512 * 32


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


def _merge_max_count(acc_val, acc_cnt, m, c):
    """Associative merge of (running max, tie count) pairs: a strictly
    better chunk replaces the count, an exact tie adds to it (the -inf
    'no edges yet' state never ties, thanks to the isfinite mask)."""
    better = m > acc_val
    ties = (m == acc_val) & torch.isfinite(m)
    return (torch.maximum(acc_val, m),
            torch.where(better, c, acc_cnt + torch.where(ties, c, 0.0)))


def _chunk_step_max_count(acc_val, acc_cnt, blocks, xs):
    """Max chunk step that also counts, per (dst row, feature), the edge
    products achieving the maximum: the residual the streamed backward
    splits the cotangent by (the reference's `segment_max` convention)."""
    b = blocks[..., None]
    vals = torch.where(b != 0.0, b * xs[:, None, :, :], -torch.inf)
    m = vals.amax(dim=(0, 2))
    c = ((vals == m[None, :, None, :]) & torch.isfinite(vals)).sum(
        dim=(0, 2), dtype=torch.float32)
    return _merge_max_count(acc_val, acc_cnt, m, c)


def _gather_cols(cols, xs):
    """The (C*S, F) rows of a (C, T, F) interval stack at a chunk's
    (C, S) local columns, and the flat (C*S,) index into it."""
    c, s = cols.shape
    t = xs.shape[1]
    gcols = (torch.arange(c, device=xs.device)[:, None] * t
             + cols.long()).reshape(c * s)
    return xs.reshape(c * t, xs.shape[2])[gcols], gcols


def _packed_step_max_count(acc_val, acc_cnt, rows, cols, vals, xs):
    """Packed twin of `_chunk_step_max_count`: the products are the
    floats the packed forward computes, so the captured max and counts
    agree with it bit for bit."""
    t, f = xs.shape[1], xs.shape[2]
    gathered, _ = _gather_cols(cols, xs)
    v = vals.reshape(-1)
    scaled = torch.where((v != 0.0)[:, None], v[:, None] * gathered,
                         -torch.inf)
    seg = rows.reshape(-1).long()
    m = torch.full((t, f), -torch.inf, dtype=torch.float32, device=xs.device)
    m.scatter_reduce_(0, seg[:, None].expand(-1, f), scaled, "amax",
                      include_self=True)
    hit = ((scaled == m[seg]) & (v != 0.0)[:, None]).to(torch.float32)
    cnt = torch.zeros((t, f), dtype=torch.float32,
                      device=xs.device).index_add_(0, seg, hit)
    return _merge_max_count(acc_val, acc_cnt, m, cnt)


def _chunk_maxbwd_dense(acc, xv, blocks, ygs):
    """One transposed backward chunk of the max (dense tiles): `blocks`
    are the TRANSPOSED tiles (rows src-local u, columns dst-local t), `xv`
    the resident source interval, `ygs` the streamed (y || g/cnt) stack
    of the destination intervals.  Each edge product is recomputed from
    the forward's operands (B^T[u, t] == B[t, u]), so the winner test is
    an exact equality."""
    d = ygs.shape[-1] // 2
    ys, gs = ygs[..., :d], ygs[..., d:]
    b = blocks[..., None]
    prod = torch.where(b != 0.0, b * xv[None, :, None, :], torch.inf)
    match = prod == ys[:, None, :, :]
    return acc.add_(torch.where(match, b * gs[:, None, :, :], 0.0).sum(
        dim=(0, 2)))


def _chunk_maxbwd_packed(acc, xv, rows, cols, vals, ygs):
    """Packed twin of `_chunk_maxbwd_dense`: rows and cols come from the
    transposed packed store, so `rows` index the resident source interval
    (and the gx accumulator) and `cols` the streamed (y, g/cnt) stack."""
    d = ygs.shape[-1] // 2
    v = vals.reshape(-1)
    srcl = rows.reshape(-1).long()
    at, _ = _gather_cols(cols, ygs)
    prod = v[:, None] * xv[srcl]
    match = (v != 0.0)[:, None] & (prod == at[:, :d])
    return acc.index_add_(0, srcl, torch.where(match, v[:, None] * at[:, d:],
                                               0.0))


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
    if impl == "cuda":     # under no_grad: the streamed backward re-streams
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


def _chunk_step_gated(acc, blocks, stream, res, mode: str = "fwd"):
    """Edgewise gated chunk step on dense tiles, one of three passes over
    the same sweep (materialises (C, T, T, F), as the reference):

      * "fwd": stream = (pc || x) source stacks, res = the resident ph of
        the destination interval; accumulates sum val * sigmoid(a) * x
        with a = ph[dst] + pc[src];
      * "dst": the same operands; accumulates sum val * sigmoid'(a) * x,
        the dst-side gate gradient before its elementwise g (the gate is
        recomputed, not kept);
      * "src": on the TRANSPOSED store, stream = (ph || g) destination
        stacks, res = the resident pc of the source interval; accumulates
        [sum val * sigmoid(a) * g, sum val * sigmoid'(a) * g], the gx half
        and the gpc half before its x."""
    f = res.shape[-1]
    b = blocks[..., None]
    mask = b != 0.0
    if mode in ("fwd", "dst"):
        pc, xs = stream[..., :f], stream[..., f:]
        z = torch.sigmoid(res[None, :, None, :] + pc[:, None, :, :])
        w = z if mode == "fwd" else z * (1.0 - z)
        contrib = torch.where(mask, b * w * xs[:, None, :, :], 0.0)
        return acc.add_(contrib.sum(dim=(0, 2)))
    ph, g = stream[..., :f], stream[..., f:]
    z = torch.sigmoid(ph[:, None, :, :] + res[None, :, None, :])
    wg = torch.where(mask, b * g[:, None, :, :], 0.0)
    gx = (wg * z).sum(dim=(0, 2))
    s2 = (wg * z * (1.0 - z)).sum(dim=(0, 2))
    return acc.add_(torch.cat([gx, s2], dim=1))


def _packed_step_gated(acc, rows, cols, vals, stream, res,
                       mode: str = "fwd"):
    """Packed twin of `_chunk_step_gated`: gather both streamed halves at
    the entries' columns, recompute the gate, segment-sum over the
    resident interval's rows."""
    f = res.shape[-1]
    flat, _ = _gather_cols(cols, stream)
    a_at, b_at = flat[:, :f], flat[:, f:]
    rowsf = rows.reshape(-1).long()
    v = vals.reshape(-1)
    live = (v != 0.0)[:, None]
    z = torch.sigmoid(res[rowsf] + a_at)
    if mode in ("fwd", "dst"):
        w = z if mode == "fwd" else z * (1.0 - z)
        return acc.index_add_(0, rowsf,
                              torch.where(live, v[:, None] * w * b_at, 0.0))
    wg = torch.where(live, v[:, None] * b_at, 0.0)
    return acc.index_add_(0, rowsf, torch.cat([wg * z, wg * z * (1.0 - z)],
                                              dim=1))


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
    # the streamed backward's traffic: the transposed re-stream (and the
    # gated dst-side sweep) counted apart from the forward's counters
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
    # store builds vs incremental merges (`apply_updates`)
    store_builds: int = 0
    delta_merges: int = 0

    def add_backward(self, other: "TiledStats"):
        """Fold one backward sweep's forward-shaped counters (the
        transposed executor counts its own streaming as forward) into
        this executor's bwd_* counters."""
        self.bwd_steps += other.steps
        self.bwd_tiles += other.tiles
        self.bwd_h2d_tile_bytes += other.h2d_tile_bytes
        self.bwd_h2d_x_bytes += other.h2d_x_bytes
        self.bwd_d2h_bytes += other.d2h_bytes

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
    tile_format:    "dense" | "packed" | "auto" (the byte cost model, or
                    the timed sample with `autotune_measure`).
    streaming_mode: "auto" | "callback" | "chunk_queue".
    value_dtype:    "fp32" | "int8": how packed tile values travel (int8
                    needs a packed store: not tile_format="dense").
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
            store=self.store, dim=dim, value_dtype=value_dtype,
            device=self.device)
        self.tile_format = self.format_choice.fmt
        self.bucket_floor = self.format_choice.bucket_floor
        if value_dtype == "int8" and self.packed is None:
            raise ValueError(
                "value_dtype='int8' quantises packed tile values; "
                "tile_format='dense' has no packed value plane")
        self.chunk = chunk
        self.budget_bytes = budget_bytes
        self.impl = impl
        self.double_buffer = double_buffer
        self.x_cache_cap = max(2, x_cache)
        self.streaming_mode = streaming_mode
        self.value_dtype = value_dtype
        self.stats = TiledStats(store_builds=1)
        self._init_derived_state()
        self._copy = (torch.cuda.Stream(self.device)
                      if self.device.type == "cuda" else None)

    def _init_derived_state(self):
        """Fresh state derived from the stores: x-cache, transposed view,
        differentiable callables, queue caches and the error-feedback
        quantiser (at construction, for a derived view, and after a
        merge)."""
        self._xcache: OrderedDict = OrderedDict()
        self._transposed: Optional["TiledExecutor"] = None
        # one differentiable callable per op (`make_streamed_*`)
        self._diff_cache: Dict[str, Callable] = {}
        # H of a typed aggregate in flight (`aggregate(rel_channels=H)`)
        self._rel_select: Optional[int] = None
        self._queue_cache: Dict[int, object] = {}
        self._queue_max_diff: Dict[int, Callable] = {}
        self._tq = None
        self._tq_price = None
        self._counts_dev = None
        self.quantizer = None
        if self.value_dtype == "int8" and self.packed is not None:
            self.quantizer = StreamingTileQuantizer(self.packed.nnz)

    @classmethod
    def _from_stores(cls, store: EdgeTileStore,
                     packed: Optional[PackedTileStore], *,
                     like: "TiledExecutor") -> "TiledExecutor":
        """An executor over prebuilt stores that inherits every streaming
        parameter of `like` (tile, chunk, budget, format, value dtype,
        device, copy stream), with its own stats, caches and quantiser and
        no device queue."""
        ex = copy.copy(like)
        ex.store = store
        ex.packed = packed
        ex.stats = TiledStats()
        ex._init_derived_state()
        return ex

    def transposed(self) -> "TiledExecutor":
        """The A^T view of this executor (built once): the same host edge
        arrays with source and destination swapped (zero copy, see
        `transpose_tile_store`), the same streaming parameters, its own
        stats.  The streamed backward re-streams these tiles instead of
        keeping forward activations on the device."""
        if self._transposed is None:
            tps = (transpose_packed_store(self.packed)
                   if self.packed is not None else None)
            self._transposed = TiledExecutor._from_stores(
                transpose_tile_store(self.store), tps, like=self)
        return self._transposed

    def apply_updates(self, snapshot):
        """Merge one `EpochSnapshot` delta into this executor's stores
        in place — no full rebuild (`stats.store_builds` stays put,
        `stats.delta_merges` counts the epochs).  The merged stores are
        bitwise equal to building fresh from `snapshot.graph`, so every
        aggregate after the merge matches a from-scratch executor; all
        state derived from the old stores (module docstring) is dropped
        and rebuilt lazily.  `format_choice` is kept.  Returns the
        `StoreDelta`."""
        from repro_torch.graphs.updates import (update_packed_store,
                                                update_tile_store)
        new_store, delta = update_tile_store(
            self.store, snapshot.batch, snapshot.graph.num_vertices)
        if self.packed is not None:
            self.packed = update_packed_store(self.packed, new_store,
                                              delta)
        self.store = new_store
        self._init_derived_state()
        self.stats.delta_merges += 1
        return delta

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

    def queue_plan(self, d: int, op: str = "sum",
                   training: bool = False) -> Optional[QueuePlan]:
        """Can this aggregate run as a device-resident chunk queue?
        Prices the queue plus the sweep's working set — the resident
        (N, d) features, the (N+1, d) accumulator and per-slab output,
        one (slab, d) gather — against the budget, halving the slab
        (floor 256) until it fits.  None means the callback loop runs:
        streaming_mode="callback", no packed store, or over budget
        ("chunk_queue" raises instead).

        A sum or mean on the kernel route (fp32 values: an int8 queue
        keeps the slab sweep) holds more, and is priced at what it holds:
        the slab queue it stages, the walker's `TileQueue`
        (`tile_queue_bytes`), x, y (and a mean's quotient), B5's
        split-interval scratch and, with `training`, the cotangent (and a
        mean's quotient of it), dX and B5^T's split-interval scratch
        where it is the larger.  Where the queue kernels do not take the
        store's interval height (`queue_kernels_take`), that route is
        declined as an over-budget queue is."""
        if self.streaming_mode == "callback" or self.packed is None:
            return None
        from repro_torch.kernels.chunk_queue.ops import (TILE_MAX,
                                                         queue_bytes,
                                                         queue_kernels_take)
        m = max(self.packed.nnz, 1)
        n = self.store.num_vertices
        d = max(int(d), 1)
        kernel = (op in ("sum", "mean") and self._kernels()
                  and self.value_dtype == "fp32")
        if kernel and not queue_kernels_take(self.store.tile):
            if self.streaming_mode == "chunk_queue":
                raise DeviceBudgetExceeded(
                    f"the chunk-queue kernels take intervals of at most "
                    f"{TILE_MAX} rows, the store's are {self.store.tile}")
            return None

        def total(slab: int) -> Tuple[int, int, int]:
            slab = min(slab, m)
            steps = -(-m // slab)
            work = (self._kernel_queue_bytes(d, op == "mean", training)
                    if kernel
                    else 4 * d * (slab + 2 * (n + 1)) + 4 * n * d)
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

    def _kernel_queue_bytes(self, d: int, mean: bool,
                            training: bool) -> int:
        """What a queue sum on the kernel route holds beside the slab
        queue (`queue_plan`), priced from the host store before anything
        is built."""
        if self._tq_price is None:
            from repro_torch.kernels.chunk_queue.ops import (sm_count,
                                                             tile_queue_bytes)
            self._tq_price = tile_queue_bytes(self.packed,
                                              n_sm=sm_count(self.device))
        tq_bytes, n_split, t_split = self._tq_price
        n, t = self.store.num_vertices, self.store.tile
        live = (3 if mean else 2) * (2 if training else 1)
        # B5's and B5^T's split-interval scratch live one at a time, each
        # only within its launch
        split = max(n_split, t_split) if training else n_split
        return (tq_bytes + 4 * n * d * live + 4 * n
                + 4 * split * (t * d + d) + _ALLOC_SLACK)

    def _queue_takes(self, base_op: str) -> bool:
        """Whether the queue runs this op here: the queue kernel is
        sum-only, so a max on the card streams (the callback loop)."""
        return base_op == "sum" or not (self.device.type == "cuda"
                                        and self.impl != "plain")

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
                                  quantizer=self.quantizer,
                                  device=self.device)
            self._queue_cache[slab] = q
            st = self.stats
            st.queue_builds += 1
            st.queue_steps += q.steps
            st.queue_h2d_bytes += q.device_bytes()
            vb = q.vals.numel() * q.vals.element_size()
            if q.value_dtype == "int8":
                vb += q.scales.numel() * q.scales.element_size()
            st.quant_val_bytes += vb
            st.raw_val_bytes += q.raw_value_bytes()
        return q

    def _tile_queue(self):
        """The ragged tile layout the CUDA walker sweeps (built once, on
        the kernels' route and for fp32 values only; None otherwise)."""
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
        if (extract_fn is None and rel_channels is None
                and self._queue_takes(base_op)):
            plan = self.queue_plan(d, op)
            if plan is not None:
                return torch.from_numpy(self._queue_eager(x, op, plan))
        return self._stream(x, op, order, extract_fn, d, rel_channels)

    def _stream(self, x: np.ndarray, op: str, order: str,
                extract_fn: Optional[Callable], d: int,
                rel_channels: Optional[int] = None) -> torch.Tensor:
        """The tile-by-tile sweep of `aggregate` (no queue), for host x;
        the differentiable callback route calls it directly, having
        decided its route already."""
        base_op = "sum" if op == "mean" else op
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
        return torch.from_numpy(self._sweep_gated(stream, ph, "fwd"))

    # -- the reverse path --------------------------------------------------
    def aggregate_max_forward(self, x) -> Tuple[torch.Tensor, torch.Tensor]:
        """Streamed max that also captures the backward's residual:
        returns CPU float32 (y, counts), counts[i, f] the number of edge
        products achieving y[i, f].  Column order only: the (max, count)
        pair merges associatively per destination interval."""
        x = _host_f32(x)
        if x.shape[0] != self.store.num_vertices:
            raise ValueError((x.shape, self.store.num_vertices))
        st = self.store
        t, d = st.tile, x.shape[1]
        y = np.zeros((st.num_vertices, d), np.float32)
        cnt = np.zeros((st.num_vertices, d), np.float32)
        packed = self.tile_format == "packed"

        def init():
            return (torch.full((t, d), -torch.inf, dtype=torch.float32,
                               device=self.device),
                    torch.zeros((t, d), dtype=torch.float32,
                                device=self.device))

        def step(acc, payload, xs, res, idx):
            if packed:
                return _packed_step_max_count(*acc, *payload, xs)
            return _chunk_step_max_count(*acc, payload, xs)

        def flush(i, acc):
            hv = _finish_max(acc[0]).cpu().numpy()
            hc = acc[1].cpu().numpy()
            self.stats.d2h_bytes += hv.nbytes + hc.nbytes
            lo = i * t
            m = min(lo + t, st.num_vertices) - lo
            y[lo:lo + m] = hv[:m]
            cnt[lo:lo + m] = hc[:m]

        self._resident_sweep(x, d, init, step, flush)
        return torch.from_numpy(y), torch.from_numpy(cnt)

    def max_vjp(self, x, y, cnt, g) -> torch.Tensor:
        """Backward of the streamed max: re-stream the same tiles
        transposed, recompute every edge product against the saved max
        and scatter g / count to each tied winner (tile recomputation in
        place of resident activations, so the budget holds backward
        too).  Traffic lands in `stats.bwd_*`; returns CPU float32."""
        tex = self.transposed()
        tex.reset_stats()
        gn = _host_f32(g) / np.maximum(_host_f32(cnt), 1.0)
        yg = np.ascontiguousarray(np.concatenate([_host_f32(y), gn], axis=1))
        gx = tex._sweep_max_backward(_host_f32(x), yg)
        self.stats.add_backward(tex.stats)
        return torch.from_numpy(gx)

    def _sweep_max_backward(self, x: np.ndarray,
                            yg: np.ndarray) -> np.ndarray:
        """On the TRANSPOSED executor: gx accumulates per source interval
        (this store's rows, resident x), the (y || g/cnt) stacks of the
        destination intervals stream through the chunks as x does
        forward."""
        st = self.store
        t, d = st.tile, yg.shape[1] // 2
        gx = np.zeros((st.padded_vertices, d), np.float32)
        packed = self.tile_format == "packed"

        def step(acc, payload, ygs, xv, idx):
            if packed:
                return _chunk_maxbwd_packed(acc, xv, *payload, ygs)
            return _chunk_maxbwd_dense(acc, xv, payload, ygs)

        self._resident_sweep(yg, 2 * d, self._zeros(t, d), step,
                             self._flush_into(gx), resident=x)
        return gx[:st.num_vertices]

    def typed_sum_vjp(self, g) -> torch.Tensor:
        """Backward of the relation-typed streamed sum: re-stream the
        TRANSPOSED typed tiles (a tile keeps its relation under the
        src <-> dst swap) and add each tile's partial into its relation's
        column block: the (N, R*H) cotangent of the stacked payload, as
        a CPU float32 tensor."""
        if self.store.block_rel is None:
            raise ValueError("typed_sum_vjp needs a relation-typed store")
        tex = self.transposed()
        tex.reset_stats()
        gx = tex._sweep_relscatter(_host_f32(g))
        self.stats.add_backward(tex.stats)
        return torch.from_numpy(gx)

    def _sweep_relscatter(self, g: np.ndarray) -> np.ndarray:
        """On the TRANSPOSED executor: a column sweep whose (T, R, H)
        accumulator takes each tile's partial in its own relation's block
        (the adjoint of `_select_rel`).  A chunk's tiles are put in
        relation order on the device and each relation's run goes through
        the forward's chunk step (B2's tile part on packed tiles), so a
        chunk costs one launch per relation it holds."""
        st = self.store
        t, r, h = st.tile, st.num_relations, g.shape[1]
        gx = np.zeros((st.padded_vertices, r * h), np.float32)
        packed = self.tile_format == "packed"

        def step(acc, payload, gs, res, idx):
            rels = st.block_rel[idx]
            order = np.argsort(rels, kind="stable")
            if np.any(order != np.arange(order.size)):
                perm = torch.from_numpy(order).to(self.device)
                payload = (tuple(p.index_select(0, perm) for p in payload)
                           if packed else payload.index_select(0, perm))
                gs = gs.index_select(0, perm)
            rels = rels[order]
            bounds = np.flatnonzero(np.diff(rels)) + 1
            for a, b in zip(np.r_[0, bounds], np.r_[bounds, rels.size]):
                part = (tuple(p[a:b] for p in payload) if packed
                        else payload[a:b])
                self._chunk_step(acc[:, int(rels[a])], part, gs[a:b], "sum",
                                 int(b - a))
            return acc

        def flush(i, acc):
            hb = acc.cpu().numpy().reshape(t, r * h)
            self.stats.d2h_bytes += hb.nbytes
            gx[i * t:(i + 1) * t] = hb

        self._resident_sweep(g, r * h, self._zeros(t, r, h), step, flush)
        return gx[:st.num_vertices]

    def gated_vjp(self, ph, pc, x, g
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """Backward of the streamed gated sum: two recompute sweeps, no
        edge-shaped residual.  A forward-oriented sweep gives the
        dst-side sum val * sigmoid'(a) * x (gph = g times it); the
        transposed sweep streams (ph || g) against the resident pc and
        yields gx = A_sigma^T g and the pc half of the gate's gradient.
        Both sweeps' traffic lands in `stats.bwd_*`.  Returns CPU float32
        (gph, gpc, gx)."""
        ph, pc, x, g = (_host_f32(a) for a in (ph, pc, x, g))
        saved, self.stats = self.stats, TiledStats()
        u = self._sweep_gated(
            np.ascontiguousarray(np.concatenate([pc, x], axis=1)), ph, "dst")
        dst_stats, self.stats = self.stats, saved
        self.stats.add_backward(dst_stats)
        tex = self.transposed()
        tex.reset_stats()
        both = tex._sweep_gated(
            np.ascontiguousarray(np.concatenate([ph, g], axis=1)), pc, "src")
        self.stats.add_backward(tex.stats)
        f = x.shape[1]
        return (torch.from_numpy(g * u), torch.from_numpy(x * both[:, f:]),
                torch.from_numpy(np.ascontiguousarray(both[:, :f])))

    def _sweep_gated(self, stream: np.ndarray, resident: np.ndarray,
                     mode: str) -> np.ndarray:
        """The column sweep the three gated passes share
        (`_chunk_step_gated` says what each mode computes): `stream` is
        the two-half source-side payload staged per chunk, `resident` the
        half copied once per row interval (ph forward, pc on the
        transposed "src" pass)."""
        st = self.store
        f = resident.shape[1]
        d_out = 2 * f if mode == "src" else f
        out = np.zeros((st.padded_vertices, d_out), np.float32)
        packed = self.tile_format == "packed"

        def step(acc, payload, xs, res, idx):
            if packed:
                return _packed_step_gated(acc, *payload, xs, res, mode)
            return _chunk_step_gated(acc, payload, xs, res, mode)

        self._resident_sweep(stream, max(stream.shape[1], d_out),
                             self._zeros(st.tile, d_out), step,
                             self._flush_into(out), resident=resident)
        return out[:st.num_vertices]

    def _zeros(self, *shape):
        return lambda: torch.zeros(shape, dtype=torch.float32,
                                   device=self.device)

    def _flush_into(self, out: np.ndarray):
        t = self.store.tile

        def flush(i, acc):
            hb = acc.cpu().numpy()
            self.stats.d2h_bytes += hb.nbytes
            out[i * t:(i + 1) * t] = hb
        return flush

    def _resident_sweep(self, stream: np.ndarray, width: int,
                        init: Callable, step: Callable, flush: Callable,
                        resident: Optional[np.ndarray] = None) -> None:
        """The column-order walk the gated passes, the max capture, its
        backward and the typed rel-scatter share: per row interval i,
        `init()` makes the accumulator on the device and the interval of
        `resident` (if any) is copied once; every S-shape chunk of the
        interval's tiles is staged from `stream` (double-buffered, the
        chunk fitted at `width`) and reduced by `step(acc, payload, xs,
        resident interval, tile indices)`; `flush(i, acc)` takes the
        finished interval."""
        st = self.store
        t, q = st.tile, st.q
        chunk = self.effective_chunk(width)
        steps = [(i, c) for i in range(q)
                 for c in chunk_tile_row(st.row_tiles(i), chunk,
                                         snake=(i % 2 == 1))]
        if not steps:
            return
        self._xcache = OrderedDict()
        sh = self._pad_host(stream)
        rh = self._pad_host(resident) if resident is not None else None
        staged = self._stage_chunk(steps[0][1], sh, None, chunk)
        acc = res = None
        cur_row: Optional[int] = None
        for s, (i, idx) in enumerate(steps):
            (payload, ev), xs = staged
            if i != cur_row:
                if cur_row is not None:
                    flush(cur_row, acc)
                acc = init()
                if rh is not None:
                    hb = self._interval(rh, i)
                    self.stats.h2d_x_bytes += 4 * t * rh.shape[1]
                    self.stats.x_loads += 1
                    res = (torch.from_numpy(hb) if isinstance(hb, np.ndarray)
                           else hb.to(self.device, non_blocking=True))
                cur_row = i
            if self.double_buffer and s + 1 < len(steps):
                staged = self._stage_chunk(steps[s + 1][1], sh, None, chunk)
            acc = step(acc, self._ready(payload, ev), xs, res, idx)
            self.stats.steps += 1
            if not self.double_buffer and s + 1 < len(steps):
                self._sync()
                staged = self._stage_chunk(steps[s + 1][1], sh, None, chunk)
        flush(cur_row, acc)
        self._xcache = OrderedDict()

    def _queue_traced(self, x: torch.Tensor, op: str,
                      plan: QueuePlan) -> torch.Tensor:
        """The differentiable queue route (`make_streamed_aggregate`): on
        the kernel route a sum is B5 over the TileQueue, whose backward is
        B5^T over the same queue; elsewhere the plain slab sweep, which
        autograd differentiates, and for a max over several slabs
        `make_queue_max_diff` (its tie counts carried across slabs).  x
        and the result lie on the device."""
        from repro_torch.kernels.chunk_queue import ops as cq_ops
        q = self._device_queue(plan.slab)
        base = "sum" if op == "mean" else op
        tq = self._tile_queue() if base == "sum" else None
        if tq is not None:
            y = cq_ops.tile_queue_aggregate(tq, x)
            self.stats.queue_launches += 1
        elif base == "max" and q.steps > 1:
            fn = self._queue_max_diff.get(plan.slab)
            if fn is None:
                fn = cq_ops.make_queue_max_diff(q)
                self._queue_max_diff[plan.slab] = fn
            y = fn(x)
        else:
            y = cq_ops.queue_sweep_plain(q.gsrc, q.gdst, q.vals, q.scales, x,
                                         n=q.n, op=base)
        if op == "mean":
            y = y / self._counts_col()
        return y

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

    def _ready(self, payload, ev):
        """The staged payload, once the compute stream has waited for its
        copy; a callable payload (an int8 group) is finished here, on the
        compute stream."""
        if ev is not None:
            torch.cuda.current_stream(self.device).wait_event(ev)
        return payload() if callable(payload) else payload

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
        """Upload one group of packed tiles as one block holding (rows,
        cols, vals) at the given bucket; returns ((payload, event), host
        bytes moved).  int8 values travel quantised (`pack_quantized`,
        one scale per tile, error feedback through `self.quantizer`) in
        one byte buffer and dequantise on the device."""
        if self.value_dtype == "int8":
            rows, cols, qv, sc = self.packed.pack_quantized(
                idx, width, bucket, self.quantizer)
            tb = rows.nbytes + cols.nbytes + qv.nbytes + sc.nbytes
            self.stats.quant_val_bytes += qv.nbytes + sc.nbytes
            self.stats.raw_val_bytes += 4 * qv.size
            return self._stage_quantized(rows, cols, qv, sc), tb
        rows, cols, vals = self.packed.pack(idx, width, bucket)
        tb = rows.nbytes + cols.nbytes + vals.nbytes
        self.stats.quant_val_bytes += vals.nbytes
        self.stats.raw_val_bytes += vals.nbytes
        block, ev = self._h2d(np.stack([rows, cols, vals.view(np.int32)]))
        return ((block[0], block[1], block[2].view(torch.float32)), ev), tb

    def _stage_quantized(self, rows, cols, qv, sc):
        """One H2D copy of an int8 group: a byte buffer of rows and cols
        (int32), the int8 values (padded to a word) and the f32 scales;
        returns (payload, event), the payload a callable that views the
        buffer and dequantises `q.float() * s[:, None]` (the reference's
        `_dequant_tiles`) on the compute stream."""
        w, b = qv.shape
        m = w * b
        qw = -(-m // 4)                   # words of int8 values
        words = np.empty(2 * m + qw + w, np.int32)
        words[:m] = rows.reshape(-1)
        words[m:2 * m] = cols.reshape(-1)
        qbytes = words[2 * m:2 * m + qw].view(np.int8)
        qbytes[:m] = qv.reshape(-1)
        qbytes[m:] = 0
        words[2 * m + qw:] = sc.view(np.int32)
        block, ev = self._h2d(words)

        def finish():
            q = block[2 * m:2 * m + qw].view(torch.int8)[:m].reshape(w, b)
            s = block[2 * m + qw:].view(torch.float32)
            return (block[:m].reshape(w, b), block[m:2 * m].reshape(w, b),
                    q.to(torch.float32) * s[:, None])
        return finish, ev

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


# -- differentiable wrappers ----------------------------------------------

class _StreamedSum(torch.autograd.Function):
    """The callback route's sum: forward A x streamed tile by tile,
    backward A^T g streamed over the transposed stores.  Features in and
    gradients out are device tensors; only the graph stays on the host."""

    @staticmethod
    def forward(ctx, ex, x):
        ctx.ex = ex
        return ex._stream(_host_f32(x), "sum", "column", None,
                          x.shape[1]).to(x.device)

    @staticmethod
    def backward(ctx, g):
        ex = ctx.ex
        tex = ex.transposed()
        tex.reset_stats()
        gx = tex._stream(_host_f32(g), "sum", "column", None, g.shape[1])
        ex.stats.add_backward(tex.stats)
        return None, gx.to(g.device)


class _StreamedMax(torch.autograd.Function):
    """The callback route's max: the forward captures (y, tie counts) on
    the host where a gradient is wanted, the backward re-streams the
    transposed tiles (`TiledExecutor.max_vjp`)."""

    @staticmethod
    def forward(ctx, ex, x):
        ctx.ex = ex
        if not ctx.needs_input_grad[1]:
            return ex._stream(_host_f32(x), "max", "column", None,
                              x.shape[1]).to(x.device)
        y, cnt = ex.aggregate_max_forward(x)
        ctx.save_for_backward(x)
        ctx.host = (y, cnt)
        return y.to(x.device)

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        return None, ctx.ex.max_vjp(x, *ctx.host, g).to(g.device)


class _StreamedTypedSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, ex, x):
        ctx.ex = ex
        h = x.shape[1] // ex.store.num_relations
        return ex.aggregate(x, "sum", order="column", rel_channels=h).to(
            x.device)

    @staticmethod
    def backward(ctx, g):
        return None, ctx.ex.typed_sum_vjp(g).to(g.device)


class _StreamedGated(torch.autograd.Function):
    @staticmethod
    def forward(ctx, ex, ph, pc, x):
        ctx.ex = ex
        ctx.save_for_backward(ph, pc, x)
        return ex.gated_aggregate(ph, pc, x).to(x.device)

    @staticmethod
    def backward(ctx, g):
        grads = ctx.ex.gated_vjp(*ctx.saved_tensors, g)
        return (None,) + tuple(a.to(g.device) for a in grads)


def make_streamed_aggregate(ex: TiledExecutor, op: str) -> Callable:
    """The differentiable streamed aggregate, what makes the out-of-core
    backend trainable: a callable x -> A x (sum, mean, max) on device
    tensors, routed on each call as the reference routes at trace time:

      * queue route (`queue_plan` fits): on the kernel route a sum is B5
        forward and B5^T backward over the one device `TileQueue` (a mean
        divides by the in-counts); elsewhere the plain slab sweep, with
        `make_queue_max_diff` for a max over several slabs.  A max on the
        card takes the callback route: the queue kernel is sum-only;
      * callback route: the forward streams tile by tile (the max
        capturing its tie counts), the backward streams the transposed
        stores (`max_vjp` for a max), its traffic in `stats.bwd_*`.

    One callable per (executor, op).  Gradients flow to x only: the
    adjacency is a constant of the graph."""
    if op not in ("sum", "max", "mean"):
        raise ValueError(op)
    fn = ex._diff_cache.get(op)
    if fn is not None:
        return fn
    base = "sum" if op == "mean" else op

    def fn(x):
        plan = None
        if ex._queue_takes(base):
            plan = ex.queue_plan(int(x.shape[1]), op,
                                 training=(torch.is_grad_enabled()
                                           and x.requires_grad))
        if plan is not None:
            return ex._queue_traced(x, op, plan)
        if base == "max":
            return _StreamedMax.apply(ex, x)
        y = _StreamedSum.apply(ex, x)
        return y if op == "sum" else y / ex._counts_col()

    ex._diff_cache[op] = fn
    return fn


def make_streamed_typed_sum(ex: TiledExecutor) -> Callable:
    """The differentiable relation-typed streamed sum: x is the (N, R*H)
    stack of per-relation messages (R-GCN's x @ W_r for every r), each
    typed tile reads its own relation's slice, the output is the (N, H)
    sum over the typed edges; the backward re-streams the transposed
    typed tiles and adds each tile's partial into its relation's block
    (`typed_sum_vjp`)."""
    if ex.store.block_rel is None:
        raise ValueError("typed streamed sum needs a relation-typed "
                         "tile store")
    fn = ex._diff_cache.get("typed_sum")
    if fn is None:
        fn = partial(_StreamedTypedSum.apply, ex)
        ex._diff_cache["typed_sum"] = fn
    return fn


def make_streamed_gated(ex: TiledExecutor) -> Callable:
    """The differentiable streamed gated sum (Eq. 4): `gated(ph, pc, x)`
    with ph = x @ W_H, pc = x @ W_C returns sum_e val * sigmoid(ph[dst] +
    pc[src]) * x[src].  The projections stay ordinary autograd ops; the
    backward is two recompute sweeps (`gated_vjp`), no edge-shaped
    residual."""
    fn = ex._diff_cache.get("gated")
    if fn is None:
        fn = partial(_StreamedGated.apply, ex)
        ex._diff_cache["gated"] = fn
    return fn
