"""The device-resident chunk queue of the streamed executor.

When the packed entries and the features both fit the device budget, the
streamed `tiled` backend stages the whole stream once and sweeps it on
the device with no per-chunk host round trip.  Two layouts of the same
packed tiles:

* `ChunkQueue` (`build_chunk_queue`): the merged entries as
  `(steps, slab)` global-index slabs, padding routed to the sacrificial
  row n; `queue_sweep_plain` sweeps it (one gather and one segment
  reduce per slab, sum or max).  It is the counterpart of the
  reference's `queue_sweep_xla` and the route on the CPU.  Its values
  are fp32, or int8 with one f32 scale per slab (`value_dtype="int8"`,
  quantised on the host by `distributed.compression.quantize_stream_np`,
  the reference's, with an error-feedback `StreamingTileQuantizer`); a
  slab dequantises on the device as it is swept.  An int8 queue is swept
  this way on every device, the card included: the reference's walker
  takes fp32 values only, and its int8 sweep is XLA, not Pallas.
* `TileQueue` (`build_tile_queue`): the tiles dst-sorted with each
  destination interval's span, for the hand-written CUDA kernel
  `csrc/chunk_queue.cu` (`tile_queue_aggregate`, sum with an optional
  relu), and the kernel's work table (`queue_work`), built with it on
  the host.  `tile_queue_plain` is its plain version.  A pass of the
  walker keeps a T x Fc block in shared memory; the wrapper picks Fc
  (`feature_chunk`), so a tall interval takes narrower passes.  Both
  queue kernels take intervals of at most `TILE_MAX` rows
  (`queue_kernels_take`, the one predicate the launchers and the
  executor's `queue_plan` share).

Backward.  `tile_queue_aggregate` is an autograd Function under grad:
its backward is B5^T (`tile_queue_t`, the second launcher of
`csrc/chunk_queue.cu`), dX[src] += val * G[dst] over the entries of the
FORWARD queue: no transposed queue is built, and no entry is copied for
it; its work table (`queue_src_work`) is per tile and per piece.  The
relu epilogue has no backward and is refused under grad.  On the slab
queue a sum or a single-slab max is differentiated by autograd through
`queue_sweep_plain`; a max over several slabs takes
`make_queue_max_diff`, which carries the tie counts across slabs so
the gradient keeps `segment_max`'s even split (the reference's).

Divergence of layout (not of result) from the reference: its
`TileQueue` pads every tile to one store-wide pow2 bucket, a `(K, S)`
layout whose size the hub tile sets; here the entries stay ragged, with
`entry_ptr` over the packed store's flat entries (12 B per real entry),
and the kernel walks its own row-sorted copy of them (12 B per real
entry more).  `n`, `tile`, `q`, `bucket`, `tile_ptr` and `tile_src` are
the reference's, exactly.

Source note.  `tile_queue_aggregate` replaces `repro/kernels/chunk_queue/
chunk_queue.py::chunk_queue_spmm` (`_queue_kernel`).  On the H100 it is
bound by bytes and gather latency: 12 B per entry plus one referenced
feature row.  Destination-stationary: one CTA per piece of an interval
keeps the interval's block in shared memory, its warps run RER-Gather's
walker over the piece; see the kernel source for its design.  B5^T
(`tile_queue_t`) is its adjoint, source-stationary: one CTA per piece of
a source interval loads the piece from the forward queue's own
tile-order entries (`queue_src_work`'s table), sorts it by source column
in shared memory and sums each column in registers; the reference
differentiates its XLA sweep, so it has no TPU kernel of its own.

Both builders follow the port's device rule: `device=None` is `cuda`,
and raises without a card.
"""
from __future__ import annotations

import ctypes
import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from repro_torch.device import DeviceLike, resolve_device
from repro_torch.distributed.compression import quantize_stream_np
from repro_torch.graphs.partition import PackedTileStore, pow2_bucket
from repro_torch.kernels import _build
from repro_torch.kernels._common import (_memo, check_status,
                                         check_tensor, refuse_grad,
                                         stream_handle)
from repro_torch.kernels.rer_gather.ops import flat_entries

# kernel launches, counted where the kernel is launched: the plain sum
# sweep, the sweep with relu folded into its flush, and B5^T
LAUNCHES = {"sum": 0, "sum_relu": 0, "sum_t": 0}

# most entries one CTA of the walker reduces: a longer interval span
# (the hub's, after the degree sort) is split across CTAs
SEGMENT = 4096
# dynamic shared memory a walker CTA may take (csrc/chunk_queue.cu)
_SMEM_MAX = 232448 - 128
# B5^T's pieces: one or two per streaming multiprocessor, at least
# PIECE_FLOOR and at most PIECE_MAX entries (`source_piece`); SMS is an
# H100 SXM's count, taken where no card says
PIECE_FLOOR = 256
PIECE_MAX = 2048
SMS = 132
# the tallest interval the queue kernels take: B5^T packs a local column
# below 2^15 with its rank into one int (csrc/chunk_queue.cu); B5's
# one-feature pass would fit up to _SMEM_MAX / 4 rows
TILE_MAX = 32768


def queue_kernels_take(tile: int) -> bool:
    """Whether B5 and B5^T take intervals of `tile` rows.  The launchers
    refuse a queue it rejects, and `TiledExecutor.queue_plan` declines
    the kernel route for it (the callback loop runs instead), so the two
    cannot disagree."""
    return 0 < tile <= TILE_MAX


def _check_tile(tile: int) -> None:
    if not queue_kernels_take(tile):
        raise ValueError(f"the queue kernels take intervals of at most "
                         f"{TILE_MAX} rows, not {tile}")


def feature_chunk(tile: int, f: int) -> int:
    """The features one B5 pass takes over `tile`-row intervals of an
    F-wide x: the lane mapping's widest pass (`queue_lanes` in
    csrc/chunk_queue.cu: F rounded up to a power of two, at least 4, up
    to F = 32; 64 up to F = 64; 128 wider) halved until the pass's
    T x min(Fc, F) block of floats fits a CTA's shared memory: 16 at
    T = 2048 and F = 64, 1 at T = 32,768.  The launch argument the
    wrapper gives the kernel."""
    fc = 128 if f > 64 else 64 if f > 32 else max(4, 1 << (f - 1)
                                                  .bit_length())
    while fc > 1 and tile * min(fc, f) * 4 > _SMEM_MAX:
        fc //= 2
    return fc


# -- the flat slab queue -------------------------------------------------

@dataclasses.dataclass(frozen=True)
class ChunkQueue:
    """The packed store's merged entries as `(steps, slab)` global-index
    slabs on one device, padding routed to the sacrificial row n.  int8
    values carry one f32 scale per slab; fp32 slabs carry scale 1.0
    (v * 1.0 is v, bit for bit)."""
    n: int                     # real vertices (output rows)
    entries: int               # real merged entries (pre-padding)
    steps: int
    slab: int
    gsrc: torch.Tensor         # (steps, slab) int32 global src vertex
    gdst: torch.Tensor         # (steps, slab) int32 global dst vertex
    vals: torch.Tensor         # (steps, slab) float32 or int8
    scales: torch.Tensor       # (steps,) float32 (all ones when fp32)
    value_dtype: str           # "fp32" | "int8"

    def device_bytes(self) -> int:
        """Resident device bytes of the queue itself."""
        return int(sum(a.numel() * a.element_size()
                       for a in (self.gsrc, self.gdst, self.vals,
                                 self.scales)))

    def raw_value_bytes(self) -> int:
        """What the value plane costs unquantised (f32)."""
        return int(4 * self.steps * self.slab)


def queue_bytes(entries: int, slab: int, value_dtype: str = "fp32") -> int:
    """Closed-form device bytes of a queue before building it — the
    budget gate's pricing twin of `ChunkQueue.device_bytes`."""
    slab = max(int(slab), 1)
    steps = max(-(-int(entries) // slab), 1)
    vb = 1 if value_dtype == "int8" else 4
    return steps * slab * (8 + vb) + 4 * steps


def _upload(a: np.ndarray, device: torch.device) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a)).to(device)


def build_chunk_queue(packed: PackedTileStore, *, slab: Optional[int] = None,
                      value_dtype: str = "fp32", quantizer=None,
                      device: DeviceLike = None) -> ChunkQueue:
    """Stage a packed store's merged entries as a slab queue on
    `device` (None: `cuda`).  `slab=None` takes the whole stream as one
    slab; otherwise entries pad up to `steps * slab`.  With
    `value_dtype="int8"` the values quantise per slab on the host
    (`quantize_stream_np`; an error-feedback `StreamingTileQuantizer`
    carries the residuals across rebuilds)."""
    if value_dtype not in ("fp32", "int8"):
        raise ValueError(value_dtype)
    device = resolve_device(device)
    n = packed.num_vertices
    gsrc, gdst, gval = flat_entries(packed)
    m = int(gsrc.size)
    if slab is None or slab >= max(m, 1):
        slab = max(m, 1)
    slab = int(slab)
    steps = max(-(-m // slab), 1)
    pad = steps * slab - m
    if pad:
        gsrc = np.concatenate([gsrc, np.zeros(pad, np.int32)])
        # padding targets the sacrificial row n: exact for sum and max
        gdst = np.concatenate([gdst, np.full(pad, n, np.int32)])
        gval = np.concatenate([gval, np.zeros(pad, np.float32)])
    gval = gval.reshape(steps, slab)
    if value_dtype == "int8":
        gval, scales = quantize_stream_np(gval, quantizer)
        scales = _upload(scales, device)
    else:
        scales = torch.ones(steps, dtype=torch.float32, device=device)
    return ChunkQueue(n, m, steps, slab,
                      _upload(gsrc.reshape(steps, slab), device),
                      _upload(gdst.reshape(steps, slab), device),
                      _upload(gval, device), scales, value_dtype)


def queue_sweep_plain(gsrc: torch.Tensor, gdst: torch.Tensor,
                      vals: torch.Tensor, scales: torch.Tensor,
                      x: torch.Tensor, *, n: int,
                      op: str = "sum") -> torch.Tensor:
    """One gather and one segment reduce per slab, accumulated into the
    (n+1, d) destination buffer (row n swallows padding; the result is
    sliced to n rows).  A slab's values dequantise as `vals.float() *
    scale` (bitwise the values for fp32, whose scales are 1).  An empty
    max row is 0."""
    if op not in ("sum", "max"):
        raise ValueError(op)
    rows, d = n + 1, x.shape[1]
    fill = 0.0 if op == "sum" else -torch.inf
    y = torch.full((rows, d), fill, dtype=torch.float32, device=x.device)
    for s in range(gsrc.shape[0]):
        src, dst = gsrc[s].long(), gdst[s].long()
        v = vals[s].to(torch.float32) * scales[s]
        gathered = x[src]
        if op == "sum":
            y.index_add_(0, dst, v[:, None] * gathered)
        else:
            scaled = torch.where((v != 0.0)[:, None], v[:, None] * gathered,
                                 -torch.inf)
            y.scatter_reduce_(0, dst[:, None].expand(-1, d), scaled, "amax",
                              include_self=True)
    if op == "max":
        y = torch.where(torch.isneginf(y), 0.0, y)
    return y[:n]


def _slab_max_count(queue: ChunkQueue, x: torch.Tensor):
    """The multi-slab max with its tie counts, slab by slab: a strictly
    better slab replaces a row's count, an exact finite tie adds to it.
    Returns the raw (n+1, d) running max (-inf where nothing arrived)
    and the counts."""
    rows, d = queue.n + 1, x.shape[1]
    acc_v = torch.full((rows, d), -torch.inf, dtype=torch.float32,
                       device=x.device)
    acc_c = torch.zeros((rows, d), dtype=torch.float32, device=x.device)
    for s in range(queue.steps):
        src, dst = queue.gsrc[s].long(), queue.gdst[s].long()
        v = queue.vals[s].to(torch.float32) * queue.scales[s]
        scaled = torch.where((v != 0.0)[:, None], v[:, None] * x[src],
                             -torch.inf)
        m = torch.full((rows, d), -torch.inf, dtype=torch.float32,
                       device=x.device)
        m.scatter_reduce_(0, dst[:, None].expand(-1, d), scaled, "amax",
                          include_self=True)
        hit = ((scaled == m[dst]) & (v != 0.0)[:, None]).to(torch.float32)
        c = torch.zeros_like(m).index_add_(0, dst, hit)
        better = m > acc_v
        ties = (m == acc_v) & torch.isfinite(m)
        acc_v = torch.maximum(acc_v, m)
        acc_c = torch.where(better, c, acc_c + torch.where(ties, c, 0.0))
    return acc_v, acc_c


class _QueueMax(torch.autograd.Function):
    """The multi-slab max over a slab queue, with the reference's
    `make_queue_max_diff` backward: re-walk the slabs, recompute each
    edge product from the forward's operands and give g / count to every
    entry equal to its row's global max."""

    @staticmethod
    def forward(ctx, queue, x):
        yv, yc = _slab_max_count(queue, x)
        ctx.queue = queue
        # the RAW max is kept: the backward's exact product match must
        # compare with it, not with the 0 an empty row reports
        ctx.save_for_backward(x, yv, yc)
        return torch.where(torch.isneginf(yv), 0.0, yv)[:queue.n]

    @staticmethod
    def backward(ctx, g):
        x, yv, yc = ctx.saved_tensors
        q = ctx.queue
        gn = torch.zeros_like(yv)
        gn[:q.n] = g
        gn = gn / torch.clamp_min(yc, 1.0)
        gx = torch.zeros_like(x)
        for s in range(q.steps):
            src, dst = q.gsrc[s].long(), q.gdst[s].long()
            v = q.vals[s].to(torch.float32) * q.scales[s]
            prod = v[:, None] * x[src]
            match = (v != 0.0)[:, None] & (prod == yv[dst])
            contrib = torch.where(match, v[:, None] * gn[dst], 0.0)
            gx = gx + torch.zeros_like(x).index_add_(0, src, contrib)
        return None, gx


def make_queue_max_diff(queue: ChunkQueue):
    """A differentiable multi-slab max sweep over a staged slab queue:
    the forward equals `queue_sweep_plain(..., op="max")`; the backward
    splits a row's cotangent evenly over all its tied entries whatever
    slabs they sit in (plain autograd through the slab-by-slab maximum
    would split a cross-slab tie per merge).  Gradients flow to x only."""
    return lambda x: _QueueMax.apply(queue, x)


def chunk_queue_aggregate(queue: ChunkQueue, x: torch.Tensor, *,
                          op: str = "sum", impl: Optional[str] = None,
                          tile_queue: Optional["TileQueue"] = None
                          ) -> torch.Tensor:
    """The staged-queue aggregate: the CUDA walker over `tile_queue` for
    a sum when one is given (and `impl` is not "plain"), else the plain
    slab sweep.  An int8 queue is always swept by slabs (the reference's
    route: its walker is fp32-only and its int8 sweep is XLA).  x lies on
    the queue's device."""
    if impl not in (None, "plain", "cuda"):
        raise ValueError(impl)
    if impl != "plain" and tile_queue is not None and op == "sum":
        return tile_queue_aggregate(tile_queue, x)
    if (x.device.type == "cuda" and impl != "plain"
            and queue.value_dtype == "fp32"):
        raise ValueError(
            f"the chunk-queue kernel sweeps sums over a TileQueue; op={op!r}"
            f" without one has no kernel on {x.device} (impl='plain' asks "
            f"for the plain sweep)")
    return queue_sweep_plain(queue.gsrc, queue.gdst, queue.vals,
                             queue.scales, x, n=queue.n, op=op)


# -- the per-interval tile queue (the CUDA walker's layout) ---------------

@dataclasses.dataclass(frozen=True)
class TileQueue:
    """The packed tiles dst-sorted, with each destination interval's
    span of tiles and each tile's span of ragged entries, and the
    walker's work table (`queue_work`)."""
    n: int
    tile: int
    q: int
    bucket: int                # the reference's uniform pad; unused here
    tile_ptr: torch.Tensor     # (q+1,) int32 tiles of interval i
    tile_src: torch.Tensor     # (max(K, 1),) int32 source interval
    entry_ptr: torch.Tensor    # (K+1,) int32 entries of tile k
    rows: torch.Tensor         # (M,) int32 row_local, dst-sorted tiles
    cols: torch.Tensor         # (M,) int32 col_local
    vals: torch.Tensor         # (M,) float32
    # the walker's work table: per CTA (interval, first entry, end entry,
    # split slot or -1, pieces of the interval), longest first, over the
    # walker's copy of the entries, row-sorted within each interval (the
    # interval spans are the tile order's): local row, global source row
    # (tile_src * tile + col) and value
    pieces: torch.Tensor       # (P, 5) int32
    wrows: torch.Tensor        # (M,) int32
    wsrc: torch.Tensor         # (M,) int32
    wvals: torch.Tensor        # (M,) float32
    n_split: int               # intervals split over several pieces
    # B5^T's work table (`queue_src_work`), over rows / cols / vals as
    # they are: the tiles with entries in source order, their entry
    # offsets in that order, each tile's destination interval, and per
    # CTA (source interval, first, end (offsets in that order), split
    # slot or -1, pieces of the interval, first tile, end tile), longest
    # first
    tpieces: torch.Tensor      # (P', 7) int32
    tsrc_ptr: torch.Tensor     # (K'+1,) int32
    tsrc_tiles: torch.Tensor   # (K',) int32
    tile_dst: torch.Tensor     # (K,) int32
    t_split: int               # source intervals split over pieces
    t_piece: int               # most entries of a B5^T piece

    @property
    def entries(self) -> int:
        return int(self.rows.numel())

    def device_bytes(self) -> int:
        return int(sum(a.numel() * a.element_size()
                       for a in (self.tile_ptr, self.tile_src,
                                 self.entry_ptr, self.rows, self.cols,
                                 self.vals, self.pieces, self.wrows,
                                 self.wsrc, self.wvals, self.tpieces,
                                 self.tsrc_ptr, self.tsrc_tiles,
                                 self.tile_dst)))


def queue_segments(tile_ptr: np.ndarray, entry_ptr: np.ndarray,
                   segment: int = SEGMENT) -> np.ndarray:
    """(P, 5) int32 rows (interval, lo, hi, slot, count): each interval's
    entry span [entry_ptr[tile_ptr[i]], entry_ptr[tile_ptr[i+1]]) cut
    into `count` pieces of at most `segment` entries; an empty interval
    keeps one empty piece, so its output block is still written.  A split
    interval (count > 1) has a slot, numbered in interval order, and -1
    otherwise.  Rows are ordered longest piece first (stable: an
    interval's pieces stay in entry order), so the longest CTAs start
    first and the short ones fill the last wave."""
    bounds = entry_ptr[tile_ptr].astype(np.int64)          # (q+1,)
    lens = np.diff(bounds)
    pieces = np.maximum(1, -(-lens // segment))
    interval = np.repeat(np.arange(lens.size, dtype=np.int64), pieces)
    first = np.cumsum(pieces) - pieces
    k = np.arange(interval.size, dtype=np.int64) - first[interval]
    lo = bounds[:-1][interval] + k * segment
    hi = np.minimum(lo + segment, bounds[1:][interval])
    split = pieces > 1
    slot_of = np.where(split, np.cumsum(split) - 1, -1)
    rows = np.stack([interval, lo, hi, slot_of[interval], pieces[interval]],
                    axis=1)
    rows = rows[np.argsort(-(hi - lo), kind="stable")]
    return np.ascontiguousarray(rows.astype(np.int32))


def queue_work(tile_ptr: np.ndarray, tile_src: np.ndarray,
               entry_ptr: np.ndarray, rows: np.ndarray, cols: np.ndarray,
               vals: np.ndarray, tile: int):
    """The walker's work table, from the queue's host arrays: `pieces`
    (`queue_segments`) over the walker's copy of the entries, each
    interval's entries sorted by local row (stably: a row's entries keep
    their tile order), as (wrows, wsrc, wvals): local row, global source
    row tile_src * tile + col, value.  A warp then meets each row in one
    run, and a piece of a split interval covers a contiguous range of
    rows.  Returns (pieces, wrows, wsrc, wvals, n_split).  The interval
    spans are the same in both orders, so `queue_segments` over other
    piece sizes fits the same copy."""
    k = entry_ptr.size - 1
    q = tile_ptr.size - 1
    tile_of = np.repeat(np.arange(k, dtype=np.int64), np.diff(entry_ptr))
    dst_of = np.repeat(np.arange(q, dtype=np.int64),
                       np.diff(tile_ptr))[tile_of]
    order = np.lexsort((rows, dst_of))
    wsrc = tile_src[tile_of[order]].astype(np.int64) * tile + cols[order]
    pieces = queue_segments(tile_ptr, entry_ptr)
    return (pieces, np.ascontiguousarray(rows[order]),
            np.ascontiguousarray(wsrc.astype(np.int32)),
            np.ascontiguousarray(vals[order]), split_count(pieces))


def source_piece(entries: int, n_sm: int = SMS) -> int:
    """The most entries of one B5^T piece: the power of two at or above
    the queue's entries over twice the card's SM count (pubmed's 78 source
    intervals alone would leave most of an H100 idle, and its hub interval
    would set the time), within [PIECE_FLOOR, PIECE_MAX]: a smaller piece
    adds to the split intervals' merges more than it takes off the
    longest CTA, a longer one makes the longest CTA the kernel's time
    (both measured with `benchmarks/torch/time_chunk_queue.py --transpose
    --piece`)."""
    want = -(-int(entries) // (2 * n_sm))
    return int(min(PIECE_MAX, max(PIECE_FLOOR, 1 << max(want - 1, 0)
                                  .bit_length())))


def queue_src_work(tile_ptr: np.ndarray, tile_src: np.ndarray,
                   entry_ptr: np.ndarray, piece: int):
    """B5^T's work table, from the queue's host arrays; it copies no
    entry.  The tiles with entries, stably sorted by source interval
    (`tsrc_tiles`), and their entry offsets in that order (`tsrc_ptr`):
    offset v of tile j is entry entry_ptr[tsrc_tiles[j]] + v - tsrc_ptr[j]
    of the forward queue.  Each source interval's span of that order is
    cut by `queue_segments` into pieces of at most `piece` entries (an
    interval with no tile keeps one empty piece, so its dX rows are
    still stored); `tpieces` rows are `queue_segments`' five columns and
    the span [first, end) of source-ordered tiles that holds the piece's
    entries (empty for an empty piece).  `tile_dst` is each tile's
    destination interval.  Returns (tpieces, tsrc_ptr, tsrc_tiles,
    tile_dst, t_split)."""
    k = entry_ptr.size - 1
    q = tile_ptr.size - 1
    lens = np.diff(entry_ptr).astype(np.int64)
    tile_dst = np.repeat(np.arange(q, dtype=np.int32), np.diff(tile_ptr))
    live = np.flatnonzero(lens > 0)
    src = tile_src[:k]
    tsrc_tiles = live[np.argsort(src[live], kind="stable")]
    tsrc_ptr = np.zeros(tsrc_tiles.size + 1, np.int64)
    np.cumsum(lens[tsrc_tiles], out=tsrc_ptr[1:])
    sptr = np.searchsorted(src[tsrc_tiles], np.arange(q + 1))
    seg = queue_segments(sptr, tsrc_ptr, piece)
    # the span of tiles [first, end) that holds each piece's entries
    first = np.searchsorted(tsrc_ptr, seg[:, 1], side="right") - 1
    end = np.searchsorted(tsrc_ptr, seg[:, 2], side="left")
    first = np.where(seg[:, 2] > seg[:, 1], first, end)
    tpieces = np.ascontiguousarray(np.concatenate(
        [seg, first[:, None], end[:, None]], axis=1).astype(np.int32))
    return (tpieces, tsrc_ptr.astype(np.int32),
            tsrc_tiles.astype(np.int32), tile_dst, split_count(tpieces))


def split_count(pieces: np.ndarray) -> int:
    """Intervals split over several pieces of a `queue_segments` table."""
    return int(pieces[:, 3].max()) + 1 if pieces.size else 0


def sm_count(device: torch.device) -> int:
    """The SM count `source_piece` sizes B5^T's pieces for: the card's,
    or SMS off the card."""
    if device.type == "cuda":
        return torch.cuda.get_device_properties(device).multi_processor_count
    return SMS


def build_tile_queue(packed: PackedTileStore, bucket_floor: int = 8,
                     device: DeviceLike = None) -> TileQueue:
    """Host-side layout for the walker, uploaded to `device` (None:
    `cuda`): dst-sort the store's tiles, record each destination
    interval's span and each tile's span of entries, and build the
    walker's work table (`queue_work`) and B5^T's (`queue_src_work`,
    pieces of `source_piece` entries for the card).  Index ranges are
    checked here, on the host, once: the kernel reads out of bounds
    otherwise."""
    device = resolve_device(device)
    q, t = packed.q, packed.tile
    nnz = packed.tile_nnz()
    bucket = pow2_bucket(int(nnz.max()) if nnz.size else 0, bucket_floor)
    order = np.argsort(packed.block_row, kind="stable").astype(np.int64)
    brow = packed.block_row[order]
    tile_ptr = np.searchsorted(brow, np.arange(q + 1)).astype(np.int32)
    tile_src = np.zeros(max(order.size, 1), np.int32)
    tile_src[:order.size] = packed.block_col[order]
    counts = nnz[order]
    entry_ptr = np.zeros(order.size + 1, np.int64)
    np.cumsum(counts, out=entry_ptr[1:])
    m = int(entry_ptr[-1])
    if m >= 2 ** 31 or q * t >= 2 ** 31:
        raise ValueError(f"{m} entries or {q * t} rows exceed the kernel's "
                         f"int32 offsets")
    # entry e of queue tile c sits at store offset start[order[c]] + (e -
    # entry_ptr[c]): one vectorised gather, no Python loop over tiles
    take = (np.repeat(packed.entry_ptr[:-1][order] - entry_ptr[:-1], counts)
            + np.arange(m, dtype=np.int64))
    rows, cols = packed.row_local[take], packed.col_local[take]
    vals = packed.val[take]
    for name, a, hi in (("rows", rows, t), ("cols", cols, t),
                        ("tile_src", tile_src, max(q, 1))):
        if a.size and (int(a.min()) < 0 or int(a.max()) >= hi):
            raise ValueError(f"{name} holds values outside [0, {hi})")
    pieces, wrows, wsrc, wvals, n_split = queue_work(
        tile_ptr, tile_src, entry_ptr, rows, cols, vals, t)
    piece = source_piece(m, sm_count(device))
    tpieces, tsrc_ptr, tsrc_tiles, tile_dst, t_split = queue_src_work(
        tile_ptr, tile_src, entry_ptr, piece)
    return TileQueue(packed.num_vertices, t, q, bucket,
                     *(_upload(a, device) for a in (
                         tile_ptr, tile_src, entry_ptr.astype(np.int32),
                         rows, cols, vals, pieces, wrows, wsrc, wvals)),
                     n_split,
                     *(_upload(a, device) for a in (
                         tpieces, tsrc_ptr, tsrc_tiles, tile_dst)),
                     t_split, int(piece))


def tile_queue_bytes(packed: PackedTileStore, segment: int = SEGMENT,
                     n_sm: int = SMS) -> Tuple[int, int, int]:
    """(device bytes, split intervals, split source intervals) of
    `build_tile_queue(packed)` on a card of `n_sm` SMs,
    before building it: the budget gate's twin of
    `TileQueue.device_bytes`, `TileQueue.n_split` and
    `TileQueue.t_split`."""
    q, k, m = packed.q, packed.nnzb, packed.nnz
    nnz = packed.tile_nnz()
    lens = np.bincount(packed.block_row, weights=nnz,
                       minlength=q).astype(np.int64)
    pieces = np.maximum(1, -(-lens // segment))
    piece = source_piece(m, n_sm)
    src_lens = np.bincount(packed.block_col, weights=nnz,
                           minlength=q).astype(np.int64)
    tpieces = np.maximum(1, -(-src_lens // piece))
    live = int((nnz > 0).sum())
    return (4 * (q + 1) + 4 * max(k, 1) + 4 * (k + 1) + 24 * m
            + 20 * int(pieces.sum())
            + 4 * (live + 1) + 4 * live + 4 * k + 28 * int(tpieces.sum()),
            int((pieces > 1).sum()), int((tpieces > 1).sum()))


def _entry_ends(tq: TileQueue):
    """Each entry's global destination and source rows, on the queue's
    device."""
    dev = tq.rows.device
    t = tq.tile
    k = tq.entry_ptr.numel() - 1
    tile_dst = torch.repeat_interleave(
        torch.arange(tq.q, device=dev), torch.diff(tq.tile_ptr.long()))
    tile_of = torch.repeat_interleave(
        torch.arange(k, device=dev), torch.diff(tq.entry_ptr.long()))
    gsrc = tq.tile_src.long()[tile_of] * t + tq.cols.long()
    gdst = tile_dst[tile_of] * t + tq.rows.long()
    return gdst, gsrc


def tile_queue_plain(tq: TileQueue, x: torch.Tensor,
                     activation: Optional[str] = None) -> torch.Tensor:
    """The walker's function in plain PyTorch: each entry's global
    (dst, src) from its tile, one gather, one index_add_, then the
    activation.  x (n, F) -> (n, F)."""
    gdst, gsrc = _entry_ends(tq)
    y = torch.zeros((tq.q * tq.tile, x.shape[1]), dtype=torch.float32,
                    device=x.device)
    y.index_add_(0, gdst, tq.vals[:, None] * x[gsrc])
    if activation == "relu":
        y = torch.relu(y)
    elif activation is not None:
        raise ValueError(activation)
    return y[:tq.n]


def tile_queue_t_plain(tq: TileQueue, g: torch.Tensor) -> torch.Tensor:
    """B5^T's function in plain PyTorch: A^T g over the forward queue's
    entries, one gather of G at each entry's destination and one
    index_add_ at its source.  g (n, F) -> (n, F)."""
    gdst, gsrc = _entry_ends(tq)
    dx = torch.zeros((tq.q * tq.tile, g.shape[1]), dtype=torch.float32,
                     device=g.device)
    dx.index_add_(0, gsrc, tq.vals[:, None] * g[gdst])
    return dx[:tq.n]


_LIB = None


def _lib():
    global _LIB
    if _LIB is None:
        lib = _build.load("chunk_queue")
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.chunk_queue_launch.argtypes = [p, i, p, p, p, p, p, p, i, i, i,
                                           i, i, i, p]
        lib.chunk_queue_launch.restype = i
        lib.chunk_queue_t_launch.argtypes = [p, i, p, p, p, p, p, p, p, p,
                                             p, p, i, i, i, i, i, p]
        lib.chunk_queue_t_launch.restype = i
        _LIB = lib
    return _LIB


def _check_queue(tq: TileQueue, x: torch.Tensor, name: str) -> None:
    dev = x.device
    check_tensor(x, name, torch.float32, dev, 2)
    for field in ("wrows", "wsrc"):
        check_tensor(getattr(tq, field), field, torch.int32, dev, 1)
    check_tensor(tq.wvals, "wvals", torch.float32, dev, 1)
    check_tensor(tq.pieces, "pieces", torch.int32, dev, 2)
    if tq.pieces.shape[1] != 5:
        raise ValueError("the work table does not match the kernel's")
    if x.shape[0] != tq.n:
        raise ValueError(f"{name} has {x.shape[0]} rows, the queue {tq.n}")


def _tile_queue_forward(tq: TileQueue, x: torch.Tensor,
                        activation: Optional[str]) -> torch.Tensor:
    if x.device.type == "cpu":
        return tile_queue_plain(tq, x, activation)
    if x.device.type != "cuda":
        raise ValueError(f"no chunk_queue kernel for device {x.device}")
    dev = x.device
    _check_queue(tq, x, "x")
    _check_tile(tq.tile)
    f = x.shape[1]
    y = torch.empty((tq.n, f), dtype=torch.float32, device=dev)
    # the split intervals' blocks and their arrival counters, zeroed by
    # the launcher; every other block is stored once by its CTA
    scratch = torch.empty(tq.n_split * (tq.tile * f + f),
                          dtype=torch.float32, device=dev)
    relu = activation == "relu"
    status = _lib().chunk_queue_launch(
        tq.pieces.data_ptr(), tq.pieces.shape[0], tq.wrows.data_ptr(),
        tq.wsrc.data_ptr(), tq.wvals.data_ptr(), x.data_ptr(), y.data_ptr(),
        scratch.data_ptr(), tq.n_split, tq.n, tq.tile, f,
        feature_chunk(tq.tile, f), int(relu), stream_handle(dev))
    check_status(status, "chunk_queue")
    LAUNCHES["sum_relu" if relu else "sum"] += 1
    return y


class _TileQueueSum(torch.autograd.Function):
    """B5 forward, B5^T backward, both over the one forward queue."""

    @staticmethod
    def forward(ctx, tq, x):
        ctx.tq = tq
        return _tile_queue_forward(tq, x, None)

    @staticmethod
    def backward(ctx, g):
        return None, tile_queue_t(ctx.tq, g.contiguous())


def tile_queue_aggregate(tq: TileQueue, x: torch.Tensor, *,
                         activation: Optional[str] = None) -> torch.Tensor:
    """act(A x) over a built tile queue: x (n, F) -> (n, F).  CPU tensors
    take the plain version; CUDA tensors the kernel.  Under grad a sum is
    an autograd Function whose backward is `tile_queue_t`; the relu
    epilogue has no backward and is refused there."""
    if activation not in (None, "relu"):
        raise ValueError(activation)
    if torch.is_grad_enabled() and x.requires_grad:
        if activation is not None:
            refuse_grad("chunk_queue", x,
                        why="has no backward for its relu epilogue")
        return _TileQueueSum.apply(tq, x)
    return _tile_queue_forward(tq, x, activation)


def _t_bytes(t: int, piece: int) -> int:
    """B5^T's shared memory at its widest lanes (`t_words` in
    csrc/chunk_queue.cu): two run partials, the column counts and the
    piece's tile and entry words."""
    return 4 * (2 * 1024 + ((t + 4) & ~3) + 8 * piece + 4)


_T_FIELDS = ("tsrc_ptr", "tsrc_tiles", "tile_dst", "entry_ptr", "rows",
             "cols")


def _queue_t_table(tq: TileQueue, g: torch.Tensor) -> tuple:
    """Check g, and once per set of table tensors (memoised on
    `tpieces`, keyed by their pointers) the queue's fields B5^T reads;
    returns the table's launch arguments (its pointers and piece
    count)."""
    dev = g.device
    check_tensor(g, "g", torch.float32, dev, 2)
    if g.shape[0] != tq.n:
        raise ValueError(f"g has {g.shape[0]} rows, the queue {tq.n}")
    args = (tq.tpieces.data_ptr(), tq.tpieces.shape[0],
            *(getattr(tq, a).data_ptr() for a in _T_FIELDS),
            tq.vals.data_ptr())
    memo = _memo(tq.tpieces)
    key = ("b5t", dev, args)
    if key in memo:
        return args
    for field in _T_FIELDS:
        check_tensor(getattr(tq, field), field, torch.int32, dev, 1)
    check_tensor(tq.vals, "vals", torch.float32, dev, 1)
    check_tensor(tq.tpieces, "tpieces", torch.int32, dev, 2)
    if tq.tpieces.shape[1] != 7:
        raise ValueError("the source table does not match the kernel's")
    _check_tile(tq.tile)
    if _t_bytes(tq.tile, tq.t_piece) > _SMEM_MAX:
        raise ValueError(f"a {tq.t_piece}-entry piece of {tq.tile}-row "
                         f"tiles exceeds B5^T's shared memory")
    memo[key] = True
    return args


def tile_queue_t(tq: TileQueue, g: torch.Tensor) -> torch.Tensor:
    """B5^T: A^T g over the forward queue, g (n, F) -> dX (n, F).  CPU
    tensors take the plain version; CUDA tensors the kernel, which loads
    each piece of `tpieces` from the forward queue's own entries, sorts
    it by source column in shared memory and sums each column in
    registers; a split interval's pieces merge with float atomics (their
    order, and a column's, vary from run to run: sums agree with the
    plain version to fp32 rounding)."""
    if g.device.type == "cpu":
        return tile_queue_t_plain(tq, g)
    if g.device.type != "cuda":
        raise ValueError(f"no chunk_queue kernel for device {g.device}")
    refuse_grad("chunk_queue_t", g, why="has no double backward")
    table = _queue_t_table(tq, g)
    f = g.shape[1]
    dx = torch.empty((tq.n, f), dtype=torch.float32, device=g.device)
    # the split source intervals' blocks and arrival counters, zeroed by
    # the launcher; every other block is stored once by its CTA
    scratch = (torch.empty(tq.t_split * (tq.tile * f + f),
                           dtype=torch.float32, device=g.device)
               if tq.t_split else dx)
    status = _lib().chunk_queue_t_launch(
        *table, g.data_ptr(), dx.data_ptr(), scratch.data_ptr(),
        tq.t_split, tq.t_piece, tq.n, tq.tile, f, stream_handle(g.device))
    check_status(status, "chunk_queue_t")
    LAUNCHES["sum_t"] += 1
    return dx
