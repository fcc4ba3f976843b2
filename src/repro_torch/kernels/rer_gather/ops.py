"""RER-Gather: the aggregate over packed edge tiles.

Host side (numpy, the reference's carriers field for field):
`prepare_packed_groups` groups the packed tiles by pow2 nnz bucket, each
group dst-sorted with every interval present; `flat_entries` flattens
the store to global `(gsrc, gdst, gval)` entries.

Device side: one launch of the hand-written CUDA kernel
`csrc/rer_gather.cu` covers a whole aggregate for CUDA tensors: every
bucket group of a plan (`packed_groups_spmm`, and the single-group raw
form `packed_spmm`), walked through a work table (`work_table`) that
cuts the real entries into segments of about `SEG_ENTRIES` entries in
destination order and never names a pad slot.  The backward walks the
same groups through the same table, one launch per pass, in
`csrc/rer_gather_bwd.cu`: the sum's dX = A^T G and the max's winner
words, their resolve pass and the walk of the tied rows
(`rer_gather_bwd`); no carrier of A^T is built.  A plan's groups
(`PlanGroups`, built where the plan uploads them) carry their table,
made from the host arrays; any other list of groups builds one at each
call from the per-tile real counts read back.
CPU tensors take the plain versions: `packed_spmm_plain` per group
(gather the referenced rows, scale, segment-reduce), merged by + /
maximum.  The max backward splits the cotangent evenly over all tied
entries of a row, as the reference's flat `segment_max` does.
`packed_flat_plain` is the one-launch plain form the CPU path of
`prepare_graph` carries (autograd differentiates it directly).
`packed_tile_part` is the streamed executor's call form:
one chunk of C packed tiles against the (C, T, F) stack of their source
intervals, reduced into one destination interval's raw (T, F) partial,
one warp per (tile, 64-slot slice); its plain version is
`packed_tile_part_plain`.

Source note.  Replaces `repro/kernels/rer_gather/rer_gather.py::
rer_gather` (`_gather_kernel_sum`, `_gather_kernel_max`).  On the H100
it is bound by bytes: 12 B per real entry plus one referenced feature
row.  The kernel reads each referenced X row directly (the reference's
one-hot MXU gather is a TPU workaround); each warp walks one segment,
keeps the running destination row in registers and flushes it to Y with
global atomics (sum) or an integer-atomic float max (max, exact in any
order) when the row changes.  See the kernel source for the rest.
"""
from __future__ import annotations

import ctypes
import dataclasses
from typing import Dict, List, NamedTuple, Sequence

import numpy as np
import torch
from torch.autograd.function import once_differentiable

from repro_torch.graphs.partition import PackedTileStore, pow2_bucket
from repro_torch.kernels import _build
from repro_torch.kernels._common import (check_range, check_status,
                                         check_tensor, refuse_grad,
                                         stream_handle)
from repro_torch.tracing import span

# kernel launches by op and call form, counted where the kernel is
# launched: "sum"/"max" for bucket groups (one per aggregate), "sum_t"
# for the sum backward over the same groups (`rer_gather_bwd.cu`'s
# scatter, one per aggregate, launched and counted by
# `rer_gather_bwd.packed_groups_t`), "tile_part_*" for the streamed
# executor's chunks
LAUNCHES = {"sum": 0, "max": 0, "sum_t": 0, "tile_part_sum": 0,
            "tile_part_max": 0}

# real entries a segment of the work table holds at most (one warp each)
SEG_ENTRIES = 64


@dataclasses.dataclass(frozen=True)
class PackedGroup:
    """One nnz-bucket's worth of packed tiles, ready for upload:
    (K, S) entry arrays, dst-sorted, every dst interval present."""
    bucket: int                  # S — pow2 entry slots per tile
    rows: np.ndarray             # (K, S) int32 row_local
    cols: np.ndarray             # (K, S) int32 col_local
    vals: np.ndarray             # (K, S) float32 (0.0 = padding)
    block_row: np.ndarray        # (K,) int32 dst interval, non-decreasing
    block_col: np.ndarray        # (K,) int32 src interval
    real_tiles: int              # tiles before interval padding

    def nbytes(self) -> int:
        return int(self.rows.nbytes + self.cols.nbytes + self.vals.nbytes
                   + self.block_row.nbytes + self.block_col.nbytes)


def prepare_packed_groups(packed: PackedTileStore,
                          bucket_floor: int = 8) -> List[PackedGroup]:
    """Group the store's tiles by pow2 nnz bucket; within each group,
    dst-sort and pad missing destination intervals with empty tiles."""
    q = packed.q
    nnz = packed.tile_nnz()
    buckets = np.array([pow2_bucket(int(m), bucket_floor) for m in nnz],
                       np.int64)
    groups: List[PackedGroup] = []
    for b in sorted(set(buckets.tolist())) or [pow2_bucket(0, bucket_floor)]:
        idx = np.nonzero(buckets == b)[0].astype(np.int64)
        brow = packed.block_row[idx]
        present = np.zeros(q, bool)
        present[brow] = True
        missing = np.nonzero(~present)[0].astype(np.int32)
        tiles = np.concatenate([idx, np.full(missing.size, -1, np.int64)])
        brow = np.concatenate([brow, missing]).astype(np.int32)
        bcol = np.concatenate([packed.block_col[idx], missing]
                              ).astype(np.int32)
        order = np.argsort(brow, kind="stable")
        tiles, brow, bcol = tiles[order], brow[order], bcol[order]
        rows, cols, vals = packed.pack(tiles, tiles.size, int(b))
        groups.append(PackedGroup(int(b), rows, cols, vals, brow, bcol,
                                  real_tiles=int(idx.size)))
    return groups


def flat_entries(packed: PackedTileStore):
    """The store's merged entries as flat global `(gsrc, gdst, gval)`."""
    t = packed.tile
    counts = np.diff(packed.entry_ptr)
    tile_of = np.repeat(np.arange(packed.nnzb, dtype=np.int64), counts)
    gsrc = (packed.block_col[tile_of].astype(np.int64) * t
            + packed.col_local)
    gdst = (packed.block_row[tile_of].astype(np.int64) * t
            + packed.row_local)
    return (gsrc.astype(np.int32), gdst.astype(np.int32),
            packed.val.copy())


def _segment_reduce(v: torch.Tensor, gathered: torch.Tensor,
                    seg: torch.Tensor, n: int, op: str,
                    finish: bool) -> torch.Tensor:
    f = gathered.shape[1]
    if op == "sum":
        y = torch.zeros((n, f), dtype=torch.float32, device=gathered.device)
        return y.index_add_(0, seg, v[:, None] * gathered)
    if op != "max":
        raise ValueError(op)
    scaled = torch.where((v != 0.0)[:, None], v[:, None] * gathered,
                         -torch.inf)
    y = torch.full((n, f), -torch.inf, dtype=torch.float32,
                   device=gathered.device)
    y.scatter_reduce_(0, seg[:, None].expand(-1, f), scaled, "amax",
                      include_self=False)
    if finish:
        y = torch.where(torch.isneginf(y), 0.0, y)
    return y


def packed_flat_plain(gsrc: torch.Tensor, gdst: torch.Tensor,
                      gval: torch.Tensor, x: torch.Tensor, *, n: int,
                      op: str = "sum", finish: bool = True) -> torch.Tensor:
    """y[gdst] (+)= gval * x[gsrc]: one gather and one segment reduce."""
    return _segment_reduce(gval, x[gsrc.long()], gdst.long(), n, op, finish)


def packed_spmm_plain(rows: torch.Tensor, cols: torch.Tensor,
                      vals: torch.Tensor, block_row: torch.Tensor,
                      block_col: torch.Tensor, x: torch.Tensor, *, q: int,
                      op: str = "sum", finish: bool = True) -> torch.Tensor:
    """One bucket group in plain PyTorch: gather exactly the referenced
    source rows, scale by the entry weight, reduce at the global
    (interval, row) vertex."""
    t = x.shape[0] // q
    gcols = (block_col.long()[:, None] * t + cols.long()).reshape(-1)
    seg = (block_row.long()[:, None] * t + rows.long()).reshape(-1)
    return _segment_reduce(vals.reshape(-1), x[gcols], seg, q * t, op,
                           finish)


def packed_tile_part_plain(rows: torch.Tensor, cols: torch.Tensor,
                           vals: torch.Tensor, xs: torch.Tensor, *,
                           op: str = "sum") -> torch.Tensor:
    """One streamed chunk in plain PyTorch: (C, S) entries against the
    (C, T, F) source stack -> (T, F) raw partial (sum from zero; max
    keeps -inf in uncovered rows)."""
    c, t, f = xs.shape
    gcols = (torch.arange(c, device=xs.device)[:, None] * t
             + cols.long()).reshape(-1)
    return _segment_reduce(vals.reshape(-1), xs.reshape(c * t, f)[gcols],
                           rows.long().reshape(-1), t, op, finish=False)


def real_counts(rows: torch.Tensor, cols: torch.Tensor,
                vals: torch.Tensor) -> torch.Tensor:
    """Per tile of a (K, S) group, the slots up to its last one that is
    not a pad (0, 0, 0.0): the store's entry count for every tile but a
    lone (0, 0) entry of weight 0, which contributes nothing.  Every
    slot from there on is a pad, so a walk over [0, count) sees every
    entry that contributes and no pad slot."""
    k, s = rows.shape
    if s == 0:
        return torch.zeros(k, dtype=torch.int64, device=rows.device)
    live = (rows != 0) | (cols != 0) | (vals != 0)
    pos = torch.arange(1, s + 1, device=rows.device)
    return torch.where(live, pos, 0).amax(dim=1)


def work_table(counts: Sequence[np.ndarray], block_row: Sequence[np.ndarray],
               block_col: Sequence[np.ndarray],
               seg_entries: int = SEG_ENTRIES):
    """The kernel's work table over bucket groups: group g's tile k holds
    `counts[g][k]` real entries in its first slots.  Each tile's entries
    are cut into pieces of at most `seg_entries`, the pieces sorted by
    (destination interval, group, tile, first entry) and packed greedily
    into segments of at most `seg_entries` entries.  Returns `pieces`
    (P, 6) int32 rows (group, tile, lo, hi, dst interval, src interval),
    `seg_ptr` (n_seg + 1) int32: segment s is pieces
    [seg_ptr[s], seg_ptr[s+1]), and `poff` (P,) int32: each piece's
    first entry within its segment (a warp walks a segment as one run of
    entries)."""
    parts = []
    for g, (cnt, br, bc) in enumerate(zip(counts, block_row, block_col)):
        cnt = np.asarray(cnt, np.int64)
        k = np.nonzero(cnt > 0)[0]
        n = -(-cnt[k] // seg_entries)
        tile = np.repeat(k, n)
        j = np.arange(tile.size) - np.repeat(np.cumsum(n) - n, n)
        lo = j * seg_entries
        hi = np.minimum(lo + seg_entries, cnt[tile])
        parts.append(np.stack([np.full(tile.size, g), tile, lo, hi,
                               np.asarray(br, np.int64)[tile],
                               np.asarray(bc, np.int64)[tile]], axis=1))
    pieces = (np.concatenate(parts) if parts
              else np.zeros((0, 6), np.int64))
    pieces = pieces[np.lexsort((pieces[:, 2], pieces[:, 1], pieces[:, 0],
                                pieces[:, 4]))]
    # greedy packing: a piece opens a new segment when the open one
    # could not take it
    seg_ptr = [0]
    fill = 0
    for i, size in enumerate((pieces[:, 3] - pieces[:, 2]).tolist()):
        if fill + size > seg_entries and i > seg_ptr[-1]:
            seg_ptr.append(i)
            fill = 0
        fill += size
    if pieces.shape[0]:
        seg_ptr.append(pieces.shape[0])
    seg_ptr = np.asarray(seg_ptr, np.int64)
    size = pieces[:, 3] - pieces[:, 2]
    start = np.cumsum(size) - size
    poff = start - np.repeat(start[seg_ptr[:-1]], np.diff(seg_ptr))
    return (pieces.astype(np.int32), seg_ptr.astype(np.int32),
            poff.astype(np.int32))


_FIELDS = ("rows", "cols", "vals", "block_row", "block_col")


class _Work(NamedTuple):
    gtab: torch.Tensor       # (G, 4) int64: rows, cols, vals pointers, S
    pieces: torch.Tensor     # (P, 6) int32
    poff: torch.Tensor       # (P,) int32
    seg_ptr: torch.Tensor    # (n_seg + 1,) int32
    n_seg: int
    q: int                   # the entries name intervals < q ...
    t: int                   # ... and rows and columns < t
    keep: tuple              # the group tensors whose pointers gtab holds


def _build_work(groups: Sequence[Dict[str, torch.Tensor]], counts, brow,
                bcol, q: int, t: int) -> _Work:
    """The work table of device groups, from host arrays of their real
    counts and tile intervals."""
    dev = groups[0]["rows"].device
    pieces, seg_ptr, poff = work_table(counts, brow, bcol)
    gtab = torch.tensor([[gr["rows"].data_ptr(), gr["cols"].data_ptr(),
                          gr["vals"].data_ptr(), gr["rows"].shape[1]]
                         for gr in groups], dtype=torch.int64).to(dev)
    return _Work(gtab, torch.from_numpy(pieces).to(dev),
                 torch.from_numpy(poff).to(dev),
                 torch.from_numpy(seg_ptr).to(dev), seg_ptr.size - 1, q, t,
                 tuple(gr[k] for gr in groups for k in _FIELDS))


class PlanGroups(list):
    """A plan's bucket groups on their device: the list of group dicts
    (`rows`, `cols`, `vals`, `block_row`, `block_col`) every consumer
    reads, and in `work` the kernel's work table, built from the host
    arrays as they are uploaded, so that no launch reads back or checks
    them again.  The groups are constants of the plan: a launch takes
    the table as built."""

    def __init__(self, groups: Sequence[PackedGroup], dev: torch.device):
        super().__init__(
            {k: torch.from_numpy(np.ascontiguousarray(getattr(gr, k))).to(dev)
             for k in _FIELDS} for gr in groups)
        self.work = None
        if groups:
            self.work = _build_work(
                self, [real_counts(*(torch.from_numpy(getattr(gr, k))
                                     for k in _FIELDS[:3])).numpy()
                       for gr in groups],
                [gr.block_row for gr in groups],
                [gr.block_col for gr in groups],
                q=1 + max(int(a.max(initial=0)) for gr in groups
                          for a in (gr.block_row, gr.block_col)),
                t=1 + max(int(a.max(initial=0)) for gr in groups
                          for a in (gr.rows, gr.cols)))


def _check_groups(groups, dev: torch.device, q: int, t: int) -> None:
    for gr in groups:
        check_tensor(gr["rows"], "rows", torch.int32, dev, 2)
        check_tensor(gr["cols"], "cols", torch.int32, dev, 2)
        check_tensor(gr["vals"], "vals", torch.float32, dev, 2)
        check_tensor(gr["block_row"], "block_row", torch.int32, dev, 1)
        check_tensor(gr["block_col"], "block_col", torch.int32, dev, 1)
        k, s = gr["rows"].shape
        if gr["cols"].shape != (k, s) or gr["vals"].shape != (k, s):
            raise ValueError("rows, cols and vals must share one (K, S) "
                             "shape")
        if gr["block_row"].numel() != k or gr["block_col"].numel() != k:
            raise ValueError(f"{k} packed tiles but block_row/block_col "
                             f"hold {gr['block_row'].numel()}/"
                             f"{gr['block_col'].numel()}")
        check_range(gr["rows"], t, "rows")
        check_range(gr["cols"], t, "cols")
        check_range(gr["block_row"], q, "block_row")
        check_range(gr["block_col"], q, "block_col")


def groups_work(groups: Sequence[Dict[str, torch.Tensor]], q: int, t: int,
          dev: torch.device) -> _Work:
    """A plan's table, held to the grid of x; for any other list of
    groups, a table built now, after the groups' checks, from the real
    counts and tile intervals read back to the host."""
    w = getattr(groups, "work", None)
    if w is None:
        _check_groups(groups, dev, q, t)
        w = _build_work(
            groups, [real_counts(gr["rows"], gr["cols"], gr["vals"])
                     .cpu().numpy() for gr in groups],
            [gr["block_row"].cpu().numpy() for gr in groups],
            [gr["block_col"].cpu().numpy() for gr in groups], q, t)
    if w.gtab.device != dev:
        raise ValueError(f"the groups lie on {w.gtab.device}, x on {dev}")
    if w.q > q or w.t > t:
        raise ValueError(f"the groups name {w.q} intervals of {w.t} rows; "
                         f"x holds {q} of {t}")
    return w


_LIB = None


def _lib():
    global _LIB
    if _LIB is None:
        lib = _build.load("rer_gather")
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.rer_gather_launch.argtypes = [p, p, p, p, i, p, p, i, i, i, i, i,
                                          p]
        lib.rer_gather_launch.restype = i
        lib.rer_gather_part_launch.argtypes = [p, p, p, i, i, p, p, i, i, i,
                                               p]
        lib.rer_gather_part_launch.restype = i
        _LIB = lib
    return _LIB


def _launch(groups, x, q, op, finish) -> torch.Tensor:
    """Check the arguments and launch the kernel once over every group
    (counted by the caller)."""
    dev = x.device
    check_tensor(x, "x", torch.float32, dev, 2)
    if q <= 0 or x.shape[0] % q:
        raise ValueError(f"x rows {x.shape[0]} are not q={q} intervals")
    t = x.shape[0] // q
    f = x.shape[1]
    w = groups_work(groups, q, t, dev)
    y = torch.empty((q * t, f), dtype=torch.float32, device=dev)
    status = _lib().rer_gather_launch(
        w.gtab.data_ptr(), w.pieces.data_ptr(), w.poff.data_ptr(),
        w.seg_ptr.data_ptr(), w.n_seg, x.data_ptr(), y.data_ptr(), q, t, f,
        int(op == "max"), int(finish), stream_handle(dev))
    check_status(status, "rer_gather")
    return y


def packed_groups_plain(groups: Sequence[Dict[str, torch.Tensor]],
                        x: torch.Tensor, *, q: int, op: str = "sum",
                        finish: bool = True) -> torch.Tensor:
    """The plain version of a whole aggregate, on any device: one
    `packed_spmm_plain` per group, raw partials merged by + / maximum,
    -inf finished once (unless `finish=False`)."""
    y = None
    for gr in groups:
        part = packed_spmm_plain(gr["rows"], gr["cols"], gr["vals"],
                                 gr["block_row"], gr["block_col"], x, q=q,
                                 op=op, finish=False)
        if y is None:
            y = part
        elif op == "sum":
            y = y.add_(part)
        else:
            y = torch.maximum(y, part, out=y)
    if op == "max" and finish:
        y = torch.where(torch.isneginf(y), 0.0, y)
    return y


def _aggregate(groups, x, q, op, finish, key) -> torch.Tensor:
    if x.device.type == "cpu":
        return packed_groups_plain(groups, x, q=q, op=op, finish=finish)
    if x.device.type != "cuda":
        raise ValueError(f"no rer_gather for device {x.device}")
    if not groups:
        raise ValueError("an aggregate needs at least one bucket group")
    y = _launch(groups, x, q, op, finish)
    LAUNCHES[key] += 1
    return y


def packed_spmm(rows: torch.Tensor, cols: torch.Tensor, vals: torch.Tensor,
                block_row: torch.Tensor, block_col: torch.Tensor,
                x: torch.Tensor, *, q: int, op: str = "sum",
                finish: bool = True) -> torch.Tensor:
    """One bucket group: x (q*T, F) -> y (q*T, F).  `finish=False` keeps
    -inf in uncovered max rows, for callers that merge partials.  CPU
    tensors take the plain version; CUDA tensors the kernel, with a work
    table built at each call (one read back).  One group is a raw call
    form without a gradient: differentiate a plan's groups as a whole
    through `packed_groups_spmm`."""
    if op not in ("sum", "max"):
        raise ValueError(op)
    if x.device.type == "cuda":
        refuse_grad("rer_gather", vals, x,
                    why="differentiates a plan's bucket groups only as a "
                        "whole, through packed_groups_spmm")
    gr = {"rows": rows, "cols": cols, "vals": vals, "block_row": block_row,
          "block_col": block_col}
    return _aggregate([gr], x, q, op, finish, op)


class _PackedGroups(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, groups, q, op):
        y = _aggregate(groups, x, q, op, True, op)
        ctx.groups, ctx.q, ctx.op = groups, q, op
        if op == "max":
            ctx.save_for_backward(x, y)
        return y

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        from repro_torch.kernels.rer_gather_bwd import (packed_groups_t,
                                                        packed_max_backward)
        g = g.contiguous()
        with span("engn.aggregate_bwd"):
            if ctx.op == "sum":
                dx = packed_groups_t(ctx.groups, g, q=ctx.q)
            else:
                x, y = ctx.saved_tensors
                dx = packed_max_backward(ctx.groups, x, y, g, q=ctx.q)
        return dx, None, None, None


def packed_groups_spmm(groups: Sequence[Dict[str, torch.Tensor]],
                       x: torch.Tensor, *, q: int, op: str = "sum"
                       ) -> torch.Tensor:
    """The aggregate over a plan's bucket groups (dicts of `rows`,
    `cols`, `vals`, `block_row`, `block_col`): one kernel launch over
    every group on CUDA (the plain per-group partials merged by + /
    maximum on the CPU), -inf finished once.  Under autograd the
    backward walks the same groups: `rer_gather_bwd.packed_groups_t`
    for the sum, `packed_max_backward` (winner words, resolve, tie walk)
    for the max."""
    if op not in ("sum", "max"):
        raise ValueError(op)
    if any(gr["vals"].requires_grad for gr in groups):
        raise NotImplementedError("rer_gather differentiates x only; the "
                                  "entries are the graph, a constant")
    if not (torch.is_grad_enabled() and x.requires_grad):
        return _aggregate(groups, x, q, op, True, op)
    return _PackedGroups.apply(x, groups, q, op)


def packed_tile_part(rows: torch.Tensor, cols: torch.Tensor,
                     vals: torch.Tensor, xs: torch.Tensor, *,
                     op: str = "sum", checked: bool = False) -> torch.Tensor:
    """One streamed chunk: (C, S) packed entries against the (C, T, F)
    stack of their source intervals -> (T, F) raw partial for a single
    destination interval.  CPU tensors take the plain version; CUDA
    tensors the kernel, one warp per (tile, 64-slot slice).
    `checked=True` is the caller's word that rows and cols
    lie in [0, T) (the streamed executor checks its host store once);
    otherwise they are checked here, which reads back to the host."""
    if op not in ("sum", "max"):
        raise ValueError(op)
    if xs.device.type == "cpu":
        return packed_tile_part_plain(rows, cols, vals, xs, op=op)
    if xs.device.type != "cuda":
        raise ValueError(f"no rer_gather for device {xs.device}")
    refuse_grad("rer_gather's tile part", vals, xs,
                why="is a forward step of the streamed executor; its "
                    "gradient is the transposed re-stream (core/tiled.py "
                    "make_streamed_aggregate)")
    dev = xs.device
    check_tensor(rows, "rows", torch.int32, dev, 2)
    check_tensor(cols, "cols", torch.int32, dev, 2)
    check_tensor(vals, "vals", torch.float32, dev, 2)
    check_tensor(xs, "xs", torch.float32, dev, 3)
    c, t, f = xs.shape
    s = rows.shape[1]
    if rows.shape != (c, s) or cols.shape != (c, s) or vals.shape != (c, s):
        raise ValueError(f"entries {tuple(rows.shape)} / {tuple(cols.shape)}"
                         f" / {tuple(vals.shape)} do not match {c} tiles")
    if not checked:
        check_range(rows, t, "rows")
        check_range(cols, t, "cols")
    y = torch.empty((t, f), dtype=torch.float32, device=dev)
    status = _lib().rer_gather_part_launch(
        rows.data_ptr(), cols.data_ptr(), vals.data_ptr(), c, s,
        xs.data_ptr(), y.data_ptr(), t, f, int(op == "max"),
        stream_handle(dev))
    check_status(status, "rer_gather")
    LAUNCHES["tile_part_" + op] += 1
    return y
