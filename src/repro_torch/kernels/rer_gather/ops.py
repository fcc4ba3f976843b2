"""RER-Gather: the aggregate over packed edge tiles.

Host side (numpy, the reference's carriers field for field):
`prepare_packed_groups` groups the packed tiles by pow2 nnz bucket, each
group dst-sorted with every interval present; `flat_entries` flattens
the store to global `(gsrc, gdst, gval)` entries.

Device side: `packed_spmm` launches the hand-written CUDA kernel
`csrc/rer_gather.cu` on one bucket group for CUDA tensors, and runs
`packed_spmm_plain` (gather the referenced rows, scale, segment-reduce)
for CPU tensors.  `packed_flat_plain` is the one-launch plain form the
CPU path of `prepare_graph` carries.  `packed_tile_part` is the streamed
executor's call form of the same kernel: one chunk of C packed tiles
against the (C, T, F) stack of their source intervals, reduced into one
destination interval's raw (T, F) partial; its plain version is
`packed_tile_part_plain`.

Source note.  Replaces `repro/kernels/rer_gather/rer_gather.py::
rer_gather` (`_gather_kernel_sum`, `_gather_kernel_max`).  On the H100
it is bound by bytes: 12 B per entry plus one referenced feature row.
The kernel reads each referenced X row directly (the reference's one-hot
MXU gather is a TPU workaround), walks an interval's tile span per CTA
with a T x 32 shared-memory accumulator, and merges the warps' entries
with shared-memory atomics (sum) or a compare-and-swap float max (max,
exact in any order).  See the kernel source for the rest.
"""
from __future__ import annotations

import ctypes
import dataclasses
from typing import List

import numpy as np
import torch

from repro_torch.graphs.partition import PackedTileStore, pow2_bucket
from repro_torch.kernels import _build
from repro_torch.kernels._common import (check_range, check_status,
                                         check_tensor, refuse_grad,
                                         stream_handle, tile_ptr)

# kernel launches by op and call form, counted where the kernel is
# launched: "sum"/"max" for bucket groups, "tile_part_*" for the
# streamed executor's chunks
LAUNCHES = {"sum": 0, "max": 0, "tile_part_sum": 0, "tile_part_max": 0}


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


_LIB = None


def _lib():
    global _LIB
    if _LIB is None:
        lib = _build.load("rer_gather")
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.rer_gather_launch.argtypes = [p, p, p, p, p, p, p,
                                          i, i, i, i, i, i, p]
        lib.rer_gather_launch.restype = i
        _LIB = lib
    return _LIB


def packed_spmm(rows: torch.Tensor, cols: torch.Tensor, vals: torch.Tensor,
                block_row: torch.Tensor, block_col: torch.Tensor,
                x: torch.Tensor, *, q: int, op: str = "sum",
                finish: bool = True) -> torch.Tensor:
    """One bucket group: x (q*T, F) -> y (q*T, F).  `finish=False` keeps
    -inf in uncovered max rows, for callers that merge partials.  CPU
    tensors take the plain version; CUDA tensors the kernel."""
    if op not in ("sum", "max"):
        raise ValueError(op)
    if x.device.type == "cpu":
        return packed_spmm_plain(rows, cols, vals, block_row, block_col, x,
                                 q=q, op=op, finish=finish)
    if x.device.type != "cuda":
        raise ValueError(f"no rer_gather for device {x.device}")
    refuse_grad("rer_gather", vals, x)
    dev = x.device
    check_tensor(rows, "rows", torch.int32, dev, 2)
    check_tensor(cols, "cols", torch.int32, dev, 2)
    check_tensor(vals, "vals", torch.float32, dev, 2)
    check_tensor(block_row, "block_row", torch.int32, dev, 1)
    check_tensor(block_col, "block_col", torch.int32, dev, 1)
    check_tensor(x, "x", torch.float32, dev, 2)
    k, s = rows.shape
    if cols.shape != (k, s) or vals.shape != (k, s):
        raise ValueError("rows, cols and vals must share one (K, S) shape")
    if block_row.numel() != k or block_col.numel() != k:
        raise ValueError(f"{k} packed tiles but block_row/block_col hold "
                         f"{block_row.numel()}/{block_col.numel()}")
    if q <= 0 or x.shape[0] % q:
        raise ValueError(f"x rows {x.shape[0]} are not q={q} intervals")
    t = x.shape[0] // q
    f = x.shape[1]
    ptr = tile_ptr(block_row, q)
    check_range(block_col, q, "block_col")
    check_range(rows, t, "rows")
    check_range(cols, t, "cols")
    y = torch.empty((q * t, f), dtype=torch.float32, device=dev)
    status = _lib().rer_gather_launch(
        rows.data_ptr(), cols.data_ptr(), vals.data_ptr(),
        block_col.data_ptr(), ptr.data_ptr(), x.data_ptr(), y.data_ptr(),
        q, s, t, f, int(op == "max"), int(finish), stream_handle(dev))
    check_status(status, "rer_gather")
    LAUNCHES[op] += 1
    return y


# (C, device) -> the q=1 span pointers [0, C] and source intervals
# arange(C) of a tile-part launch: built once, so no launch synchronises
_PART_INDEX = {}


def _part_index(c: int, dev: torch.device):
    key = (c, str(dev))
    hit = _PART_INDEX.get(key)
    if hit is None:
        hit = (torch.tensor([0, c], dtype=torch.int32, device=dev),
               torch.arange(c, dtype=torch.int32, device=dev))
        _PART_INDEX[key] = hit
    return hit


def packed_tile_part(rows: torch.Tensor, cols: torch.Tensor,
                     vals: torch.Tensor, xs: torch.Tensor, *,
                     op: str = "sum", checked: bool = False) -> torch.Tensor:
    """One streamed chunk: (C, S) packed entries against the (C, T, F)
    stack of their source intervals -> (T, F) raw partial for a single
    destination interval.  CPU tensors take the plain version; CUDA
    tensors the kernel, as a one-interval launch (q=1) with T passed
    explicitly.  `checked=True` is the caller's word that rows and cols
    lie in [0, T) (the streamed executor checks its host store once);
    otherwise they are checked here, which reads back to the host."""
    if op not in ("sum", "max"):
        raise ValueError(op)
    if xs.device.type == "cpu":
        return packed_tile_part_plain(rows, cols, vals, xs, op=op)
    if xs.device.type != "cuda":
        raise ValueError(f"no rer_gather for device {xs.device}")
    refuse_grad("rer_gather", vals, xs)
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
    ptr, block_col = _part_index(c, dev)
    y = torch.empty((t, f), dtype=torch.float32, device=dev)
    status = _lib().rer_gather_launch(
        rows.data_ptr(), cols.data_ptr(), vals.data_ptr(),
        block_col.data_ptr(), ptr.data_ptr(), xs.data_ptr(), y.data_ptr(),
        1, s, t, f, int(op == "max"), 0, stream_handle(dev))
    check_status(status, "rer_gather")
    LAUNCHES["tile_part_" + op] += 1
    return y
