"""The max backward of RER-SpMM over dense tiles.

`blocked_spmm_max_bwd` launches the hand-written CUDA kernel of
`csrc/rer_spmm_bwd.cu` for CUDA tensors and runs
`blocked_spmm_max_bwd_plain` for CPU tensors.  Both give dX of
`blocked_spmm(..., op="max")` with the reference's tie convention, which
autodiff of `blocked_spmm_xla` sets at two levels: `jnp.max` over the
sources of a tile splits a tile's cotangent evenly over its tied
sources, `segment_max` over the tiles of a destination interval splits
it evenly over the tied tiles (three tied winners, two in one tile and
one in another, get 1/4, 1/4, 1/2).

Source note.  The backward of `repro/kernels/rer_spmm/rer_spmm.py::
rer_spmm` (`_spmm_kernel_max`), which the reference differentiates only
through XLA.  On the H100 it is bound by bytes: the kernel walks the
forward tiles once (no transposed carrier, no scratch), one CTA per
(destination interval, slab of R rows, feature chunk), compacts each
slab's nonzeros into a shared list segmented by row (`RowCounts`, the
nonzeros of each destination row, counted on the host from the tile
store; `slab_rows` picks the largest R whose slabs fit the list), then
counts the winners per tile and scatters into dX with atomics.  The
winners are found by recomputing each product as the forward kernel
did.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional

import numpy as np
import torch

from repro_torch.kernels import _build
from repro_torch.kernels._common import (check_range, check_status,
                                         check_tensor, stream_handle,
                                         tile_ptr)

# kernel launches (one per backward), counted where launched
LAUNCHES = {"max": 0}

# the kernel's shared list: (source row, value) entries per CTA
LIST_CAP = 4096
# slab height limits of the kernel: R <= MAX_ROWS, R*T <= SLAB_FLOATS
MAX_ROWS = 32
SLAB_FLOATS = 4096
# tiles counted per step on the host
_COUNT_TILES = 256

# elements of one (tiles, T, T, F) candidate slab in the plain version
_PLAIN_SLAB = 1 << 26


def _winners(blocks, src, yk):
    """(c, T, U, F) mask of the tied winners of c tiles: A != 0 and
    A * x == y, the product rounded as the forward rounds it."""
    b = blocks[:, :, :, None]
    return (b != 0.0) & (b * src[:, None, :, :] == yk[:, :, None, :])


def blocked_spmm_max_bwd_plain(blocks: torch.Tensor, block_row: torch.Tensor,
                               block_col: torch.Tensor, x: torch.Tensor,
                               y: torch.Tensor, g: torch.Tensor, *,
                               q: int) -> torch.Tensor:
    """dX (q*T, F) in plain PyTorch, on any device: per-tile winner
    counts, tied tiles per row, then `index_add_` into the source
    rows."""
    nnzb, t, _ = blocks.shape
    f = x.shape[1]
    brow, bcol = block_row.long(), block_col.long()
    src = x.reshape(q, t, f)[bcol]                      # (nnzb, T, F)
    yk = y.reshape(q, t, f)[brow]
    step = max(1, _PLAIN_SLAB // max(1, t * t * f))
    cnt = torch.empty((nnzb, t, f), dtype=torch.float32, device=x.device)
    for k0 in range(0, nnzb, step):
        k1 = k0 + step
        cnt[k0:k1] = _winners(blocks[k0:k1], src[k0:k1],
                              yk[k0:k1]).sum(dim=2, dtype=torch.float32)
    ntie = torch.zeros((q, t, f), dtype=torch.float32, device=x.device)
    ntie.index_add_(0, brow, (cnt > 0).float())
    gk = g.reshape(q, t, f)[brow]
    wgt = torch.where(cnt > 0, gk / (cnt * ntie[brow]),
                      torch.zeros((), device=x.device))
    dx = torch.zeros((q, t, f), dtype=torch.float32, device=x.device)
    for k0 in range(0, nnzb, step):
        k1 = k0 + step
        win = _winners(blocks[k0:k1], src[k0:k1], yk[k0:k1])
        part = (win * blocks[k0:k1, :, :, None]
                * wgt[k0:k1, :, None, :]).sum(dim=1)     # (c, U, F)
        dx.index_add_(0, bcol[k0:k1], part)
    return dx.reshape(q * t, f)


class RowCounts(NamedTuple):
    """What the kernel needs of a carrier's nonzeros: `dev`, the (q*T,)
    int32 nonzeros of each destination row over its interval's tiles
    (the shared list's segments), and `rows`, the slab height R that
    `slab_rows` picked from them."""
    dev: torch.Tensor
    rows: int

    @property
    def nbytes(self) -> int:
        return self.dev.numel() * self.dev.element_size()


def row_counts(blocks: np.ndarray, block_row: np.ndarray,
               q: int) -> np.ndarray:
    """(q*T,) int32: the nonzeros of each destination row summed over the
    tiles of its interval, counted from a host tile store."""
    t = blocks.shape[1]
    out = np.zeros((q, t), np.int64)
    for k0 in range(0, blocks.shape[0], _COUNT_TILES):
        k1 = k0 + _COUNT_TILES
        np.add.at(out, np.asarray(block_row[k0:k1]),
                  np.count_nonzero(blocks[k0:k1], axis=2))
    return out.reshape(-1).astype(np.int32)


def slab_max(counts: np.ndarray, t: int, rows: int) -> int:
    """The most nonzeros any slab of `rows` rows (rows r0 .. r0+rows of
    one interval) holds."""
    c = np.asarray(counts, np.int64).reshape(-1, t)
    pad = -t % rows
    if pad:
        c = np.concatenate([c, np.zeros((c.shape[0], pad), np.int64)], 1)
    return int(c.reshape(c.shape[0], -1, rows).sum(axis=2).max(initial=0))


def slab_rows(counts: np.ndarray, t: int) -> int:
    """The kernel's slab height R for a carrier: the largest of 32, 16,
    .., 1 with R <= T and R*T <= SLAB_FLOATS whose fullest slab fits the
    shared list (`LIST_CAP`); 1 when none does (the slabs over the list
    then walk their span twice in the kernel)."""
    rows = 1
    while 2 * rows <= min(MAX_ROWS, t, SLAB_FLOATS // t):
        rows *= 2
    while rows > 1 and slab_max(counts, t, rows) > LIST_CAP:
        rows //= 2
    return rows


def upload_row_counts(blocks: np.ndarray, block_row: np.ndarray, q: int,
                      device: torch.device) -> RowCounts:
    """`RowCounts` of a host carrier, uploaded to `device` (a dense max
    plan builds them once)."""
    host = row_counts(blocks, block_row, q)
    return RowCounts(torch.from_numpy(host).to(device),
                     slab_rows(host, blocks.shape[1]))


def _device_row_counts(blocks: torch.Tensor, block_row: torch.Tensor,
                       q: int) -> RowCounts:
    """`RowCounts` of a device carrier without them (raw tiles): counted
    on the device and read back, once per call."""
    t = blocks.shape[1]
    per_tile = torch.count_nonzero(blocks, dim=2)           # (nnzb, T)
    dev = torch.zeros((q, t), dtype=torch.int64, device=blocks.device)
    dev.index_add_(0, block_row.long(), per_tile)
    dev = dev.reshape(-1).to(torch.int32)
    return RowCounts(dev, slab_rows(dev.cpu().numpy(), t))


_LIB = None


def _lib():
    global _LIB
    if _LIB is None:
        lib = _build.load("rer_spmm_bwd")
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.rer_spmm_max_bwd_launch.argtypes = [p] * 8 + [i] * 5 + [p]
        lib.rer_spmm_max_bwd_launch.restype = i
        _LIB = lib
    return _LIB


def blocked_spmm_max_bwd(blocks: torch.Tensor, block_row: torch.Tensor,
                         block_col: torch.Tensor, x: torch.Tensor,
                         y: torch.Tensor, g: torch.Tensor, *, q: int,
                         counts: Optional[RowCounts] = None) -> torch.Tensor:
    """dX of Y = max-aggregate(A, X) for the cotangent G: forward tiles
    (`blocks`, `block_row`, `block_col`, dst-sorted), the forward's X and
    finished Y, all (q*T, F).  CPU tensors take the plain version; CUDA
    tensors the kernel, with the carrier's `RowCounts` (counted on the
    device and read back for the call when None)."""
    if x.device.type == "cpu":
        return blocked_spmm_max_bwd_plain(blocks, block_row, block_col, x, y,
                                          g, q=q)
    if x.device.type != "cuda":
        raise ValueError(f"no rer_spmm_bwd for device {x.device}")
    dev = x.device
    check_tensor(blocks, "blocks", torch.float32, dev, 3)
    check_tensor(block_row, "block_row", torch.int32, dev, 1)
    check_tensor(block_col, "block_col", torch.int32, dev, 1)
    for name, tensor in (("x", x), ("y", y), ("g", g)):
        check_tensor(tensor, name, torch.float32, dev, 2)
    nnzb, t, t2 = blocks.shape
    if t != t2 or block_row.numel() != nnzb or block_col.numel() != nnzb:
        raise ValueError(f"tiles {tuple(blocks.shape)} do not match "
                         f"block_row {tuple(block_row.shape)} / block_col "
                         f"{tuple(block_col.shape)}")
    if x.shape[0] != q * t or y.shape != x.shape or g.shape != x.shape:
        raise ValueError(f"x {tuple(x.shape)}, y {tuple(y.shape)} and g "
                         f"{tuple(g.shape)} must all be (q*T = {q * t}, F)")
    f = x.shape[1]
    ptr = tile_ptr(block_row, q)
    check_range(block_col, q, "block_col")
    if counts is None:
        counts = _device_row_counts(blocks, block_row, q)
    check_tensor(counts.dev, "row counts", torch.int32, dev, 1)
    if counts.dev.numel() != q * t or not 1 <= counts.rows <= MAX_ROWS:
        raise ValueError(f"row counts {counts.dev.numel()} / R = "
                         f"{counts.rows} do not match q*T = {q * t}")
    vec = t % 4 == 0 and blocks.data_ptr() % 16 == 0
    dx = torch.empty((q * t, f), dtype=torch.float32, device=dev)
    status = _lib().rer_spmm_max_bwd_launch(
        blocks.data_ptr(), block_col.data_ptr(), ptr.data_ptr(),
        counts.dev.data_ptr(), x.data_ptr(), y.data_ptr(), g.data_ptr(),
        dx.data_ptr(), q, t, f, counts.rows, int(vec), stream_handle(dev))
    check_status(status, "rer_spmm_bwd")
    LAUNCHES["max"] += 1
    return dx
