"""Fused feature extraction + RER aggregate (paper Fig. 8).

`fused_engn_layer` computes Y = A (X W) over the dense tiles of A: the
hand-written CUDA kernel `csrc/fused_engn.cu` for CUDA tensors,
`fused_engn_plain` (per-tile X W, batched tile product, reduce at the
destination intervals) for CPU tensors.  Under autograd it is a
`torch.autograd.Function` whose backward is `fused_engn_bwd`:
dP = A^T G by the `rer_spmm` kernel's transposed launcher over the same
forward tiles (no carrier of A^T is built), then dX = dP W^T and
dW = X^T dP, two plain matrix products outside any kernel, as the
reference leaves them to XLA.

Source note.  Replaces `repro/kernels/fused_engn/fused_engn.py::
fused_extract_aggregate` (`_fused_kernel`).  On the H100 it is bound by
bytes at the training shapes and by operations at cora's first layer
(P = X W over F = 1433).  The kernel is source-stationary: one CTA per
(column piece, source slab of 16 rows, or 8 on grids under one wave,
output chunk of <= 256 columns) computes its slab's P = X W once into
shared memory, then streams the piece's tiles (`column_table`: the
tiles in column order, cut into pieces of at most `PIECE_TILES`) and
adds a * P[u] into Y for each nonzero only, with global atomics.  Every
tile byte is read once per call; T is at most 256.  See the kernel
source for the rest.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch
from torch.autograd.function import once_differentiable

from repro_torch.kernels import _build
from repro_torch.kernels._common import (check_range, check_status,
                                         check_tensor, stream_handle)
from repro_torch.kernels.rer_spmm import ops as spmm_ops

# kernel launches, counted where the kernel is launched (the backward's
# A^T G is a rer_spmm launch, counted there as "sum_t")
LAUNCHES = {"sum": 0}

MAX_TILE = 256      # tile rows a CTA's shared-memory stages hold


class ColumnTable(NamedTuple):
    """The kernel's walk of a dense carrier, on its device: `order`, the
    tiles in column order (a stable argsort of `block_col`, so the tiles
    of one source interval keep the carrier's order), and `pieces`, an
    (n_pieces, 4) int32 table of (source interval, first, end position
    in `order`, split) rows cutting each column span into balanced
    pieces of at most `PIECE_TILES` tiles (`rer_spmm.span_pieces`)."""
    order: torch.Tensor
    pieces: torch.Tensor

    @property
    def nbytes(self) -> int:
        return sum(t.numel() * t.element_size() for t in self)


def column_order(block_col: np.ndarray, q: int):
    """(order, pieces) of `ColumnTable` on the host, from the carrier's
    `block_col`."""
    block_col = np.asarray(block_col)
    order = np.argsort(block_col, kind="stable").astype(np.int32)
    ptr = np.concatenate([[0], np.cumsum(np.bincount(block_col,
                                                     minlength=q))])
    pieces, _ = spmm_ops.span_pieces(ptr)
    return order, pieces


def column_table(block_col: np.ndarray, q: int,
                 device: torch.device) -> ColumnTable:
    """The `ColumnTable` of a carrier, built from its host `block_col`
    and uploaded to `device` (a `fused` plan builds it once)."""
    order, pieces = column_order(block_col, q)
    return ColumnTable(torch.from_numpy(order).to(device),
                       torch.from_numpy(pieces).to(device))


def fused_engn_plain(blocks: torch.Tensor, block_row: torch.Tensor,
                     block_col: torch.Tensor, x: torch.Tensor,
                     w: torch.Tensor, *, q: int) -> torch.Tensor:
    """The fused dataflow in plain PyTorch, on any device."""
    nnzb, t, _ = blocks.shape
    h = w.shape[1]
    p = torch.matmul(x.reshape(q, t, x.shape[1])[block_col.long()], w)
    contrib = torch.bmm(blocks, p)                       # (nnzb, T, H)
    y = torch.zeros(q, t, h, dtype=torch.float32, device=x.device)
    y.index_add_(0, block_row.long(), contrib)
    return y.reshape(q * t, h)


_LIB = None


def _lib():
    global _LIB
    if _LIB is None:
        lib = _build.load("fused_engn")
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.fused_engn_launch.argtypes = [p, p, p, p, i, p, p, p, i, i, i,
                                          i, p]
        lib.fused_engn_launch.restype = i
        _LIB = lib
    return _LIB


def _forward(blocks, block_row, block_col, x, w, q,
             columns: Optional[ColumnTable]) -> torch.Tensor:
    if x.device.type == "cpu":
        return fused_engn_plain(blocks, block_row, block_col, x, w, q=q)
    if x.device.type != "cuda":
        raise ValueError(f"no fused_engn for device {x.device}")
    dev = x.device
    check_tensor(blocks, "blocks", torch.float32, dev, 3)
    check_tensor(block_row, "block_row", torch.int32, dev, 1)
    check_tensor(block_col, "block_col", torch.int32, dev, 1)
    check_tensor(x, "x", torch.float32, dev, 2)
    check_tensor(w, "w", torch.float32, dev, 2)
    nnzb, t, t2 = blocks.shape
    if t != t2 or block_row.numel() != nnzb or block_col.numel() != nnzb:
        raise ValueError(f"tiles {tuple(blocks.shape)} do not match "
                         f"block_row {tuple(block_row.shape)} / block_col "
                         f"{tuple(block_col.shape)}")
    if t > MAX_TILE:
        raise ValueError(f"the fused kernel takes T <= {MAX_TILE}, got {t}")
    if x.shape[0] != q * t or x.shape[1] != w.shape[0]:
        raise ValueError(f"x {tuple(x.shape)} and w {tuple(w.shape)} do "
                         f"not match q*T = {q * t}")
    f, h = w.shape
    check_range(block_row, q, "block_row")
    check_range(block_col, q, "block_col")
    if columns is None:
        # a carrier without its table (raw tiles): built for this call
        columns = column_table(block_col.cpu().numpy(), q, dev)
    check_tensor(columns.order, "order", torch.int32, dev, 1)
    check_tensor(columns.pieces, "pieces", torch.int32, dev, 2)
    if columns.order.numel() != nnzb or columns.pieces.shape[1] != 4:
        raise ValueError(f"column table {tuple(columns.order.shape)} / "
                         f"{tuple(columns.pieces.shape)} does not match "
                         f"{nnzb} tiles")
    y = torch.empty((q * t, h), dtype=torch.float32, device=dev)
    status = _lib().fused_engn_launch(
        blocks.data_ptr(), block_row.data_ptr(), columns.order.data_ptr(),
        columns.pieces.data_ptr(), columns.pieces.shape[0], x.data_ptr(),
        w.data_ptr(), y.data_ptr(), q, t, f, h, stream_handle(dev))
    check_status(status, "fused_engn")
    LAUNCHES["sum"] += 1
    return y


def fused_engn_bwd_plain(blocks: torch.Tensor, block_row: torch.Tensor,
                         block_col: torch.Tensor, x: torch.Tensor,
                         w: torch.Tensor, g: torch.Tensor, *, q: int
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(dX, dW) in plain PyTorch, on any device."""
    dp = spmm_ops.blocked_spmm_t_plain(blocks, block_row, block_col, g,
                                       q=q)
    return dp @ w.t(), x.t() @ dp


def fused_engn_bwd(blocks: torch.Tensor, block_row: torch.Tensor,
                   block_col: torch.Tensor, x: torch.Tensor,
                   w: torch.Tensor, g: torch.Tensor, *, q: int
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The backward of Y = A (X W) for the cotangent G (q*T, H): dP =
    A^T G over the forward tiles by `rer_spmm.blocked_spmm_t`, dX = dP
    W^T, dW = X^T dP.  CPU tensors take the plain version; CUDA tensors
    the `rer_spmm` kernel's transposed launcher for dP."""
    dp = spmm_ops.blocked_spmm_t(blocks, block_row, block_col, g, q=q)
    return dp @ w.t(), x.t() @ dp


class _Fused(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, blocks, block_row, block_col, q, columns):
        ctx.save_for_backward(x, w)
        ctx.q, ctx.carrier = q, (blocks, block_row, block_col)
        return _forward(blocks, block_row, block_col, x, w, q, columns)

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        dx, dw = fused_engn_bwd(*ctx.carrier, x, w, g.contiguous(),
                                q=ctx.q)
        return dx, dw, None, None, None, None, None


def fused_engn_layer(blocks: torch.Tensor, block_row: torch.Tensor,
                     block_col: torch.Tensor, x: torch.Tensor,
                     w: torch.Tensor, *, q: int,
                     columns: Optional[ColumnTable] = None
                     ) -> torch.Tensor:
    """Y (q*T, H) = A (X W) over the dense tiles of A (an interval
    without tiles comes out 0).  CPU tensors take the plain version;
    CUDA tensors the kernel, which walks the tiles by `columns` (the
    plan's `ColumnTable`; built for the call when None).  Under autograd
    the backward (`fused_engn_bwd`) walks the same tiles."""
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no fused_engn for device {x.device}")
    if blocks.requires_grad:
        raise NotImplementedError("fused_engn differentiates x and w only; "
                                  "the tiles are the graph, a constant")
    if not (torch.is_grad_enabled()
            and (x.requires_grad or w.requires_grad)):
        return _forward(blocks, block_row, block_col, x, w, q, columns)
    return _Fused.apply(x, w, blocks, block_row, block_col, q, columns)
