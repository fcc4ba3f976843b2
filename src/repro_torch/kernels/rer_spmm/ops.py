"""RER-SpMM: the aggregate over dense T x T tiles, forward and backward.

`blocked_spmm` launches the hand-written CUDA kernel `csrc/rer_spmm.cu`
for CUDA tensors and runs `blocked_spmm_plain`, the same tiled dataflow
in plain PyTorch (tile gather + batched tile product + reduce at the
destination intervals), for CPU tensors.  Under autograd it is a
`torch.autograd.Function`:

  * sum: dX = A^T G, the same kernel over the transposed carrier
    (`TransposedBlocks`, `transpose_blocks_on`), launched through
    `blocked_spmm_t`;
  * max: `rer_spmm_bwd.blocked_spmm_max_bwd` (`csrc/rer_spmm_bwd.cu`),
    the reference's two-level tie split (within a tile, then across the
    tiles of an interval).

Source note.  Replaces `repro/kernels/rer_spmm/rer_spmm.py::rer_spmm`
(`_spmm_kernel_sum`, `_spmm_kernel_max`).  On the H100 it is bound by
bytes: the tiles are mostly structural zeros, so 4 T^2 bytes per tile
buy 2 * nnz * F useful operations.  The kernel streams each tile once
per 16-wide feature chunk, with the chunks of one interval side by side
in the grid so they share the tile through L2; one CTA per
(interval, row slab, chunk) walks its interval's tile span and owns its
output, so there are no atomics.  See the kernel source for the rest.
"""
from __future__ import annotations

import ctypes
from typing import Callable, NamedTuple, Optional

import numpy as np
import torch
from torch.autograd.function import once_differentiable

from repro_torch.graphs.partition import transpose_block_index
from repro_torch.kernels import _build
from repro_torch.kernels._common import (check_range, check_status,
                                         check_tensor, stream_handle,
                                         tile_ptr)

# kernel launches, counted where the kernel is launched: "sum"/"max" for
# the forward, "sum_t" for the sum backward over the transposed carrier
LAUNCHES = {"sum": 0, "max": 0, "sum_t": 0}

# tiles per gathered slab when the transposed carrier is built
_TRANSPOSE_SLAB = 256

# elements of one (tiles, T, T, F) candidate slab in the plain max
_PLAIN_MAX_SLAB = 1 << 26


def prepare_blocks(blocks: np.ndarray, block_row: np.ndarray,
                   block_col: np.ndarray, q: int):
    """Sort tiles by dst interval and pad so every interval appears
    (pad tiles appended before one stable argsort, as the reference)."""
    present = np.zeros(q, bool)
    present[block_row] = True
    missing = np.nonzero(~present)[0].astype(np.int32)
    if missing.size:
        t = blocks.shape[1]
        blocks = np.concatenate(
            [blocks, np.zeros((missing.size, t, t), blocks.dtype)])
        block_row = np.concatenate([block_row, missing])
        block_col = np.concatenate([block_col, missing])
    order = np.argsort(block_row, kind="stable")
    return (blocks[order], block_row[order].astype(np.int32),
            block_col[order].astype(np.int32))


def blocked_spmm_plain(blocks: torch.Tensor, block_row: torch.Tensor,
                       block_col: torch.Tensor, x: torch.Tensor, *, q: int,
                       op: str = "sum") -> torch.Tensor:
    """The tiled dataflow in plain PyTorch, on any device."""
    nnzb, t, _ = blocks.shape
    f = x.shape[1]
    src = x.reshape(q, t, f)[block_col.long()]          # (nnzb, T, F)
    seg = block_row.long()
    if op == "sum":
        contrib = torch.bmm(blocks, src)
        y = torch.zeros(q, t, f, dtype=torch.float32, device=x.device)
        y.index_add_(0, seg, contrib)
        return y.reshape(q * t, f)
    if op != "max":
        raise ValueError(op)
    contrib = torch.empty(nnzb, t, f, dtype=torch.float32, device=x.device)
    step = max(1, _PLAIN_MAX_SLAB // max(1, t * t * f))
    for k0 in range(0, nnzb, step):
        b = blocks[k0:k0 + step, :, :, None]
        cand = torch.where(b != 0.0, b * src[k0:k0 + step, None, :, :],
                           -torch.inf)
        contrib[k0:k0 + step] = cand.amax(dim=2)
    y = torch.full((q, t, f), -torch.inf, dtype=torch.float32,
                   device=x.device)
    y.scatter_reduce_(0, seg[:, None, None].expand(nnzb, t, f), contrib,
                      "amax", include_self=False)
    y = torch.where(torch.isneginf(y), 0.0, y)
    return y.reshape(q * t, f)


_LIB = None


def _lib():
    global _LIB
    if _LIB is None:
        lib = _build.load("rer_spmm")
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.rer_spmm_launch.argtypes = [p, p, p, p, p, i, i, i, i, p]
        lib.rer_spmm_launch.restype = i
        _LIB = lib
    return _LIB


class TransposedBlocks(NamedTuple):
    """The dense blocked carrier of A^T on the device: tiles A_k^T
    sorted by destination (the forward's source interval), every
    interval present; `tile_of[k]` is the forward tile of transposed
    tile k, -1 for a pad (see `graphs.partition.transpose_block_index`)."""
    blocks: torch.Tensor
    block_row: torch.Tensor
    block_col: torch.Tensor
    tile_of: torch.Tensor

    def nbytes(self) -> int:
        return sum(t.numel() * t.element_size() for t in self)


def transpose_blocks_on(blocks: torch.Tensor, block_row: torch.Tensor,
                        block_col: torch.Tensor, q: int) -> TransposedBlocks:
    """Build the transposed carrier on the forward carrier's device:
    the tile order comes from the host (two small index arrays read
    back once), the tiles are gathered and transposed on the device."""
    dev = blocks.device
    tile_of, brow, bcol = transpose_block_index(
        block_row.cpu().numpy(), block_col.cpu().numpy(), q)
    t = blocks.shape[1]
    out = torch.zeros((tile_of.size, t, t), dtype=blocks.dtype, device=dev)
    real = np.nonzero(tile_of >= 0)[0]
    for c0 in range(0, real.size, _TRANSPOSE_SLAB):
        dst = torch.from_numpy(real[c0:c0 + _TRANSPOSE_SLAB]).to(dev)
        src = torch.from_numpy(tile_of[real[c0:c0 + _TRANSPOSE_SLAB]]).to(dev)
        out[dst] = blocks[src].transpose(1, 2)
    return TransposedBlocks(out, torch.from_numpy(brow).to(dev),
                            torch.from_numpy(bcol).to(dev),
                            torch.from_numpy(tile_of.astype(np.int32)).to(dev))


def _launch(blocks: torch.Tensor, block_row: torch.Tensor,
            block_col: torch.Tensor, x: torch.Tensor, q: int,
            op: str) -> torch.Tensor:
    """Check the arguments and launch the kernel (counted by the caller)."""
    dev = x.device
    check_tensor(blocks, "blocks", torch.float32, dev, 3)
    check_tensor(block_row, "block_row", torch.int32, dev, 1)
    check_tensor(block_col, "block_col", torch.int32, dev, 1)
    check_tensor(x, "x", torch.float32, dev, 2)
    nnzb, t, t2 = blocks.shape
    if t != t2 or block_row.numel() != nnzb or block_col.numel() != nnzb:
        raise ValueError(f"tiles {tuple(blocks.shape)} do not match "
                         f"block_row {tuple(block_row.shape)} / block_col "
                         f"{tuple(block_col.shape)}")
    if x.shape[0] != q * t:
        raise ValueError(f"x has {x.shape[0]} rows, expected q*T = {q * t}")
    f = x.shape[1]
    ptr = tile_ptr(block_row, q)
    check_range(block_col, q, "block_col")
    y = torch.empty((q * t, f), dtype=torch.float32, device=dev)
    status = _lib().rer_spmm_launch(
        blocks.data_ptr(), block_col.data_ptr(), ptr.data_ptr(),
        x.data_ptr(), y.data_ptr(), q, t, f, int(op == "max"),
        stream_handle(dev))
    check_status(status, "rer_spmm")
    return y


def _forward(blocks, block_row, block_col, x, q, op, key) -> torch.Tensor:
    if x.device.type == "cpu":
        return blocked_spmm_plain(blocks, block_row, block_col, x, q=q,
                                  op=op)
    if x.device.type != "cuda":
        raise ValueError(f"no rer_spmm for device {x.device}")
    y = _launch(blocks, block_row, block_col, x, q, op)
    LAUNCHES[key] += 1
    return y


def blocked_spmm_t(bt: TransposedBlocks, g: torch.Tensor, *,
                   q: int) -> torch.Tensor:
    """A^T G over the transposed carrier: the sum backward of
    `blocked_spmm` (and the A^T half of the fused backward).  CPU
    tensors take the plain version; CUDA tensors the forward kernel."""
    return _forward(bt.blocks, bt.block_row, bt.block_col, g, q, "sum",
                    "sum_t")


class _BlockedSpmm(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, blocks, block_row, block_col, q, op, transposed):
        y = _forward(blocks, block_row, block_col, x, q, op, op)
        ctx.q, ctx.op, ctx.transposed = q, op, transposed
        ctx.carrier = (blocks, block_row, block_col)
        if op == "max":
            ctx.save_for_backward(x, y)
        return y

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        g = g.contiguous()
        bt = ctx.transposed()
        if ctx.op == "sum":
            dx = blocked_spmm_t(bt, g, q=ctx.q)
        else:
            from repro_torch.kernels.rer_spmm_bwd import blocked_spmm_max_bwd
            x, y = ctx.saved_tensors
            dx = blocked_spmm_max_bwd(*ctx.carrier, bt, x, y, g, q=ctx.q)
        return dx, None, None, None, None, None, None


def blocked_spmm(blocks: torch.Tensor, block_row: torch.Tensor,
                 block_col: torch.Tensor, x: torch.Tensor, *, q: int,
                 op: str = "sum",
                 transposed: Optional[Callable[[], TransposedBlocks]]
                 ) -> torch.Tensor:
    """Y (q*T, F) = A X over dense tiles sorted by destination interval
    (`block_row` non-decreasing; an interval without tiles comes out 0).
    CPU tensors take the plain version; CUDA tensors the kernel.  When
    autograd needs dX, the backward runs over the transposed carrier
    that `transposed()` returns (a plan builds it once and caches it);
    None is for calls that autograd does not differentiate."""
    if op not in ("sum", "max"):
        raise ValueError(op)
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no rer_spmm for device {x.device}")
    if blocks.requires_grad:
        raise NotImplementedError("rer_spmm differentiates x only; the "
                                  "tiles are the graph, a constant")
    if not (torch.is_grad_enabled() and x.requires_grad):
        return _forward(blocks, block_row, block_col, x, q, op, op)
    if transposed is None:
        raise ValueError("blocked_spmm under autograd needs the transposed "
                         "carrier: pass transposed=")
    return _BlockedSpmm.apply(x, blocks, block_row, block_col, q, op,
                              transposed)
