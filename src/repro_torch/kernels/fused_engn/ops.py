"""Fused feature extraction + RER aggregate (paper Fig. 8).

`fused_engn_layer` computes Y = A (X W) over dst-sorted dense tiles: the
hand-written CUDA kernel `csrc/fused_engn.cu` for CUDA tensors,
`fused_engn_plain` (per-tile X W, batched tile product, reduce at the
destination intervals) for CPU tensors.  Under autograd it is a
`torch.autograd.Function` whose backward is `fused_engn_bwd`:
dP = A^T G by the `rer_spmm` kernel over the transposed dense carrier,
then dX = dP W^T and dW = X^T dP, two plain matrix products outside any
kernel, as the reference leaves them to XLA.

Source note.  Replaces `repro/kernels/fused_engn/fused_engn.py::
fused_extract_aggregate` (`_fused_kernel`).  On the H100 it is bound by
operations at the slice's widths: P = X[bc] W costs 2 T F H per tile and,
as in the reference, is recomputed for every tile (nnzb times, not q)
so that P never leaves shared memory.  One CTA per (interval, 16-wide
output chunk) computes P with a K-loop over F, then streams the tile in
256 x 16 slabs against it; narrow chunks keep q * ceil(H/16) CTAs busy
without recomputing any product across CTAs.  T is at most 256.
"""
from __future__ import annotations

import ctypes
from typing import Callable, Optional, Tuple

import torch
from torch.autograd.function import once_differentiable

from repro_torch.kernels import _build
from repro_torch.kernels._common import (check_range, check_status,
                                         check_tensor, stream_handle,
                                         tile_ptr)
from repro_torch.kernels.rer_spmm import ops as spmm_ops

# kernel launches, counted where the kernel is launched (the backward's
# A^T G is a rer_spmm launch, counted there as "sum_t")
LAUNCHES = {"sum": 0}

MAX_TILE = 256      # rows a CTA of the kernel holds


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
        lib.fused_engn_launch.argtypes = [p, p, p, p, p, p, i, i, i, i, p]
        lib.fused_engn_launch.restype = i
        _LIB = lib
    return _LIB


def _forward(blocks, block_row, block_col, x, w, q) -> torch.Tensor:
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
    ptr = tile_ptr(block_row, q)
    check_range(block_col, q, "block_col")
    y = torch.empty((q * t, h), dtype=torch.float32, device=dev)
    status = _lib().fused_engn_launch(
        blocks.data_ptr(), block_col.data_ptr(), ptr.data_ptr(),
        x.data_ptr(), w.data_ptr(), y.data_ptr(), q, t, f, h,
        stream_handle(dev))
    check_status(status, "fused_engn")
    LAUNCHES["sum"] += 1
    return y


def fused_engn_bwd_plain(bt, x: torch.Tensor, w: torch.Tensor,
                         g: torch.Tensor, *, q: int
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(dX, dW) in plain PyTorch, on any device."""
    dp = spmm_ops.blocked_spmm_plain(bt.blocks, bt.block_row, bt.block_col,
                                     g, q=q)
    return dp @ w.t(), x.t() @ dp


def fused_engn_bwd(bt, x: torch.Tensor, w: torch.Tensor, g: torch.Tensor,
                   *, q: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The backward of Y = A (X W) for the cotangent G (q*T, H): dP =
    A^T G over the transposed dense carrier `bt`
    (`rer_spmm.TransposedBlocks`) by `blocked_spmm_t`, dX = dP W^T,
    dW = X^T dP.  CPU tensors take the plain version; CUDA tensors the
    `rer_spmm` kernel for dP."""
    dp = spmm_ops.blocked_spmm_t(bt, g, q=q)
    return dp @ w.t(), x.t() @ dp


class _Fused(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, blocks, block_row, block_col, q, transposed):
        ctx.save_for_backward(x, w)
        ctx.q, ctx.transposed = q, transposed
        return _forward(blocks, block_row, block_col, x, w, q)

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        dx, dw = fused_engn_bwd(ctx.transposed(), x, w, g.contiguous(),
                                q=ctx.q)
        return dx, dw, None, None, None, None, None


def fused_engn_layer(blocks: torch.Tensor, block_row: torch.Tensor,
                     block_col: torch.Tensor, x: torch.Tensor,
                     w: torch.Tensor, *, q: int,
                     transposed: Optional[Callable[[], object]]
                     ) -> torch.Tensor:
    """Y (q*T, H) = A (X W) over tiles sorted by destination interval.
    CPU tensors take the plain version; CUDA tensors the kernel.  When
    autograd needs dX or dW, the backward runs over the transposed
    carrier `transposed()` returns (a plan builds it once and caches it);
    None is for calls that autograd does not differentiate."""
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no fused_engn for device {x.device}")
    if blocks.requires_grad:
        raise NotImplementedError("fused_engn differentiates x and w only; "
                                  "the tiles are the graph, a constant")
    if not (torch.is_grad_enabled()
            and (x.requires_grad or w.requires_grad)):
        return _forward(blocks, block_row, block_col, x, w, q)
    if transposed is None:
        raise ValueError("fused_engn_layer under autograd needs the "
                         "transposed carrier: pass transposed=")
    return _Fused.apply(x, w, blocks, block_row, block_col, q, transposed)
