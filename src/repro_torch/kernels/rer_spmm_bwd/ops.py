"""The max backward of RER-SpMM over dense tiles.

`blocked_spmm_max_bwd` launches the hand-written CUDA kernels of
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
through XLA.  On the H100 it is bound by bytes: pass 1 walks the forward
tiles (counting winners per tile and tied tiles per row, then writing
the per-tile weight g / (c_k n) into a (nnzb, T, F) scratch), pass 2
walks the transposed tiles per source interval.  Every CTA owns its
output block: no atomics, and the winners are found by recomputing each
product bitwise as the forward kernel did.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels._common import (check_range, check_status,
                                         check_tensor, stream_handle,
                                         tile_ptr)

# kernel launches (one per backward: both passes), counted where launched
LAUNCHES = {"max": 0}

# elements of one (tiles, T, T, F) candidate slab in the plain version
_PLAIN_SLAB = 1 << 26


def _winners(blocks, src, yk):
    """(c, T, U, F) mask of the tied winners of c tiles: A != 0 and
    A * x == y, the product rounded as the forward rounds it."""
    b = blocks[:, :, :, None]
    return (b != 0.0) & (b * src[:, None, :, :] == yk[:, :, None, :])


def blocked_spmm_max_bwd_plain(blocks: torch.Tensor, block_row: torch.Tensor,
                               block_col: torch.Tensor, bt, x: torch.Tensor,
                               y: torch.Tensor, g: torch.Tensor, *,
                               q: int) -> torch.Tensor:
    """dX (q*T, F) in plain PyTorch, on any device.  `bt` (the
    transposed carrier) is not needed here: the plain version scatters
    into the source rows with `index_add_`."""
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


_LIB = None


def _lib():
    global _LIB
    if _LIB is None:
        lib = _build.load("rer_spmm_bwd")
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.rer_spmm_max_bwd_launch.argtypes = [p] * 12 + [i, i, i, p]
        lib.rer_spmm_max_bwd_launch.restype = i
        _LIB = lib
    return _LIB


def blocked_spmm_max_bwd(blocks: torch.Tensor, block_row: torch.Tensor,
                         block_col: torch.Tensor, bt, x: torch.Tensor,
                         y: torch.Tensor, g: torch.Tensor, *,
                         q: int) -> torch.Tensor:
    """dX of Y = max-aggregate(A, X) for the cotangent G: forward tiles
    (`blocks`, `block_row`, `block_col`), their transposed carrier `bt`
    (`rer_spmm.TransposedBlocks`), the forward's X and finished Y, all
    (q*T, F).  CPU tensors take the plain version; CUDA tensors the
    kernels."""
    if x.device.type == "cpu":
        return blocked_spmm_max_bwd_plain(blocks, block_row, block_col, bt,
                                          x, y, g, q=q)
    if x.device.type != "cuda":
        raise ValueError(f"no rer_spmm_bwd for device {x.device}")
    dev = x.device
    check_tensor(blocks, "blocks", torch.float32, dev, 3)
    check_tensor(block_row, "block_row", torch.int32, dev, 1)
    check_tensor(block_col, "block_col", torch.int32, dev, 1)
    check_tensor(bt.blocks, "transposed blocks", torch.float32, dev, 3)
    check_tensor(bt.block_row, "transposed block_row", torch.int32, dev, 1)
    check_tensor(bt.block_col, "transposed block_col", torch.int32, dev, 1)
    check_tensor(bt.tile_of, "tile_of", torch.int32, dev, 1)
    for name, tensor in (("x", x), ("y", y), ("g", g)):
        check_tensor(tensor, name, torch.float32, dev, 2)
    nnzb, t, t2 = blocks.shape
    kt = bt.blocks.shape[0]
    if (t != t2 or bt.blocks.shape[1:] != (t, t)
            or block_row.numel() != nnzb or block_col.numel() != nnzb
            or bt.block_row.numel() != kt or bt.block_col.numel() != kt
            or bt.tile_of.numel() != kt):
        raise ValueError(f"tiles {tuple(blocks.shape)} / transposed "
                         f"{tuple(bt.blocks.shape)} do not match their "
                         f"index arrays")
    if x.shape[0] != q * t or y.shape != x.shape or g.shape != x.shape:
        raise ValueError(f"x {tuple(x.shape)}, y {tuple(y.shape)} and g "
                         f"{tuple(g.shape)} must all be (q*T = {q * t}, F)")
    f = x.shape[1]
    ptr = tile_ptr(block_row, q)
    ptr_t = tile_ptr(bt.block_row, q)
    check_range(block_col, q, "block_col")
    check_range(bt.block_col, q, "transposed block_col")
    check_range(bt.tile_of, nnzb, "tile_of", lo=-1)
    w = torch.empty((nnzb, t, f), dtype=torch.float32, device=dev)
    dx = torch.empty((q * t, f), dtype=torch.float32, device=dev)
    status = _lib().rer_spmm_max_bwd_launch(
        blocks.data_ptr(), block_col.data_ptr(), ptr.data_ptr(),
        bt.blocks.data_ptr(), bt.tile_of.data_ptr(), bt.block_col.data_ptr(),
        ptr_t.data_ptr(), x.data_ptr(), y.data_ptr(), g.data_ptr(),
        w.data_ptr(), dx.data_ptr(), q, t, f, stream_handle(dev))
    check_status(status, "rer_spmm_bwd")
    LAUNCHES["max"] += 1
    return dx
