"""RER-SpMM: the aggregate over dense T x T tiles, forward and backward.

`blocked_spmm` launches the hand-written CUDA kernel `csrc/rer_spmm.cu`
for CUDA tensors and runs `blocked_spmm_plain`, the same tiled dataflow
in plain PyTorch (tile gather + batched tile product + reduce at the
destination intervals), for CPU tensors.  Under autograd it is a
`torch.autograd.Function`:

  * sum: dX = A^T G by `blocked_spmm_t`, the kernel's transposed
    launcher (`rer_spmm_t_launch`) over the forward tiles;
  * max: `rer_spmm_bwd.blocked_spmm_max_bwd` (`csrc/rer_spmm_bwd.cu`),
    the reference's two-level tie split (within a tile, then across the
    tiles of an interval), over the forward tiles.
Neither builds a carrier of A^T (nor does the reference: XLA
differentiates its tiles).

Source note.  Replaces `repro/kernels/rer_spmm/rer_spmm.py::rer_spmm`
(`_spmm_kernel_sum`, `_spmm_kernel_max`).  On the H100 it is bound by
bytes: the tiles are mostly structural zeros, so 4 T^2 bytes per tile
buy 2 * nnz * F useful operations.  The kernel streams each tile from
HBM once per call (F up to 1024) through two cp.async stages, compacts each
slab's nonzeros on chip and gathers only the X rows they name; one CTA
per (span piece, row slab) with each interval's span cut into balanced
pieces of at most `PIECE_TILES` tiles (`span_pieces`, built on the host
once per carrier), merged in Y by atomics where an interval is split.
The transposed launcher keeps that tile stream and scatters a * G[r] of
each nonzero into dX[u] with atomics.  See the kernel source for the
rest.
"""
from __future__ import annotations

import ctypes
import numpy as np
import torch
from torch.autograd.function import once_differentiable

from repro_torch.kernels import _build
from repro_torch.kernels._common import (_memo, check_range, check_status,
                                         check_tensor, stream_handle,
                                         tile_ptr)

# kernel launches, counted where the kernel is launched: "sum"/"max" for
# the forward, "sum_t" for the sum backward dX = A^T G
LAUNCHES = {"sum": 0, "max": 0, "sum_t": 0}

# elements of one (tiles, T, T, F) candidate slab in the plain max, and
# of one (tiles, T, F) product slab in the plain A^T G
_PLAIN_MAX_SLAB = 1 << 26
_PLAIN_T_SLAB = 1 << 24

# most tiles one CTA of the kernel walks: longer spans are cut into
# balanced pieces merged by atomics
PIECE_TILES = 16


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


def blocked_spmm_t_plain(blocks: torch.Tensor, block_row: torch.Tensor,
                         block_col: torch.Tensor, g: torch.Tensor, *,
                         q: int) -> torch.Tensor:
    """dX (q*T, F) = A^T G over the forward tiles in plain PyTorch, on
    any device: per tile A_k^T @ G[br_k], added at bc_k, over slabs of
    tiles (never a (nnzb, T, F) stack of the whole carrier)."""
    nnzb, t, _ = blocks.shape
    f = g.shape[1]
    gi = g.reshape(q, t, f)
    dx = torch.zeros(q, t, f, dtype=torch.float32, device=g.device)
    step = max(1, _PLAIN_T_SLAB // max(1, t * f))
    for k0 in range(0, nnzb, step):
        part = torch.bmm(blocks[k0:k0 + step].transpose(1, 2),
                         gi[block_row[k0:k0 + step].long()])
        dx.index_add_(0, block_col[k0:k0 + step].long(), part)
    return dx.reshape(q * t, f)


def span_pieces(ptr: np.ndarray, piece_tiles: int = PIECE_TILES):
    """Cut each destination interval's tile span `[ptr[i], ptr[i+1])`
    into ceil(span / piece_tiles) pieces of balanced length: an
    (n_pieces, 4) int32 table of (interval, first tile, end tile, split)
    rows, `split` set where the interval has more than one piece.  The
    second value says whether Y must be filled first: some interval is
    split (its pieces merge by atomics) or has no tile (no CTA writes
    its rows)."""
    ptr = np.asarray(ptr, np.int64)
    span = np.diff(ptr)
    n = -(-span // piece_tiles)
    owner = np.repeat(np.arange(span.size), n)
    j = np.arange(owner.size) - np.repeat(np.cumsum(n) - n, n)
    lo = ptr[owner] + span[owner] * j // n[owner]
    hi = ptr[owner] + span[owner] * (j + 1) // n[owner]
    table = np.stack([owner, lo, hi, n[owner] > 1], axis=1)
    return table.astype(np.int32), bool((n != 1).any())


def _pieces(block_row: torch.Tensor, q: int):
    """The device table of `span_pieces` for a carrier, built once: the
    span pointers are read back to the host on the first launch."""
    m = _memo(block_row)
    hit = m.get(("pieces", q))
    if hit is None:
        table, fill = span_pieces(tile_ptr(block_row, q).cpu().numpy())
        hit = (torch.from_numpy(table).to(block_row.device), fill)
        m[("pieces", q)] = hit
    return hit


_LIB = None


def _lib():
    global _LIB
    if _LIB is None:
        lib = _build.load("rer_spmm")
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.rer_spmm_launch.argtypes = [p, p, p, i, i, p, p, i, i, i, i, i,
                                        p]
        lib.rer_spmm_launch.restype = i
        lib.rer_spmm_t_launch.argtypes = [p, p, p, i, p, p, i, i, i, i, p]
        lib.rer_spmm_t_launch.restype = i
        _LIB = lib
    return _LIB


def _launch(blocks: torch.Tensor, block_row: torch.Tensor,
            block_col: torch.Tensor, x: torch.Tensor, q: int,
            op: str) -> torch.Tensor:
    """Check the arguments and launch the kernel (counted by the
    caller): the forward for "sum" / "max", dX = A^T x for "t"."""
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
    pieces, fill = _pieces(block_row, q)
    check_range(block_col, q, "block_col")
    vec = t % 4 == 0 and blocks.data_ptr() % 16 == 0
    y = torch.empty((q * t, f), dtype=torch.float32, device=dev)
    if op == "t":
        status = _lib().rer_spmm_t_launch(
            blocks.data_ptr(), block_col.data_ptr(), pieces.data_ptr(),
            pieces.shape[0], x.data_ptr(), y.data_ptr(), q, t, f, int(vec),
            stream_handle(dev))
        check_status(status, "rer_spmm (A^T G)")
        return y
    status = _lib().rer_spmm_launch(
        blocks.data_ptr(), block_col.data_ptr(), pieces.data_ptr(),
        pieces.shape[0], int(fill), x.data_ptr(), y.data_ptr(), q, t, f,
        int(op == "max"), int(vec), stream_handle(dev))
    check_status(status, "rer_spmm")
    return y


def _forward(blocks, block_row, block_col, x, q, op) -> torch.Tensor:
    if x.device.type == "cpu":
        return blocked_spmm_plain(blocks, block_row, block_col, x, q=q,
                                  op=op)
    if x.device.type != "cuda":
        raise ValueError(f"no rer_spmm for device {x.device}")
    y = _launch(blocks, block_row, block_col, x, q, op)
    LAUNCHES[op] += 1
    return y


def blocked_spmm_t(blocks: torch.Tensor, block_row: torch.Tensor,
                   block_col: torch.Tensor, g: torch.Tensor, *,
                   q: int) -> torch.Tensor:
    """dX (q*T, F) = A^T G over the forward carrier (the tiles of A,
    sorted by destination interval): the sum backward of `blocked_spmm`
    and the dP of the fused backward.  CPU tensors take the plain
    version; CUDA tensors the kernel's transposed launcher.  No carrier
    of A^T is built."""
    if g.device.type == "cpu":
        return blocked_spmm_t_plain(blocks, block_row, block_col, g, q=q)
    if g.device.type != "cuda":
        raise ValueError(f"no rer_spmm for device {g.device}")
    dx = _launch(blocks, block_row, block_col, g, q, "t")
    LAUNCHES["sum_t"] += 1
    return dx


class _BlockedSpmm(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, blocks, block_row, block_col, q, op, counts):
        y = _forward(blocks, block_row, block_col, x, q, op)
        ctx.q, ctx.op = q, op
        ctx.carrier, ctx.counts = (blocks, block_row, block_col), counts
        if op == "max":
            ctx.save_for_backward(x, y)
        return y

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        g = g.contiguous()
        if ctx.op == "sum":
            dx = blocked_spmm_t(*ctx.carrier, g, q=ctx.q)
        else:
            from repro_torch.kernels.rer_spmm_bwd import blocked_spmm_max_bwd
            x, y = ctx.saved_tensors
            dx = blocked_spmm_max_bwd(*ctx.carrier, x, y, g, q=ctx.q,
                                      counts=ctx.counts)
        return dx, None, None, None, None, None, None


def blocked_spmm(blocks: torch.Tensor, block_row: torch.Tensor,
                 block_col: torch.Tensor, x: torch.Tensor, *, q: int,
                 op: str = "sum", counts=None) -> torch.Tensor:
    """Y (q*T, F) = A X over dense tiles sorted by destination interval
    (`block_row` non-decreasing; an interval without tiles comes out 0).
    CPU tensors take the plain version; CUDA tensors the kernel.  Under
    autograd both backwards walk the same tiles: the sum's dX = A^T G by
    `blocked_spmm_t`, the max's by `rer_spmm_bwd` (with the carrier's
    `RowCounts` `counts` where the plan has them)."""
    if op not in ("sum", "max"):
        raise ValueError(op)
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no rer_spmm for device {x.device}")
    if blocks.requires_grad:
        raise NotImplementedError("rer_spmm differentiates x only; the "
                                  "tiles are the graph, a constant")
    if not (torch.is_grad_enabled() and x.requires_grad):
        return _forward(blocks, block_row, block_col, x, q, op)
    return _BlockedSpmm.apply(x, blocks, block_row, block_col, q, op,
                              counts)
