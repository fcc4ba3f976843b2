"""R-GCN's typed projection over the (src, relation) pairs that send.

Host side: `pair_table` reduces a typed plan's flat entries to their
distinct (src, relation) pairs, sorted by relation and then by source
(`pair_src`, the relation offsets `pair_ptr`, and `gpair`, each entry's
pair); `pair_blocks` cuts each relation's run of pairs into blocks of at
most a given length, the kernels' work tables.
`TypedPairs` holds all of them on the plan's device.

Device side: `typed_pair_project(x, wr, pairs)` is Y (P, H) with
Y[p] = x[pair_src[p]] @ wr[rel(p)], an autograd Function whose forward
and both gradients (dW_r = x[pair_src_r]^T dY_r; dX += dY_r W_r^T at
pair_src, only where x needs one) are the hand-written CUDA kernels of
`csrc/typed_pairs.cu` for CUDA tensors and the plain versions
(`typed_pair_project_plain`, `typed_pair_grad_w_plain`,
`typed_pair_grad_x_plain`: per relation `index_select` + `mm`) for CPU
tensors.  It saves x and the pair table, never the (P, F) gathered rows.

Source note.  Replaces no TPU kernel: the reference projects every vertex
under every relation with one XLA einsum, (N, F) x (R, F, H) ->
(N, R*H), and its typed flat entries read one H-wide slice each.  Where
few (src, relation) pairs send (AM: 1.8% of N R) that product is mostly
surplus, so the port projects each pair that sends once.  On the H100
it is bound by bytes: one X row a pair (AM layer 1: 8.6 GB, 2.6 ms at
3.35 TB/s, against 43 GFLOP, 0.64 ms at 67 TFLOP/s).  Each CTA works
inside one relation and keeps W_r on chip; the X rows are gathered
with coalesced 128-byte runs, two stages in flight.  See the kernel
source for the rest.
"""
from __future__ import annotations

import ctypes
from typing import Tuple

import numpy as np
import torch
from torch.autograd.function import once_differentiable

from repro_torch.kernels import _build
from repro_torch.kernels._common import (check_status, check_tensor,
                                         stream_handle)

PROJECT_ROWS = 128      # pairs of a projection / dX block (`kRows`)
GRAD_W_ROWS = 2048      # pairs of a dW block: one atomic partial each

# kernel launches by pass, counted where the kernel is launched
LAUNCHES = {"project": 0, "grad_w": 0, "grad_x": 0}


def pair_table(gsrc: np.ndarray, grel: np.ndarray, n: int, r: int
               ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(pair_src int32 (P,), pair_ptr int64 (R+1,), gpair int32 (E,)) of
    the flat entries' sources and relations: the distinct (src, rel)
    pairs sorted by relation and then by source, relation r's pairs at
    [pair_ptr[r], pair_ptr[r+1]), and entry e's pair at gpair[e]."""
    key = torch.from_numpy(grel.astype(np.int64) * n + gsrc)
    # torch's sort-based unique: the result of np.unique, a few times faster
    uniq, gpair = torch.unique(key, sorted=True, return_inverse=True)
    uniq = uniq.numpy()
    pair_src = (uniq % n).astype(np.int32)
    pair_ptr = np.searchsorted(uniq, np.arange(r + 1, dtype=np.int64) * n)
    return pair_src, pair_ptr, gpair.numpy().astype(np.int32)


def pair_blocks(pair_ptr: np.ndarray, rows: int) -> np.ndarray:
    """(B, 3) int32 rows (rel, start, end): each relation's run of pairs
    cut into blocks of at most `rows`; a relation with no pair has none."""
    ptr = np.asarray(pair_ptr, dtype=np.int64)
    nb = -(-np.diff(ptr) // rows)
    rel = np.repeat(np.arange(nb.size, dtype=np.int64), nb)
    first = np.repeat(np.cumsum(nb) - nb, nb)
    start = ptr[rel] + (np.arange(rel.size) - first) * rows
    end = np.minimum(start + rows, ptr[rel + 1])
    return np.stack([rel, start, end], axis=1).astype(np.int32)


class TypedPairs:
    """A typed plan's pair table: on its device `pair_src`, `gpair` and
    the kernels' work tables `blocks` (<= PROJECT_ROWS pairs a block: the
    projection and dX) and `wblocks` (<= GRAD_W_ROWS: dW), built on the
    host; on the host the relation offsets `pair_ptr`, which the work
    tables and the plain versions' per-relation loop read."""

    def __init__(self, pair_src: np.ndarray, pair_ptr: np.ndarray,
                 gpair: np.ndarray, dev: torch.device):
        def up(a):
            return torch.from_numpy(np.ascontiguousarray(a)).to(dev)
        self.num_pairs = int(pair_src.size)
        self.num_relations = int(pair_ptr.size - 1)
        self.pair_ptr = np.asarray(pair_ptr, dtype=np.int64)
        self.pair_src = up(pair_src.astype(np.int32))
        self.gpair = up(gpair.astype(np.int32))
        self.blocks = up(pair_blocks(self.pair_ptr, PROJECT_ROWS))
        self.wblocks = up(pair_blocks(self.pair_ptr, GRAD_W_ROWS))

    def runs(self):
        """(relation, start, end) of every relation that has pairs."""
        ptr = self.pair_ptr
        for rr in range(self.num_relations):
            if ptr[rr + 1] > ptr[rr]:
                yield rr, int(ptr[rr]), int(ptr[rr + 1])


# -- plain versions (CPU tensors) --------------------------------------------

def typed_pair_project_plain(x: torch.Tensor, wr: torch.Tensor,
                             pairs: TypedPairs) -> torch.Tensor:
    """Y (P, H): each relation's pairs' rows of x times its W_r."""
    y = torch.zeros((pairs.num_pairs, wr.shape[2]), dtype=x.dtype,
                    device=x.device)
    for rr, a, b in pairs.runs():
        y[a:b] = x.index_select(0, pairs.pair_src[a:b]) @ wr[rr]
    return y


def typed_pair_grad_w_plain(x: torch.Tensor, dy: torch.Tensor,
                            pairs: TypedPairs, shape) -> torch.Tensor:
    """dW (R, F, H): x[pair_src_r]^T dY_r for each relation."""
    dw = torch.zeros(shape, dtype=dy.dtype, device=dy.device)
    for rr, a, b in pairs.runs():
        dw[rr] = x.index_select(0, pairs.pair_src[a:b]).T @ dy[a:b]
    return dw


def typed_pair_grad_x_plain(dy: torch.Tensor, wr: torch.Tensor,
                            pairs: TypedPairs, shape) -> torch.Tensor:
    """dX (N, F): dY_r W_r^T added at each relation's sources."""
    dx = torch.zeros(shape, dtype=dy.dtype, device=dy.device)
    for rr, a, b in pairs.runs():
        dx.index_add_(0, pairs.pair_src[a:b], dy[a:b] @ wr[rr].T)
    return dx


# -- the kernels (CUDA tensors) ------------------------------------------------

_LIB = None


def _lib():
    global _LIB
    if _LIB is None:
        lib = _build.load("typed_pairs")
        p, i = ctypes.c_void_p, ctypes.c_int
        for name in ("typed_pairs_project_launch",
                     "typed_pairs_grad_w_launch",
                     "typed_pairs_grad_x_launch"):
            fn = getattr(lib, name)
            fn.argtypes = [p, p, p, p, i, p, i, i, p]
            fn.restype = i
        _LIB = lib
    return _LIB


def _check(x: torch.Tensor, wr: torch.Tensor, pairs: TypedPairs) -> None:
    dev = x.device
    check_tensor(x, "x", torch.float32, dev, 2)
    check_tensor(wr, "wr", torch.float32, dev, 3)
    if pairs.pair_src.device != dev:
        raise ValueError(f"the pair table is on {pairs.pair_src.device}, "
                         f"x on {dev}")
    if wr.shape[0] != pairs.num_relations or wr.shape[1] != x.shape[1]:
        raise ValueError(f"wr {tuple(wr.shape)} does not take x "
                         f"{tuple(x.shape)} over {pairs.num_relations} "
                         f"relations")


def _project(x, wr, pairs):
    f, h = wr.shape[1], wr.shape[2]
    y = torch.empty((pairs.num_pairs, h), dtype=torch.float32,
                    device=x.device)
    status = _lib().typed_pairs_project_launch(
        x.data_ptr(), wr.data_ptr(), pairs.pair_src.data_ptr(),
        pairs.blocks.data_ptr(), pairs.blocks.shape[0], y.data_ptr(), f, h,
        stream_handle(x.device))
    check_status(status, "typed_pairs project")
    LAUNCHES["project"] += 1
    return y


def _grad_w(x, dy, pairs, shape):
    dw = torch.zeros(shape, dtype=torch.float32, device=dy.device)
    status = _lib().typed_pairs_grad_w_launch(
        x.data_ptr(), dy.data_ptr(), pairs.pair_src.data_ptr(),
        pairs.wblocks.data_ptr(), pairs.wblocks.shape[0], dw.data_ptr(),
        shape[1], shape[2], stream_handle(dy.device))
    check_status(status, "typed_pairs grad_w")
    LAUNCHES["grad_w"] += 1
    return dw


def _grad_x(dy, wr, pairs, shape):
    dx = torch.zeros(shape, dtype=torch.float32, device=dy.device)
    status = _lib().typed_pairs_grad_x_launch(
        dy.data_ptr(), wr.data_ptr(), pairs.pair_src.data_ptr(),
        pairs.blocks.data_ptr(), pairs.blocks.shape[0], dx.data_ptr(),
        shape[1], wr.shape[2], stream_handle(dy.device))
    check_status(status, "typed_pairs grad_x")
    LAUNCHES["grad_x"] += 1
    return dx


class _PairProject(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, wr, pairs):
        ctx.pairs = pairs
        ctx.save_for_backward(x, wr)
        if x.device.type == "cpu":
            return typed_pair_project_plain(x, wr, pairs)
        return _project(x, wr, pairs)

    @staticmethod
    @once_differentiable
    def backward(ctx, dy):
        x, wr = ctx.saved_tensors
        pairs = ctx.pairs
        dy = dy.contiguous()
        cpu = dy.device.type == "cpu"
        dx = dw = None
        if ctx.needs_input_grad[0]:
            dx = (typed_pair_grad_x_plain if cpu else _grad_x)(
                dy, wr, pairs, x.shape)
        if ctx.needs_input_grad[1]:
            dw = (typed_pair_grad_w_plain if cpu else _grad_w)(
                x, dy, pairs, wr.shape)
        return dx, dw, None


def typed_pair_project(x: torch.Tensor, wr: torch.Tensor,
                       pairs: TypedPairs) -> torch.Tensor:
    """Y (P, H) = x[pair_src[p]] @ wr[rel(p)] for every pair p of
    `pairs`, float32, differentiable in x and wr.  CPU tensors take the
    plain versions, CUDA tensors the kernels; any other device raises."""
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no typed_pairs for device {x.device}")
    x, wr = x.contiguous(), wr.contiguous()
    _check(x, wr, pairs)
    return _PairProject.apply(x, wr, pairs)
