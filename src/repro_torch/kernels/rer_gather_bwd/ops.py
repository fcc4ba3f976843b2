"""The backward of RER-Gather over a plan's packed bucket groups.

Each pass is ONE launch per aggregate of the hand-written CUDA kernels
in `csrc/rer_gather_bwd.cu`, over the forward groups' own work table
(`rer_gather.PlanGroups.work`, the forward kernel's), for CUDA tensors;
plain versions for CPU tensors:

  * `packed_max_count`: per destination row and feature, the number of
    entries of every group that tie for the max, as int32;
  * `packed_max_scatter`: dX, v * g / count for every winning entry;
  * `packed_groups_t`: the sum's dX = A^T G, the same scatter with no
    counts (counted as rer_gather's "sum_t").

Together the max passes give the gradient of the reference's flat
`segment_max` (`packed_flat_xla`): the cotangent of a row splits evenly
over all its tied entries, whichever bucket group holds them.  No
carrier of A^T is built and no per-group partial is allocated.

Source note.  The backward of `repro/kernels/rer_gather/rer_gather.py::
rer_gather` (`_gather_kernel_sum`, `_gather_kernel_max`), which the
reference differentiates only through XLA.  On the H100 it is bound by
bytes: 12 B per real entry plus the referenced rows of x, y, g and the
count.  The kernels walk the forward's segments (one warp per <= 64
real entries, in destination order, no pad slot read); the count keeps
the running destination row's y and count in registers and adds into
the count with integer atomics (exact in any order), the scatter loads
each entry's g (and y and count) with its x row and adds into dX with
fire-and-forget float atomics (the order varies from run to run, so dX
agrees with the plain version to fp32 rounding).
"""
from __future__ import annotations

import ctypes
from typing import Dict, Optional, Sequence

import torch

from repro_torch.kernels import _build
from repro_torch.kernels._common import (check_status, check_tensor,
                                         stream_handle)
from repro_torch.kernels.rer_gather import ops as gather_ops

# kernel launches, counted where launched: "count" and "max" (the
# scatter), one each per max aggregate's backward; the sum's scatter is
# counted in rer_gather.LAUNCHES["sum_t"], beside the forward it
# differentiates
LAUNCHES = {"count": 0, "max": 0}

Groups = Sequence[Dict[str, torch.Tensor]]


def group_entries(gr: Dict[str, torch.Tensor], t: int):
    """A group's (K, S) slots as flat global (dst, src, val) vertex
    indices and weights, pads included (weight 0)."""
    dst = (gr["block_row"].long()[:, None] * t
           + gr["rows"].long()).reshape(-1)
    src = (gr["block_col"].long()[:, None] * t
           + gr["cols"].long()).reshape(-1)
    return dst, src, gr["vals"].reshape(-1)


def packed_groups_t_plain(groups: Groups, g: torch.Tensor, *,
                          q: int) -> torch.Tensor:
    """dX (q*T, F) = A^T G over a plan's forward groups in plain
    PyTorch, on any device: dx[src] += val * g[dst] per entry."""
    dx = torch.zeros_like(g)
    for gr in groups:
        dst, src, v = group_entries(gr, g.shape[0] // q)
        dx.index_add_(0, src, v[:, None] * g[dst])
    return dx


def _win(v, xs, yd):
    return (v != 0.0)[:, None] & (v[:, None] * xs == yd)


def packed_max_count_plain(groups: Groups, x: torch.Tensor,
                           y: torch.Tensor, *, q: int) -> torch.Tensor:
    """cnt (int32, the shape of x): per destination row d and feature f,
    the entries (d, s, v) of every group with v != 0 and
    v * x[s, f] == y[d, f]."""
    t = x.shape[0] // q
    cnt = torch.zeros(x.shape, dtype=torch.int32, device=x.device)
    for gr in groups:
        dst, src, v = group_entries(gr, t)
        cnt.index_add_(0, dst, _win(v, x[src], y[dst]).to(cnt.dtype))
    return cnt


def packed_max_scatter_plain(groups: Groups, x: torch.Tensor,
                             y: torch.Tensor, g: torch.Tensor,
                             cnt: torch.Tensor, *, q: int) -> torch.Tensor:
    """dX: dx[s] += v * (g[d] / cnt[d]) over the winning entries of
    every group."""
    t = x.shape[0] // q
    dx = torch.zeros_like(x)
    for gr in groups:
        dst, src, v = group_entries(gr, t)
        share = g[dst] / torch.clamp_min(cnt[dst], 1).float()
        dx.index_add_(0, src, torch.where(_win(v, x[src], y[dst]),
                                          v[:, None] * share,
                                          torch.zeros((), device=x.device)))
    return dx


_LIB = None


def _lib():
    global _LIB
    if _LIB is None:
        lib = _build.load("rer_gather_bwd")
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.rer_gather_max_count_launch.argtypes = (
            [p] * 4 + [i] + [p] * 3 + [i] * 3 + [p])
        lib.rer_gather_max_count_launch.restype = i
        lib.rer_gather_bwd_scatter_launch.argtypes = (
            [p] * 4 + [i] + [p] * 5 + [i] * 4 + [p])
        lib.rer_gather_bwd_scatter_launch.restype = i
        _LIB = lib
    return _LIB


def _table(groups: Groups, ref: torch.Tensor, q: int, tensors):
    """The groups' work table, held to the grid of `ref` (q*T, F), after
    the checks of the dense operands (name, tensor, dtype)."""
    dev = ref.device
    for name, tensor, dtype in tensors:
        check_tensor(tensor, name, dtype, dev, 2)
        if tensor.shape != ref.shape:
            raise ValueError(f"{name} {tuple(tensor.shape)} must match "
                             f"{tuple(ref.shape)}")
    if q <= 0 or ref.shape[0] % q:
        raise ValueError(f"{ref.shape[0]} rows are not q={q} intervals")
    if not groups:
        raise ValueError("a backward needs at least one bucket group")
    return gather_ops.groups_work(groups, q, ref.shape[0] // q, dev)


def scatter_launch(groups: Groups, g: torch.Tensor, q: int,
                   x: Optional[torch.Tensor] = None,
                   y: Optional[torch.Tensor] = None,
                   cnt: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Launch the scatter kernel once over the groups' work table
    (counted by the caller): dX of the sum when `cnt` is None, of the
    max (the winners of x and y, counted in `cnt`) otherwise."""
    op_max = cnt is not None
    dense = [("g", g, torch.float32)]
    if op_max:
        dense += [("x", x, torch.float32), ("y", y, torch.float32),
                  ("cnt", cnt, torch.int32)]
    w = _table(groups, g, q, dense)
    dx = torch.empty_like(g)
    status = _lib().rer_gather_bwd_scatter_launch(
        w.gtab.data_ptr(), w.pieces.data_ptr(), w.poff.data_ptr(),
        w.seg_ptr.data_ptr(), w.n_seg,
        x.data_ptr() if op_max else None, y.data_ptr() if op_max else None,
        g.data_ptr(), cnt.data_ptr() if op_max else None, dx.data_ptr(), q,
        g.shape[0] // q, g.shape[1], int(op_max), stream_handle(g.device))
    check_status(status, "rer_gather_bwd scatter")
    return dx


def packed_groups_t(groups: Groups, g: torch.Tensor, *,
                    q: int) -> torch.Tensor:
    """dX (q*T, F) = A^T G over a plan's forward groups: the sum
    backward of `rer_gather.packed_groups_spmm`.  CPU tensors take the
    plain version; CUDA tensors one launch of the scatter over the
    groups' work table (no carrier of A^T)."""
    if g.device.type == "cpu":
        return packed_groups_t_plain(groups, g, q=q)
    if g.device.type != "cuda":
        raise ValueError(f"no rer_gather_bwd for device {g.device}")
    dx = scatter_launch(groups, g, q)
    gather_ops.LAUNCHES["sum_t"] += 1
    return dx


def packed_max_count(groups: Groups, x: torch.Tensor, y: torch.Tensor, *,
                     q: int) -> torch.Tensor:
    """The tied winners (int32, the shape of x) of a max aggregate over
    a plan's groups: x is the forward's input and y its finished output,
    (q*T, F).  CPU tensors take the plain version; CUDA tensors one
    kernel launch."""
    if x.device.type == "cpu":
        return packed_max_count_plain(groups, x, y, q=q)
    if x.device.type != "cuda":
        raise ValueError(f"no rer_gather_bwd for device {x.device}")
    w = _table(groups, x, q, [("x", x, torch.float32),
                              ("y", y, torch.float32)])
    cnt = torch.empty(x.shape, dtype=torch.int32, device=x.device)
    status = _lib().rer_gather_max_count_launch(
        w.gtab.data_ptr(), w.pieces.data_ptr(), w.poff.data_ptr(),
        w.seg_ptr.data_ptr(), w.n_seg, x.data_ptr(), y.data_ptr(),
        cnt.data_ptr(), q, x.shape[0] // q, x.shape[1],
        stream_handle(x.device))
    check_status(status, "rer_gather_bwd count")
    LAUNCHES["count"] += 1
    return cnt


def packed_max_scatter(groups: Groups, x: torch.Tensor, y: torch.Tensor,
                       g: torch.Tensor, cnt: torch.Tensor, *,
                       q: int) -> torch.Tensor:
    """dX (q*T, F) of a max aggregate over a plan's groups for the
    cotangent g, with the winners counted in `cnt`.  CPU tensors take
    the plain version; CUDA tensors one kernel launch."""
    if x.device.type == "cpu":
        return packed_max_scatter_plain(groups, x, y, g, cnt, q=q)
    if x.device.type != "cuda":
        raise ValueError(f"no rer_gather_bwd for device {x.device}")
    dx = scatter_launch(groups, g, q, x, y, cnt)
    LAUNCHES["max"] += 1
    return dx
