"""The max backward of RER-Gather over packed bucket groups.

Two call forms, each one launch per bucket group, of the hand-written
CUDA kernels in `csrc/rer_gather_bwd.cu` for CUDA tensors, and their
plain versions for CPU tensors:

  * `packed_max_count` (over the forward groups) adds, per destination
    row and feature, the number of entries that tie for the max into an
    int32 count;
  * `packed_max_grad` (over the groups of the transposed store) returns
    one group's partial dX: v * g / count for every winning entry.

Together they give the gradient of the reference's flat `segment_max`
(`packed_flat_xla`): the cotangent of a row splits evenly over all its
tied entries, whichever bucket group holds them.

Source note.  The backward of `repro/kernels/rer_gather/rer_gather.py::
rer_gather` (`_gather_kernel_max`), which the reference differentiates
only through XLA.  On the H100 it is bound by bytes: 12 B per entry plus
the referenced rows of x, y, g and the count.  One CTA per (interval,
32-wide feature chunk) per group, as the forward; the count uses shared
integer atomics (exact), the gradient shared float atomics (fp32
rounding differs from the plain version's order).
"""
from __future__ import annotations

import ctypes
from typing import Dict

import torch

from repro_torch.kernels import _build
from repro_torch.kernels._common import (check_range, check_status,
                                         check_tensor, stream_handle,
                                         tile_ptr)

# kernel launches, counted where launched: "count" per forward group,
# "max" per transposed group
LAUNCHES = {"count": 0, "max": 0}

_KEYS = ("rows", "cols", "vals", "block_row", "block_col")


def _flat(gr: Dict[str, torch.Tensor], t: int):
    """A group's entries as global (dst, src, val) vertex indices."""
    dst = (gr["block_row"].long()[:, None] * t
           + gr["rows"].long()).reshape(-1)
    src = (gr["block_col"].long()[:, None] * t
           + gr["cols"].long()).reshape(-1)
    return dst, src, gr["vals"].reshape(-1)


def _win(v, xs, yd):
    return (v != 0.0)[:, None] & (v[:, None] * xs == yd)


def packed_max_count_plain(gr: Dict[str, torch.Tensor], x: torch.Tensor,
                           y: torch.Tensor, cnt: torch.Tensor, *,
                           q: int) -> torch.Tensor:
    """cnt[d, f] += #entries (d, s, v) of the group with v != 0 and
    v * x[s, f] == y[d, f]; returns cnt (updated in place)."""
    dst, src, v = _flat(gr, x.shape[0] // q)
    win = _win(v, x[src], y[dst])
    return cnt.index_add_(0, dst, win.to(cnt.dtype))


def packed_max_grad_plain(gr_t: Dict[str, torch.Tensor], x: torch.Tensor,
                          y: torch.Tensor, g: torch.Tensor,
                          cnt: torch.Tensor, *, q: int) -> torch.Tensor:
    """One transposed group's partial dX: dx[s] += v * g[d] / cnt[d]
    over its winning entries (rows are the source, cols the destination
    of the forward edge)."""
    src, dst, v = _flat(gr_t, x.shape[0] // q)
    win = _win(v, x[src], y[dst])
    share = g[dst] / torch.clamp_min(cnt[dst], 1).float()
    part = torch.where(win, v[:, None] * share,
                       torch.zeros((), device=x.device))
    return torch.zeros_like(x).index_add_(0, src, part)


_LIB = None


def _lib():
    global _LIB
    if _LIB is None:
        lib = _build.load("rer_gather_bwd")
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.rer_gather_max_count_launch.argtypes = [p] * 8 + [i] * 4 + [p]
        lib.rer_gather_max_count_launch.restype = i
        lib.rer_gather_max_grad_launch.argtypes = [p] * 10 + [i] * 4 + [p]
        lib.rer_gather_max_grad_launch.restype = i
        _LIB = lib
    return _LIB


def _check(gr, x, q, tensors):
    dev = x.device
    for key in _KEYS:
        ndim = 2 if key in ("rows", "cols", "vals") else 1
        dtype = torch.float32 if key == "vals" else torch.int32
        check_tensor(gr[key], key, dtype, dev, ndim)
    k, s = gr["rows"].shape
    if gr["cols"].shape != (k, s) or gr["vals"].shape != (k, s):
        raise ValueError("rows, cols and vals must share one (K, S) shape")
    if gr["block_row"].numel() != k or gr["block_col"].numel() != k:
        raise ValueError(f"{k} packed tiles but block_row/block_col hold "
                         f"{gr['block_row'].numel()}/"
                         f"{gr['block_col'].numel()}")
    if q <= 0 or x.shape[0] % q:
        raise ValueError(f"x rows {x.shape[0]} are not q={q} intervals")
    for name, tensor, dtype in tensors:
        check_tensor(tensor, name, dtype, dev, 2)
        if tensor.shape != x.shape:
            raise ValueError(f"{name} {tuple(tensor.shape)} must match x "
                             f"{tuple(x.shape)}")
    t = x.shape[0] // q
    ptr = tile_ptr(gr["block_row"], q)
    check_range(gr["block_col"], q, "block_col")
    check_range(gr["rows"], t, "rows")
    check_range(gr["cols"], t, "cols")
    return ptr, s, t, x.shape[1]


def packed_max_count(gr: Dict[str, torch.Tensor], x: torch.Tensor,
                     y: torch.Tensor, cnt: torch.Tensor, *,
                     q: int) -> torch.Tensor:
    """Add one forward group's tied winners into `cnt` (int32, the shape
    of x) in place and return it.  x is the forward's input and y its
    finished output, (q*T, F).  CPU tensors take the plain version;
    CUDA tensors the kernel."""
    if x.device.type == "cpu":
        return packed_max_count_plain(gr, x, y, cnt, q=q)
    if x.device.type != "cuda":
        raise ValueError(f"no rer_gather_bwd for device {x.device}")
    check_tensor(x, "x", torch.float32, x.device, 2)
    ptr, s, t, f = _check(gr, x, q, [("y", y, torch.float32),
                                     ("cnt", cnt, torch.int32)])
    status = _lib().rer_gather_max_count_launch(
        gr["rows"].data_ptr(), gr["cols"].data_ptr(), gr["vals"].data_ptr(),
        gr["block_col"].data_ptr(), ptr.data_ptr(), x.data_ptr(),
        y.data_ptr(), cnt.data_ptr(), q, s, t, f, stream_handle(x.device))
    check_status(status, "rer_gather_bwd count")
    LAUNCHES["count"] += 1
    return cnt


def packed_max_grad(gr_t: Dict[str, torch.Tensor], x: torch.Tensor,
                    y: torch.Tensor, g: torch.Tensor, cnt: torch.Tensor, *,
                    q: int) -> torch.Tensor:
    """One transposed group's partial dX (q*T, F) for the cotangent g,
    with the counts of every forward group in `cnt`.  CPU tensors take
    the plain version; CUDA tensors the kernel."""
    if x.device.type == "cpu":
        return packed_max_grad_plain(gr_t, x, y, g, cnt, q=q)
    if x.device.type != "cuda":
        raise ValueError(f"no rer_gather_bwd for device {x.device}")
    check_tensor(x, "x", torch.float32, x.device, 2)
    ptr, s, t, f = _check(gr_t, x, q, [("y", y, torch.float32),
                                       ("g", g, torch.float32),
                                       ("cnt", cnt, torch.int32)])
    dx = torch.empty_like(x)
    status = _lib().rer_gather_max_grad_launch(
        gr_t["rows"].data_ptr(), gr_t["cols"].data_ptr(),
        gr_t["vals"].data_ptr(), gr_t["block_col"].data_ptr(),
        ptr.data_ptr(), x.data_ptr(), y.data_ptr(), g.data_ptr(),
        cnt.data_ptr(), dx.data_ptr(), q, s, t, f, stream_handle(x.device))
    check_status(status, "rer_gather_bwd grad")
    LAUNCHES["max"] += 1
    return dx
