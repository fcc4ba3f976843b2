"""The backward of RER-Gather over a plan's packed bucket groups.

Each pass is ONE launch per aggregate of the hand-written CUDA kernels
in `csrc/rer_gather_bwd.cu` over the forward groups' own entries, for
CUDA tensors; plain versions for CPU tensors:

  * `packed_max_backward`: dX of a max aggregate, the path its autograd
    takes, in three passes:
      1. `packed_max_words`: a walk of every entry that keeps, per
         destination row and feature, one int32 winner word: 0 no
         winner, -(s+1) exactly one winner, of weight 1, from source s,
         c >= 1 c winners (tied) or one of another weight (the walk
         adds the counts and stores a lone winner's source in the dX
         buffer; a dense second launch encodes the words);
      2. `packed_max_resolve`, dense over the words with no walk: g[d]
         goes straight to dX[s] where the word names one winner s, and
         each row is flagged where a feature with g != 0 has a count;
      3. the tie walk: a scatter over the flagged rows only, and in them
         only the features whose word is a count, v * g / count for
         each winning entry;
    all three over the forward's work table (`PlanGroups.work`);
  * `packed_groups_t`: the sum's dX = A^T G (B2^T, counted as
    rer_gather's "sum_t"), source-stationary over a source-order table
    of the same groups' tiles (`PlanGroups.source`, built with a sum
    plan on the card; `rer_gather.source_table`): one CTA per piece of
    a source interval sorts its entries by source column on chip, sums
    each column in registers and writes each dX row once.

The three passes hold on any weights.  Where no entry has weight 1 no
word names a winner: every word is a count, the resolve pass flags every
row with a count and a nonzero g, and the walk splits those rows exactly
as a scatter over every row would (`packed_max_count_plain` and
`packed_max_scatter_plain`, the tests' oracle of the even split).
Together the passes give the gradient of the reference's flat
`segment_max` (`packed_flat_xla`): the cotangent of a row splits evenly
over all its tied entries, whichever bucket group holds them.  No
carrier of A^T is built and no per-group partial is allocated.

Why three passes: on a large sparse graph a destination row's run
inside a walk segment is about one entry, so a scatter over every entry
loads per entry the x, g, y and count rows only to find each (row,
feature)'s winner, almost always a lone one, which the count had
already compared.  The words keep that winner, so the resolve pass
reads each word and g once, and only rows with ties or weights other
than 1 are walked again; the walk still reads every entry of the table
(12 B, and the 4-byte flag of its row).  The words take the count's
buffer; the flags add one int32 a row.

Source note.  The backward of `repro/kernels/rer_gather/rer_gather.py::
rer_gather` (`_gather_kernel_sum`, `_gather_kernel_max`), which the
reference differentiates only through XLA.  On the H100 it is bound by
bytes: 12 B per real entry plus the referenced rows of x, y, g and the
words.  The max's kernels walk the forward's segments (one warp per <=
64 real entries, in destination order, no pad slot read); the count
keeps the running destination row's y, its winners and the last
winner's source in registers and adds the winners into the word with
integer atomics (exact in any order, for any count), the tie walk loads
each entry's g, y and word with its x row and adds into dX with
fire-and-forget float atomics.  The sum, B2^T, needs 12 B per entry, g
read and dX written once (0.35 ms at Reddit's 79.0 M entries and width
128); what sets its time is one gather of a g row per entry, as the
forward's of x rows.  A scatter over the forward's segments adds into
dX with one global float atomic per entry and feature, because no warp
owns a source row (twice the forward's time at width 128); B2^T's CTA
owns a piece of one source interval instead, so a dX row takes one
store, or one vector `red` per piece of a split interval (`sum_t.
merged_rows` counts those).  Sums agree with the plain version to fp32
rounding (the order of the adds varies from run to run), and bit for
bit where they are exact.
"""
from __future__ import annotations

import ctypes
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from repro_torch import tracing
from repro_torch.kernels import _build
from repro_torch.kernels._common import (check_status, check_tensor,
                                         stream_handle)
from repro_torch.kernels.rer_gather import ops as gather_ops

# kernel launches, counted where launched: "count" (the count's walk and
# its dense second launch), "resolve" and "max" (the tie walk), one each
# per max aggregate's backward (`packed_max_backward`); the sum's B2^T is
# counted in rer_gather.LAUNCHES["sum_t"], beside the forward it
# differentiates
LAUNCHES = {"count": 0, "resolve": 0, "max": 0}

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
    v * x[s, f] == y[d, f].  With `packed_max_scatter_plain`, the tests'
    oracle of the max backward's even split of a row's cotangent."""
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
    every group, every row walked: the tests' oracle of the max
    backward, with the counts of `packed_max_count_plain`."""
    t = x.shape[0] // q
    dx = torch.zeros_like(x)
    for gr in groups:
        dst, src, v = group_entries(gr, t)
        share = g[dst] / torch.clamp_min(cnt[dst], 1).float()
        dx.index_add_(0, src, torch.where(_win(v, x[src], y[dst]),
                                          v[:, None] * share,
                                          torch.zeros((), device=x.device)))
    return dx


def packed_max_words_plain(groups: Groups, x: torch.Tensor,
                           y: torch.Tensor, *, q: int) -> torch.Tensor:
    """The winner words (int32, the shape of x): 0 where a destination
    row and feature has no winner, -(s+1) where its one winner comes
    from source s with weight 1, else its count of winners."""
    t = x.shape[0] // q
    cnt = torch.zeros(x.shape, dtype=torch.int64, device=x.device)
    src = torch.zeros_like(cnt)      # sum of (s+1) over unit winners
    unit = torch.zeros_like(cnt)     # unit winners
    for gr in groups:
        dst, s, v = group_entries(gr, t)
        win = _win(v, x[s], y[dst]).long()
        one = win * (v == 1.0).long()[:, None]
        cnt.index_add_(0, dst, win)
        unit.index_add_(0, dst, one)
        src.index_add_(0, dst, one * (s + 1)[:, None])
    lone = (cnt == 1) & (unit == 1)
    return torch.where(lone, -src, cnt).to(torch.int32)


def packed_max_resolve_plain(words: torch.Tensor, g: torch.Tensor):
    """The resolve pass: (dX of the lone winners of weight 1, the (rows,)
    int32 flags of the rows whose ties the walk must take)."""
    dx = torch.zeros_like(g)
    send = (words < 0) & (g != 0)
    d, f = torch.nonzero(send, as_tuple=True)
    dx.index_put_((-words[d, f].long() - 1, f), g[d, f], accumulate=True)
    flag = ((words > 0) & (g != 0)).any(dim=1).to(torch.int32)
    return dx, flag


def packed_max_walk_plain(groups: Groups, x: torch.Tensor,
                          y: torch.Tensor, g: torch.Tensor,
                          words: torch.Tensor, flag: torch.Tensor,
                          dx: torch.Tensor, *, q: int) -> torch.Tensor:
    """The tie walk: dx[s] += v * (g[d] / words[d]) over the winning
    entries of the flagged rows whose word is a count; returns dx."""
    t = x.shape[0] // q
    for gr in groups:
        dst, src, v = group_entries(gr, t)
        w = words[dst]
        take = (_win(v, x[src], y[dst]) & (w > 0)
                & (flag[dst] != 0)[:, None])
        share = g[dst] / torch.clamp_min(w, 1).float()
        dx.index_add_(0, src, torch.where(take, v[:, None] * share,
                                          torch.zeros((), device=x.device)))
    return dx


def packed_max_backward_plain(groups: Groups, x: torch.Tensor,
                              y: torch.Tensor, g: torch.Tensor, *,
                              q: int):
    """The max backward's passes in plain PyTorch, as the card takes
    them: (dX, the row flags)."""
    words = packed_max_words_plain(groups, x, y, q=q)
    dx, flag = packed_max_resolve_plain(words, g)
    return packed_max_walk_plain(groups, x, y, g, words, flag, dx,
                                 q=q), flag


_LIB = None


def _lib():
    global _LIB
    if _LIB is None:
        lib = _build.load("rer_gather_bwd")
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.rer_gather_max_count_launch.argtypes = (
            [p] * 4 + [i] + [p] * 4 + [i] * 3 + [p])
        lib.rer_gather_max_count_launch.restype = i
        lib.rer_gather_max_resolve_launch.argtypes = [p] * 5 + [i] * 2 + [p]
        lib.rer_gather_max_resolve_launch.restype = i
        lib.rer_gather_bwd_scatter_launch.argtypes = (
            [p] * 4 + [i] + [p] * 6 + [i] * 3 + [p])
        lib.rer_gather_bwd_scatter_launch.restype = i
        lib.rer_gather_bwd_sum_launch.argtypes = (
            [p, p, i, p, p] + [i] * 4 + [p, p] + [i] * 3 + [p, p])
        lib.rer_gather_bwd_sum_launch.restype = i
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
                   x: torch.Tensor, y: torch.Tensor, words: torch.Tensor,
                   flag: torch.Tensor, dx: torch.Tensor) -> torch.Tensor:
    """Launch the max's tie walk once over the groups' work table
    (counted by the caller): over the winners of x and y in the rows of
    the resolve pass's `flag`, add where `words` holds a count into that
    pass's `dx`."""
    check_tensor(flag, "flag", torch.int32, g.device, 1)
    if flag.shape[0] != g.shape[0]:
        raise ValueError(f"{flag.shape[0]} flags for {g.shape[0]} rows")
    w = _table(groups, g, q, [
        ("g", g, torch.float32), ("x", x, torch.float32),
        ("y", y, torch.float32), ("words", words, torch.int32),
        ("dx", dx, torch.float32)])
    status = _lib().rer_gather_bwd_scatter_launch(
        w.gtab.data_ptr(), w.pieces.data_ptr(), w.poff.data_ptr(),
        w.seg_ptr.data_ptr(), w.n_seg, x.data_ptr(), y.data_ptr(),
        g.data_ptr(), words.data_ptr(), flag.data_ptr(), dx.data_ptr(), q,
        g.shape[0] // q, g.shape[1], stream_handle(g.device))
    check_status(status, "rer_gather_bwd scatter")
    return dx


def source_merged_rows(src, groups: Groups, t: int) -> int:
    """The dX rows B2^T adds rather than stores over the source table
    `src` (`rer_gather.groups_source`): per piece of a split source
    interval, its columns with an entry, what the kernel adds into the
    `sum_t.merged_rows` counter on the card.  Read back to the host."""
    tiles = src.tiles.cpu().numpy().astype(np.int64)
    ptr = src.ptr.cpu().numpy().astype(np.int64)
    pieces = src.pieces.cpu().numpy().astype(np.int64)
    n = int(ptr[-1])
    j = np.repeat(np.arange(tiles.shape[0]), np.diff(ptr))
    off = np.arange(n) - ptr[j]
    col = np.zeros(n, np.int64)
    for gi, gr in enumerate(groups):
        m = tiles[j, 0] == gi
        col[m] = gr["cols"].cpu().numpy()[tiles[j[m], 1], off[m]]
    # each entry's piece: the last one starting at or before it (a
    # non-empty piece sorts after an empty one with the same start)
    by = np.lexsort((pieces[:, 2], pieces[:, 1]))
    pid = by[np.searchsorted(pieces[by, 1], np.arange(n), side="right") - 1]
    keep = pieces[pid, 3] == 1
    return int(np.unique(pid[keep] * t + col[keep]).size)


def packed_groups_t(groups: Groups, g: torch.Tensor, *,
                    q: int) -> torch.Tensor:
    """dX (q*T, F) = A^T G over a plan's forward groups: the sum
    backward of `rer_gather.packed_groups_spmm`.  CPU tensors take the
    plain version; CUDA tensors one launch of B2^T over the groups'
    source table (no carrier of A^T).  While a profiler records,
    `sum_t.entries` counts the real entries walked and
    `sum_t.merged_rows` the dX rows added by a split interval's merge
    rather than stored (on the card, added by the kernel into a device
    counter that is read when the table is reported; on the CPU, from
    the table, `source_merged_rows`)."""
    rec = tracing.recording()
    if g.device.type == "cpu":
        dx = packed_groups_t_plain(groups, g, q=q)
        if rec:
            src = gather_ops.groups_source(groups, q, g.device)
            tracing.count("sum_t.entries", src.entries)
            tracing.count("sum_t.merged_rows", source_merged_rows(
                src, groups, g.shape[0] // q))
        return dx
    if g.device.type != "cuda":
        raise ValueError(f"no rer_gather_bwd for device {g.device}")
    dev = g.device
    w = _table(groups, g, q, [("g", g, torch.float32)])
    src = gather_ops.groups_source(groups, q, dev)
    t = g.shape[0] // q
    # made at the first call, so that a traced one adds no fill
    counter = tracing.device_counter("sum_t.merged_rows", dev)
    dx = torch.empty_like(g)
    status = _lib().rer_gather_bwd_sum_launch(
        w.gtab.data_ptr(), src.pieces.data_ptr(), src.pieces.shape[0],
        src.ptr.data_ptr(), src.tiles.data_ptr(), src.piece, src.tiles_max,
        *src.zero, g.data_ptr(), dx.data_ptr(), src.q, t, g.shape[1],
        counter.data_ptr() if rec else None, stream_handle(dev))
    check_status(status, "rer_gather_bwd sum")
    if src.q < q:               # intervals the groups do not name
        dx[src.q * t:].zero_()
    gather_ops.LAUNCHES["sum_t"] += 1
    if rec:
        tracing.count("sum_t.entries", src.entries)
    return dx


def _count_launch(groups: Groups, x: torch.Tensor, y: torch.Tensor,
                  q: int, scratch: torch.Tensor) -> torch.Tensor:
    """The words over the groups' work table on the card; `scratch`, a
    4-byte tensor of x's shape (the backward's dX before it is zeroed),
    takes the lone winners' sources."""
    w = _table(groups, x, q, [("x", x, torch.float32),
                              ("y", y, torch.float32)])
    words = torch.empty(x.shape, dtype=torch.int32, device=x.device)
    status = _lib().rer_gather_max_count_launch(
        w.gtab.data_ptr(), w.pieces.data_ptr(), w.poff.data_ptr(),
        w.seg_ptr.data_ptr(), w.n_seg, x.data_ptr(), y.data_ptr(),
        words.data_ptr(), scratch.data_ptr(),
        q, x.shape[0] // q, x.shape[1], stream_handle(x.device))
    check_status(status, "rer_gather_bwd count")
    LAUNCHES["count"] += 1
    return words


def _on(t: torch.Tensor) -> bool:
    """True for a CUDA tensor, False for a CPU one."""
    if t.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no rer_gather_bwd for device {t.device}")
    return t.device.type == "cuda"


def packed_max_words(groups: Groups, x: torch.Tensor, y: torch.Tensor,
                     *, q: int) -> torch.Tensor:
    """The winner words (int32, the shape of x) of a max aggregate over
    a plan's groups: x is the forward's input and y its finished output,
    (q*T, F).  CPU tensors take the plain version; CUDA tensors the
    count's walk and its dense second launch."""
    if not _on(x):
        return packed_max_words_plain(groups, x, y, q=q)
    scratch = torch.empty(x.shape, dtype=torch.int32, device=x.device)
    return _count_launch(groups, x, y, q, scratch)


def packed_max_resolve(words: torch.Tensor, g: torch.Tensor, *,
                       dx: Optional[torch.Tensor] = None,
                       walked: Optional[torch.Tensor] = None):
    """The resolve pass over the words and the cotangent g, (rows, F):
    (dX with the lone winners' adds, the (rows,) int32 flags of the rows
    the walk must take).  CPU tensors take the plain version; CUDA
    tensors one launch, into `dx` where given (zero-filled there), and
    adding the flagged rows into `walked`, one int64 on the card, where
    given."""
    if not _on(g):
        return packed_max_resolve_plain(words, g)
    check_tensor(words, "words", torch.int32, g.device, 2)
    check_tensor(g, "g", torch.float32, g.device, 2)
    if dx is None:
        dx = torch.empty_like(g)
    check_tensor(dx, "dx", torch.float32, g.device, 2)
    if words.shape != g.shape or dx.shape != g.shape:
        raise ValueError(f"words {tuple(words.shape)} and dx "
                         f"{tuple(dx.shape)} must match {tuple(g.shape)}")
    if walked is not None:
        check_tensor(walked, "walked", torch.int64, g.device, 1)
    flag = torch.empty(g.shape[0], dtype=torch.int32, device=g.device)
    status = _lib().rer_gather_max_resolve_launch(
        words.data_ptr(), g.data_ptr(), dx.data_ptr(), flag.data_ptr(),
        None if walked is None else walked.data_ptr(), g.shape[0],
        g.shape[1], stream_handle(g.device))
    check_status(status, "rer_gather_bwd resolve")
    LAUNCHES["resolve"] += 1
    return dx, flag


def packed_max_backward(groups: Groups, x: torch.Tensor, y: torch.Tensor,
                        g: torch.Tensor, *, q: int) -> torch.Tensor:
    """dX (q*T, F) of a max aggregate over a plan's groups for the
    cotangent g: the words, the resolve pass and the tie walk over the
    flagged rows.  CPU tensors take the plain version; CUDA tensors one
    kernel launch a pass.  While a profiler records, `max_bwd.rows`
    counts the rows and `max_bwd.walk_rows` the rows the walk visits
    (on the card, added by the resolve pass into a device counter that
    is read when the table is reported)."""
    rec = tracing.recording()
    if not _on(x):
        dx, flag = packed_max_backward_plain(groups, x, y, g, q=q)
        walk_rows = int(flag.sum())
    else:
        check_tensor(g, "g", torch.float32, x.device, 2)
        if g.shape != x.shape:
            raise ValueError(f"g {tuple(g.shape)} must match "
                             f"{tuple(x.shape)}")
        dx = torch.empty_like(g)
        words = _count_launch(groups, x, y, q, dx)
        # made at the first call, so that a traced one adds no fill
        counter = tracing.device_counter("max_bwd.walk_rows", g.device)
        _, flag = packed_max_resolve(words, g, dx=dx,
                                     walked=counter if rec else None)
        walk_rows = 0               # counted on the card
        dx = scatter_launch(groups, g, q, x, y, words, flag, dx)
        LAUNCHES["max"] += 1
    if rec:
        tracing.count("max_bwd.rows", g.shape[0])
        tracing.count("max_bwd.walk_rows", walk_rows)
    return dx
