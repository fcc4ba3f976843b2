"""Gated-GCN's aggregate over a plan's packed bucket groups, and its
backward (`csrc/rer_gather_gated.cu`).

With the destination and source projections ph = x W_H and pc = x W_C,
each (q*T, F), and every merged entry (d, s, v) of the groups,
z = sigmoid(ph[d] + pc[s]) per feature:

    y[d]   += v * z * x[s]
    dx[s]  += v * z * g[d]
    dpc[s] += v * g[d] * x[s] * z (1 - z)
    dph[d] += v * g[d] * x[s] * z (1 - z)

for the cotangent g of y.  On the card each is ONE launch over the plan's
tables, and none stores z or any other (entry, feature) tensor:

  * the forward walks the work table destination-stationary on B2's
    walker (`rer_gather`): each warp evaluates z in registers for its
    entries and adds each destination row's sum into y once a run;
  * the backward is two walks that recompute z: source-stationary over
    the plan's source table on B2^T's walker (`rer_gather_bwd`), for dx
    and dpc, loading pc[s] once per run of a column, each row written
    once (or merged once per piece of a split source interval), dx
    skipped where the layer's input takes no gradient;
    destination-stationary over the work table for dph.

CPU tensors take the plain versions: the flat formula the CPU route of
`prepare_graph` (flat entries) computes, `gated_flat_plain`, over the
groups' slots, and its backward written out, `gated_backward_plain`; the
kernels are held to them on the card.  `gated_groups_aggregate` is the
entry point; under autograd its backward is the two walks.  While a
profiler records, the `gated.gate_evals` counter adds the (entry,
feature) gate evaluations of each walk, entries × F from the plan's
table.

Source note.  Replaces no TPU kernel: the reference's gated route
gathers both endpoints' projections for every flat entry with XLA
(`repro/core/engn.py::_staged_gated`), which at Reddit's 78.8 M entries
and width 602 holds 190 GB tensors.  On the H100 each walk is bound by
its operations at any width (per entry and feature, the exponential not
counted: the forward 5, the source walk 7 and 2 more for dx, the dph
walk 8; 3.54 ms for the forward at Reddit's width 602, against 0.95 ms
of bytes).
"""
from __future__ import annotations

import ctypes
from typing import Dict, Optional, Sequence, Tuple

import torch
from torch.autograd.function import once_differentiable

from repro_torch import tracing
from repro_torch.kernels import _build
from repro_torch.kernels._common import (check_status, check_tensor,
                                         stream_handle)
from repro_torch.kernels.rer_gather import ops as gather_ops
from repro_torch.tracing import span

# kernel launches, counted where launched: "fwd" the forward, "src" the
# source walk (dx, dpc) and "dph" the destination walk of a backward
LAUNCHES = {"fwd": 0, "src": 0, "dph": 0}

Groups = Sequence[Dict[str, torch.Tensor]]


def gated_flat_plain(gsrc: torch.Tensor, gdst: torch.Tensor,
                     gval: torch.Tensor, ph: torch.Tensor, pc: torch.Tensor,
                     x: torch.Tensor, *, n: int) -> torch.Tensor:
    """y (n, F): y[gdst] += gval * sigmoid(ph[gdst] + pc[gsrc]) * x[gsrc],
    one flat gather and one segment sum, as the reference's flat route."""
    gsrc, gdst = gsrc.long(), gdst.long()
    z = torch.sigmoid(ph[gdst] + pc[gsrc])
    y = torch.zeros((n, x.shape[1]), dtype=x.dtype, device=x.device)
    return y.index_add_(0, gdst, gval[:, None] * z * x[gsrc])


def gated_backward_plain(gsrc: torch.Tensor, gdst: torch.Tensor,
                         gval: torch.Tensor, ph: torch.Tensor,
                         pc: torch.Tensor, x: torch.Tensor, g: torch.Tensor,
                         *, need_dx: bool = True
                         ) -> Tuple[Optional[torch.Tensor], torch.Tensor,
                                    torch.Tensor]:
    """(dx or None, dpc, dph) of `gated_flat_plain` for the cotangent g,
    written out."""
    gsrc, gdst = gsrc.long(), gdst.long()
    z = torch.sigmoid(ph[gdst] + pc[gsrc])
    gd = gval[:, None] * g[gdst]
    t = gd * z * (1.0 - z) * x[gsrc]
    dpc = torch.zeros_like(pc).index_add_(0, gsrc, t)
    dph = torch.zeros_like(ph).index_add_(0, gdst, t)
    dx = (torch.zeros_like(x).index_add_(0, gsrc, gd * z) if need_dx
          else None)
    return dx, dpc, dph


def _flat(groups: Groups, t: int):
    """Every slot of the groups as flat global (src, dst, val), pads
    included (weight 0)."""
    from repro_torch.kernels.rer_gather_bwd.ops import group_entries
    parts = [group_entries(gr, t) for gr in groups]
    dst, src, val = (torch.cat([p[i] for p in parts]) for i in range(3))
    return src, dst, val


def _entries(groups: Groups) -> int:
    """The groups' real entries: the plan's source table's count, else
    counted from the slots (read back)."""
    src = getattr(groups, "source", None)
    if src is not None:
        return src.entries
    return int(sum(int(gather_ops.real_counts(gr["rows"], gr["cols"],
                                              gr["vals"]).sum())
                   for gr in groups))


def _count(groups: Groups, f: int, walks: int) -> None:
    if tracing.recording():
        tracing.count("gated.gate_evals", walks * _entries(groups) * f)


_LIB = None


def _lib():
    global _LIB
    if _LIB is None:
        lib = _build.load("rer_gather_gated")
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.rer_gather_gated_launch.argtypes = [p] * 4 + [i] + [p] * 4 \
            + [i] * 3 + [p]
        lib.rer_gather_gated_launch.restype = i
        lib.rer_gather_gated_dph_launch.argtypes = [p] * 4 + [i] + [p] * 5 \
            + [i] * 3 + [p]
        lib.rer_gather_gated_dph_launch.restype = i
        lib.rer_gather_gated_src_launch.argtypes = [p, p, i, p, p] + [i] * 4 \
            + [p] * 6 + [i] * 3 + [p]
        lib.rer_gather_gated_src_launch.restype = i
        _LIB = lib
    return _LIB


def _operands(groups: Groups, q: int, tensors):
    """The groups' work table on the grid of the (q*T, F) operands
    (name, tensor), after their checks."""
    ref = tensors[0][1]
    dev = ref.device
    for name, tensor in tensors:
        check_tensor(tensor, name, torch.float32, dev, 2)
        if tensor.shape != ref.shape:
            raise ValueError(f"{name} {tuple(tensor.shape)} must match "
                             f"{tuple(ref.shape)}")
    if q <= 0 or ref.shape[0] % q:
        raise ValueError(f"{ref.shape[0]} rows are not q={q} intervals")
    if not groups:
        raise ValueError("a gated aggregate needs at least one bucket "
                         "group")
    return gather_ops.groups_work(groups, q, ref.shape[0] // q, dev)


def forward_launch(groups: Groups, ph, pc, x, q: int) -> torch.Tensor:
    """y: one launch of the forward over the groups' work table (counted
    here)."""
    w = _operands(groups, q, [("x", x), ("ph", ph), ("pc", pc)])
    y = torch.empty_like(x)
    status = _lib().rer_gather_gated_launch(
        w.gtab.data_ptr(), w.pieces.data_ptr(), w.poff.data_ptr(),
        w.seg_ptr.data_ptr(), w.n_seg, ph.data_ptr(), pc.data_ptr(),
        x.data_ptr(), y.data_ptr(), q, x.shape[0] // q, x.shape[1],
        stream_handle(x.device))
    check_status(status, "rer_gather_gated")
    LAUNCHES["fwd"] += 1
    return y


def src_launch(groups: Groups, ph, pc, x, g, q: int, need_dx: bool):
    """(dx or None, dpc): one launch of the source walk over the groups'
    source table (counted here)."""
    dev = x.device
    w = _operands(groups, q, [("x", x), ("ph", ph), ("pc", pc), ("g", g)])
    t, f = x.shape[0] // q, x.shape[1]
    src = gather_ops.groups_source(groups, q, dev)
    dpc = torch.empty_like(x)
    dx = torch.empty_like(x) if need_dx else None
    status = _lib().rer_gather_gated_src_launch(
        w.gtab.data_ptr(), src.pieces.data_ptr(), src.pieces.shape[0],
        src.ptr.data_ptr(), src.tiles.data_ptr(), src.piece, src.tiles_max,
        *src.zero, ph.data_ptr(), pc.data_ptr(), x.data_ptr(), g.data_ptr(),
        None if dx is None else dx.data_ptr(), dpc.data_ptr(), src.q, t, f,
        stream_handle(dev))
    check_status(status, "rer_gather_gated src")
    LAUNCHES["src"] += 1
    if src.q < q:               # intervals the groups do not name
        for a in (dpc, dx):
            if a is not None:
                a[src.q * t:].zero_()
    return dx, dpc


def dph_launch(groups: Groups, ph, pc, x, g, q: int) -> torch.Tensor:
    """dph: one launch of the destination walk over the groups' work
    table (counted here)."""
    w = _operands(groups, q, [("x", x), ("ph", ph), ("pc", pc), ("g", g)])
    dph = torch.empty_like(x)
    status = _lib().rer_gather_gated_dph_launch(
        w.gtab.data_ptr(), w.pieces.data_ptr(), w.poff.data_ptr(),
        w.seg_ptr.data_ptr(), w.n_seg, ph.data_ptr(), pc.data_ptr(),
        x.data_ptr(), g.data_ptr(), dph.data_ptr(), q, x.shape[0] // q,
        x.shape[1], stream_handle(x.device))
    check_status(status, "rer_gather_gated dph")
    LAUNCHES["dph"] += 1
    return dph


def _on(t: torch.Tensor) -> bool:
    """True for a CUDA tensor, False for a CPU one."""
    if t.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no rer_gather_gated for device {t.device}")
    return t.device.type == "cuda"


def gated_forward(groups: Groups, ph: torch.Tensor, pc: torch.Tensor,
                  x: torch.Tensor, *, q: int) -> torch.Tensor:
    """y (q*T, F), the gated aggregate over a plan's groups, without
    autograd.  CPU tensors take the plain version; CUDA tensors one
    launch."""
    if _on(x):
        y = forward_launch(groups, ph, pc, x, q)
    else:
        src, dst, val = _flat(groups, x.shape[0] // q)
        y = gated_flat_plain(src, dst, val, ph, pc, x, n=x.shape[0])
    _count(groups, x.shape[1], 1)
    return y


def gated_backward(groups: Groups, ph: torch.Tensor, pc: torch.Tensor,
                   x: torch.Tensor, g: torch.Tensor, *, q: int,
                   need_dx: bool = True, need_dph: bool = True):
    """(dx, dpc, dph) of `gated_forward` for the cotangent g, each (q*T,
    F); dx (dph) is None where `need_dx` (`need_dph`) is False.  CPU
    tensors take the plain version; CUDA tensors the source walk (dx,
    dpc) and the destination walk (dph), one launch each."""
    if _on(x):
        dx, dpc = src_launch(groups, ph, pc, x, g, q, need_dx)
        dph = dph_launch(groups, ph, pc, x, g, q) if need_dph else None
    else:
        src, dst, val = _flat(groups, x.shape[0] // q)
        dx, dpc, dph = gated_backward_plain(src, dst, val, ph, pc, x, g,
                                            need_dx=need_dx)
        dph = dph if need_dph else None
    _count(groups, x.shape[1], 1 + int(need_dph))
    return dx, dpc, dph


class _GatedGroups(torch.autograd.Function):
    @staticmethod
    def forward(ctx, ph, pc, x, groups, q):
        ctx.groups, ctx.q = groups, q
        ctx.save_for_backward(ph, pc, x)
        return gated_forward(groups, ph, pc, x, q=q)

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        ph, pc, x = ctx.saved_tensors
        with span("engn.aggregate_bwd"):
            dx, dpc, dph = gated_backward(
                ctx.groups, ph, pc, x, g.contiguous(), q=ctx.q,
                need_dx=ctx.needs_input_grad[2],
                need_dph=ctx.needs_input_grad[0])
        return dph, dpc, dx, None, None


def gated_groups_aggregate(groups: Groups, ph: torch.Tensor,
                           pc: torch.Tensor, x: torch.Tensor, *,
                           q: int) -> torch.Tensor:
    """The gated aggregate over a plan's bucket groups (dicts of `rows`,
    `cols`, `vals`, `block_row`, `block_col`; a `PlanGroups` carries the
    tables the kernels walk): ph, pc and x are (q*T, F), the result too.
    Under autograd the backward is the source walk and the destination
    walk over the same groups, which recompute the gates."""
    if any(gr["vals"].requires_grad for gr in groups):
        raise NotImplementedError("rer_gather_gated differentiates ph, pc "
                                  "and x only; the entries are the graph, "
                                  "a constant")
    if not (torch.is_grad_enabled()
            and (ph.requires_grad or pc.requires_grad or x.requires_grad)):
        return gated_forward(groups, ph, pc, x, q=q)
    return _GatedGroups.apply(ph, pc, x, groups, q)
