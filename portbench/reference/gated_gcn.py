"""Gated-GCN, the plain reference (Bresson & Laurent 2017,
arXiv:1711.07553, the residual gated graph ConvNet's edge gate), as
EnGN's Table 1 and Eq. 4 write it (arXiv:1909.00155):

- gate        z_uv = sigmoid(h_v W_H + h_u W_C), one gate for each edge
  u -> v and each input feature;
- aggregate   a_v = the sum over the edges u -> v of z_uv * h_u (a vertex
  with no in-edge gets 0);
- update      h'_v = ReLU(a_v W), every layer, the last one too.

Departures from Bresson & Laurent, as EnGN writes the model: the gate
is at the input width; the message gates h_u itself, not V h_u; there is
no self term U h_v, no residual and no batch normalisation.

The sum runs over the drawn edges, repeats included: a pair drawn k
times sends k messages, which the program's plans hold as one merged
entry of weight k (the message is linear in the weight).  At Reddit's
size the per-edge messages would not fit (114.6 M edges x 602 features x
8 B), so `ChunkedGated` takes the sum in chunks of edges: the forward
adds chunk by chunk; the backward recomputes each chunk's gates and sends
dx and dpc to the sources, dph to the destinations.  Works on the raw
edges in their own vertex order; parameters `w_h`, `w_c` (F, F) and `w`
(F, H) per layer, as the port's `GatedGCNLayer` names them.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch

from portbench.lib import plain

CHUNK_BYTES = 1 << 30       # the largest per-chunk message block
ENTRY_BYTES = 12            # one merged entry: int32 src, int32 dst, f32
FLOAT_BYTES = 4


def init_params(cfg: Dict, gen: torch.Generator, device: torch.device):
    """Per layer `w_h`, `w_c` (F, F) and `w` (F, H), Glorot normal: keyed
    and shaped as the port's `GatedGCNLayer`."""
    out = []
    for f, h in zip(cfg["dims"][:-1], cfg["dims"][1:]):
        p = {}
        for key, shape in (("w_h", (f, f)), ("w_c", (f, f)), ("w", (f, h))):
            p[key] = torch.randn(shape, generator=gen, device=device) \
                * (2.0 / (shape[0] + shape[1])) ** 0.5
        out.append(p)
    return out


class Graph:
    """The drawn edges, and the work counts: `entries` the distinct
    (src, dst) pairs, `src_rows` the vertices that send, `dst_rows`
    those that receive."""

    def __init__(self, src, dst, rel, cfg: Dict):
        n = cfg["graph"]["vertices"]
        self.src, self.dst = src.long(), dst.long()
        self.n = n
        self.work = {"n": n,
                     "entries": plain.distinct(self.dst * n + self.src),
                     "src_rows": plain.distinct(self.src),
                     "dst_rows": plain.distinct(self.dst), "self_term": 0}

    def astype(self, dtype: torch.dtype) -> "Graph":
        """The graph has no values: the same object at any precision."""
        return self


def _chunks(e: int, f: int, itemsize: int, chunk: Optional[int]):
    step = chunk or max(1, CHUNK_BYTES // max(1, f * itemsize))
    return [(lo, min(lo + step, e)) for lo in range(0, e, step)]


class ChunkedGated(torch.autograd.Function):
    """y[v] = the sum over the edges u -> v of sigmoid(ph[v] + pc[u]) *
    x[u], in chunks of `chunk` edges (default: `CHUNK_BYTES` of
    messages).  The backward recomputes each chunk's gates.
    `transposed` is the calibration's planted fault "the gradient taken
    at the destinations, given to the sources": the backward runs over
    the edges reversed."""

    @staticmethod
    def forward(ctx, ph, pc, x, src, dst, n: int,
                chunk: Optional[int] = None, transposed: bool = False):
        f = x.shape[1]
        parts = _chunks(src.numel(), f, x.element_size(), chunk)
        y = torch.zeros((n, f), dtype=x.dtype, device=x.device)
        for lo, hi in parts:
            s, d = src[lo:hi], dst[lo:hi]
            y.index_add_(0, d, torch.sigmoid(ph[d] + pc[s]) * x[s])
        ctx.save_for_backward(ph, pc, x, src, dst)
        ctx.parts, ctx.transposed = parts, transposed
        return y

    @staticmethod
    def backward(ctx, g):
        ph, pc, x, src, dst = ctx.saved_tensors
        need_dx = ctx.needs_input_grad[2]
        dph, dpc = torch.zeros_like(ph), torch.zeros_like(pc)
        dx = torch.zeros_like(x) if need_dx else None
        for lo, hi in ctx.parts:
            s, d = src[lo:hi], dst[lo:hi]
            if ctx.transposed:
                s, d = d, s
            z = torch.sigmoid(ph[d] + pc[s])
            gd = g[d]
            if need_dx:
                dx.index_add_(0, s, z * gd)
            t = gd * z * (1.0 - z) * x[s]
            del z, gd
            dpc.index_add_(0, s, t)
            dph.index_add_(0, d, t)
        return dph, dpc, dx, None, None, None, None, None


def forward(graph: Graph, x: torch.Tensor, params, precision: str = "fp32",
            fault: Optional[str] = None, chunk: Optional[int] = None):
    """The stack's output.  `fault` plants one of the calibration's
    faults in the first layer's aggregate backward: "scaled" returns it
    doubled, "transposed" runs it over the edges reversed."""
    if fault not in (None, "scaled", "transposed"):
        raise ValueError(fault)
    h = x
    for i, p in enumerate(params):
        ph = plain.mm(h, p["w_h"], precision)
        pc = plain.mm(h, p["w_c"], precision)
        agg = ChunkedGated.apply(ph, pc, h, graph.src, graph.dst, graph.n,
                                 chunk, i == 0 and fault == "transposed")
        del ph, pc
        if i == 0 and fault == "scaled":
            agg = plain.GradScale.apply(agg, 2.0)
        h = torch.relu(plain.mm(agg, p["w"], precision))
    return h


# -- least work ---------------------------------------------------------------
#
# Operations per (entry, feature) that the equations need, the sigmoid's
# exponential not counted: the forward's ph + pc, the sigmoid's add and
# divide, z * x and its add into the sum (5); the backward's
# s = g z (1 - z) (3), s x and its add into dph (2), the add of s into
# dpc (1; x multiplies the row once), and, where the layer's input is
# trained, z g and its add into dx (2).  The entry's weight is not
# counted (it is 1 on an unweighted graph but for multi-edges).
GATE_FWD, GATE_BWD, GATE_DX = 5, 6, 2


def gated_flops(dims, work: Dict[str, int], train: bool) -> float:
    """Least operations of the gated aggregates of one forward (or step):
    per layer, entries x F x the counts above."""
    total = 0.0
    for i, f in enumerate(dims[:-1]):
        per = GATE_FWD
        if train:
            per += GATE_BWD + (GATE_DX if i > 0 else 0)
        total += float(work["entries"]) * f * per
    return total


def gated_bytes(dims, work: Dict[str, int], train: bool) -> float:
    """Least bytes of the gated aggregates of one forward (or step): per
    layer each merged entry once (12 B), ph, pc and x read once and y
    written once, all (N, F); a step's backward reads the entries, ph,
    pc, x and the cotangent once more and writes dpc and dph, and dx
    where the layer's input is trained."""
    n, e = work["n"], work["entries"]
    total = 0.0
    for i, f in enumerate(dims[:-1]):
        row = FLOAT_BYTES * n * f
        total += ENTRY_BYTES * e + 4 * row
        if train:
            total += ENTRY_BYTES * e + (6 + int(i > 0)) * row
    return float(total)


def model_flops(dims, work: Dict[str, int], train: bool) -> float:
    """Least FLOPs of a forward: per layer the gate projections of the
    vertices that receive (ph, 2 * dst_rows * F * F) and that send (pc,
    2 * src_rows * F * F), the gated aggregate (`gated_flops`) and the
    update of every vertex, 2 * N * F * H.  A step adds the weight
    gradients (each product once more), the aggregate's backward, and,
    where the layer's input is trained, the input gradients through the
    three products."""
    total = gated_flops(dims, work, train)
    for i, (f, h) in enumerate(zip(dims[:-1], dims[1:])):
        mm = (2.0 * (work["dst_rows"] + work["src_rows"]) * f * f
              + 2.0 * work["n"] * f * h)
        total += mm * (1 + int(train) + int(train and i > 0))
    return total


def aggregate_bytes(dims, work: Dict[str, int], train: bool) -> float:
    """Least bytes of the gated aggregates (`gated_bytes`)."""
    return gated_bytes(dims, work, train)
