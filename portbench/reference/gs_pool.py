"""GraphSAGE with the pooling aggregator, the plain reference (Hamilton,
Ying & Leskovec 2017, arXiv:1706.02216, Algorithm 1 with Eq. 3), as
EnGN's Table 1 and Eq. 2 write it (arXiv:1909.00155):

- extraction  m_u = ReLU(h_u W_pool + b_pool);
- aggregate   a_v = the element-wise max of m_u over the edges u -> v
  (a vertex with no in-edge gets 0);
- update      h'_v = ReLU([a_v || h_v] W), every layer, the last one too.

Departures from Hamilton et al., as EnGN runs the model: the whole
graph, with no neighbour sampling; no L2 normalisation of the
embeddings; the pool width equal to the layer's width (EnGN's Eq. 2;
Hamilton's pool is 512 or 1024 wide); ReLU on the last layer.

The max runs over the drawn edges, repeats included, which a max does
not feel.  At Reddit's size the per-edge messages would not fit (114.6 M
edges x 256 features x 8 B), so `ChunkedMax` takes the max in chunks of
edges: a running `amax` forward; a backward that counts each row's tied
winners over every chunk, then gives each winner's source row g / count,
the even split over ties that the program's max backward makes.  Works
on the raw edges in their own vertex order.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch

from portbench.lib import plain

CHUNK_BYTES = 1 << 30       # the largest per-chunk message block


def init_params(cfg: Dict, gen: torch.Generator, device: torch.device):
    """Per layer `w_pool` (F, H) and `w` (H + F, H), Glorot normal, and
    `b_pool` (H,), N(0, 0.1^2): keyed and shaped as the port's
    `GSPoolLayer`."""
    out = []
    for f, h in zip(cfg["dims"][:-1], cfg["dims"][1:]):
        w_pool = torch.randn((f, h), generator=gen, device=device) \
            * (2.0 / (f + h)) ** 0.5
        b_pool = torch.randn((h,), generator=gen, device=device) * 0.1
        w = torch.randn((h + f, h), generator=gen, device=device) \
            * (2.0 / (h + f + h)) ** 0.5
        out.append({"w_pool": w_pool, "b_pool": b_pool, "w": w})
    return out


class Graph:
    """The drawn edges, and the work counts: `entries` the distinct
    (src, dst) pairs, `src_rows` the vertices that send."""

    def __init__(self, src, dst, rel, cfg: Dict):
        n = cfg["graph"]["vertices"]
        self.src, self.dst = src.long(), dst.long()
        self.n = n
        self.work = {"n": n,
                     "entries": plain.distinct(self.dst * n + self.src),
                     "src_rows": plain.distinct(self.src), "dst_rows": n,
                     "self_term": 0}

    def astype(self, dtype: torch.dtype) -> "Graph":
        """The graph has no values: the same object at any precision."""
        return self


def _chunks(e: int, f: int, itemsize: int, chunk: Optional[int]):
    step = chunk or max(1, CHUNK_BYTES // max(1, f * itemsize))
    return [(lo, min(lo + step, e)) for lo in range(0, e, step)]


class ChunkedMax(torch.autograd.Function):
    """y[v] = max over the edges u -> v of m[u], 0 where v has none, in
    chunks of `chunk` edges (default: `CHUNK_BYTES` of messages).  The
    backward splits g evenly over each row's tied winners, counted over
    every chunk.  `transposed` is the calibration's planted fault "the
    gradient taken at the sources, given to the destinations"."""

    @staticmethod
    def forward(ctx, m, src, dst, n: int, chunk: Optional[int] = None,
                transposed: bool = False):
        f = m.shape[1]
        parts = _chunks(src.numel(), f, m.element_size(), chunk)
        y = torch.full((n, f), -torch.inf, dtype=m.dtype, device=m.device)
        for lo, hi in parts:
            d = dst[lo:hi]
            y.scatter_reduce_(0, d[:, None].expand(-1, f), m[src[lo:hi]],
                              "amax", include_self=True)
        ctx.save_for_backward(m, y, src, dst)
        ctx.parts, ctx.transposed = parts, transposed
        return torch.where(torch.isneginf(y), 0.0, y)

    @staticmethod
    def backward(ctx, g):
        m, y, src, dst = ctx.saved_tensors
        cnt = torch.zeros_like(y)
        for lo, hi in ctx.parts:
            s, d = src[lo:hi], dst[lo:hi]
            cnt.index_add_(0, d, (m[s] == y[d]).to(m.dtype))
        share = g / torch.clamp_min(cnt, 1.0)
        del cnt
        dm = torch.zeros_like(m)
        for lo, hi in ctx.parts:
            s, d = src[lo:hi], dst[lo:hi]
            win = (m[s] == y[d]).to(m.dtype)
            at, frm = (d, s) if ctx.transposed else (s, d)
            dm.index_add_(0, at, win * share[frm])
        return dm, None, None, None, None, None


def forward(graph: Graph, x: torch.Tensor, params, precision: str = "fp32",
            fault: Optional[str] = None, chunk: Optional[int] = None):
    """The stack's output.  `fault` plants one of the calibration's
    faults in the first layer's aggregate backward: "scaled" returns it
    doubled, "transposed" takes it at the edges' sources and gives it to
    their destinations."""
    if fault not in (None, "scaled", "transposed"):
        raise ValueError(fault)
    h = x
    for i, p in enumerate(params):
        m = torch.relu(plain.mm(h, p["w_pool"], precision) + p["b_pool"])
        if i == 0 and fault == "scaled":
            m = plain.GradScale.apply(m, 2.0)
        agg = ChunkedMax.apply(m, graph.src, graph.dst, graph.n, chunk,
                               i == 0 and fault == "transposed")
        del m
        h = torch.relu(plain.mm(torch.cat([agg, h], 1), p["w"], precision))
    return h


def model_flops(dims, work: Dict[str, int], train: bool) -> float:
    """Least FLOPs of a forward: per layer the extraction of every vertex
    that sends, 2 * src_rows * F * H, one comparison an entry a feature,
    entries * H, and the update of every vertex, 2 * N * (H + F) * H.  A
    step counts twice that: its weight gradients alone redo each
    product once."""
    total = 0.0
    for f, h in zip(dims[:-1], dims[1:]):
        total += (2.0 * work["src_rows"] * f * h + float(work["entries"]) * h
                  + 2.0 * work["n"] * (h + f) * h)
    return total * (2 if train else 1)


def aggregate_bytes(dims, work: Dict[str, int], train: bool) -> float:
    """Least bytes of the max aggregates: per layer each distinct entry
    once (12 B) and each aggregated row in and out once at the layer's
    width; a step doubles it (the backward walks the entries again,
    reads the cotangent rows and writes the gradient rows)."""
    total = sum(12.0 * work["entries"] + 8.0 * work["n"] * h
                for h in dims[1:])
    return total * (2 if train else 1)
