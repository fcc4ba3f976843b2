"""R-GCN, the plain reference (Schlichtkrull et al. 2018,
arXiv:1703.06103, Eq. 2, entity classification, no basis
decomposition): h'_i = ReLU(W_0 h_i + sum_r sum_{j in N_r(i)} W_r h_j /
c_{i,r}), c_{i,r} = |N_r(i)| counting multi-edges.  Each relation's
messages are one plain product over that relation's edges (W_r x_j per
edge, never per vertex and relation), scaled and summed at the
destinations.  Works on the raw edges in their own vertex order.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch

from portbench.lib import plain


def _glorot(shape, fan_in, fan_out, gen, device):
    return (torch.randn(shape, generator=gen, device=device)
            * (2.0 / (fan_in + fan_out)) ** 0.5)


def init_params(cfg: Dict, gen: torch.Generator, device: torch.device):
    """Per layer W_0 (F, H) and W_r (R, F, H), Glorot normal."""
    dims, r = cfg["dims"], cfg["graph"]["relations"]
    return [{"w0": _glorot((f, h), f, h, gen, device),
             "wr": _glorot((r, f, h), f, h, gen, device)}
            for f, h in zip(dims[:-1], dims[1:])]


class Graph:
    """The edges sorted by relation with their 1 / c_{i,r} weights, and
    the work counts of `lib/counts.py`."""

    def __init__(self, src, dst, rel, cfg: Dict):
        n, r = cfg["graph"]["vertices"], cfg["graph"]["relations"]
        s, d, t = src.long(), dst.long(), rel.long()
        key = d * r + t
        cnt = torch.bincount(key, minlength=n * r)
        val = 1.0 / cnt[key].float()
        del cnt
        order = torch.sort(t, stable=True).indices
        self.src, self.dst, self.val = s[order], d[order], val[order]
        self.offsets = [0] + torch.cumsum(
            torch.bincount(t, minlength=r), 0).tolist()
        self.n, self.r = n, r
        self.work = {"n": n,
                     "entries": plain.distinct((d * n + s) * r + t),
                     "src_rows": plain.distinct(s * r + t),
                     "dst_rows": plain.distinct(key), "self_term": 1}

    def astype(self, dtype: torch.dtype) -> "Graph":
        """A copy whose edge weights are `dtype` (the float64 witness of
        the calibration)."""
        g = object.__new__(Graph)
        g.__dict__.update(self.__dict__, val=self.val.to(dtype))
        return g


def forward(graph: Graph, x: torch.Tensor, params, precision: str = "fp32",
            fault: Optional[str] = None):
    """The stack's output.  `fault` plants one of the calibration's
    faults in the first layer's aggregate backward (the gradient the
    relation weights W_r get): "scaled" returns it doubled,
    "transposed" takes it at the edges' sources in place of their
    destinations."""
    if fault not in (None, "scaled", "transposed"):
        raise ValueError(fault)
    h = x
    off = graph.offsets
    for i, p in enumerate(params):
        msgs = []
        for rr in range(graph.r):
            lo, hi = off[rr], off[rr + 1]
            if hi > lo:
                msgs.append(plain.mm(h[graph.src[lo:hi]], p["wr"][rr],
                                     precision))
        h_out = p["w0"].shape[1]
        if not msgs:
            agg = torch.zeros((graph.n, h_out), dtype=h.dtype,
                              device=h.device)
        elif i == 0 and fault == "transposed":
            agg = plain.EdgeSumTransposed.apply(
                torch.cat(msgs), graph.dst, graph.src, graph.val, graph.n)
        else:
            m = torch.cat(msgs)
            if i == 0 and fault == "scaled":
                m = plain.GradScale.apply(m, 2.0)
            agg = torch.zeros((graph.n, h_out), dtype=h.dtype,
                              device=h.device).index_add(
                0, graph.dst, m * graph.val[:, None])
        h = torch.relu(plain.mm(h, p["w0"], precision) + agg)
    return h
