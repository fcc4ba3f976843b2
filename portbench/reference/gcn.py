"""GCN, the plain reference (Kipf & Welling 2017, arXiv:1609.02907,
Eq. 2): H' = ReLU(D~^-1/2 A~ D~^-1/2 H W) with A~ = A + I and D~ its
row sums (in-edges, multi-edges counted), every layer with its ReLU, as
EnGN's Table 1 writes GCN's update.  The aggregate is one sparse product
(`lib/plain.SparseAggregate`), the products plain matrix products at the
stated precision.  Works on the raw edges in their own vertex order.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch

from portbench.lib import plain


def init_params(cfg: Dict, gen: torch.Generator, device: torch.device):
    """One (F, H) weight per layer, N(0, 1/F)."""
    dims = cfg["dims"]
    return [{"w": torch.randn((f, h), generator=gen, device=device)
             * f ** -0.5} for f, h in zip(dims[:-1], dims[1:])]


class Graph:
    """The normalised adjacency and its transpose, and the work counts
    of `lib/counts.py`."""

    def __init__(self, src, dst, rel, cfg: Dict):
        n = cfg["graph"]["vertices"]
        dev = src.device
        loops = torch.arange(n, dtype=torch.int64, device=dev)
        s = torch.cat([src.long(), loops])
        d = torch.cat([dst.long(), loops])
        deg = torch.bincount(d, minlength=n).double()
        dinv = 1.0 / torch.sqrt(torch.clamp_min(deg, 1.0))
        val = (dinv[s] * dinv[d]).float()
        del deg
        self.a, self.at, entries = plain.sparse_pair(d, s, val, n)
        self.n = n
        self.work = {"n": n, "entries": entries, "src_rows": n,
                     "dst_rows": n, "self_term": 0}

    def astype(self, dtype: torch.dtype) -> "Graph":
        """A copy whose matrices hold `dtype` values (the float64 witness
        of the calibration)."""
        g = object.__new__(Graph)
        g.__dict__.update(self.__dict__, a=self.a.to(dtype),
                          at=self.at.to(dtype))
        return g


def forward(graph: Graph, x: torch.Tensor, params, precision: str = "fp32",
            fault: Optional[str] = None):
    """The stack's output.  `fault` plants one of the calibration's
    faults in the first layer's aggregate backward: "scaled" returns
    2 A^T G, "transposed" returns A G."""
    if fault not in (None, "scaled", "transposed"):
        raise ValueError(fault)
    h = x
    for i, p in enumerate(params):
        xw = plain.mm(h, p["w"], precision)
        at = graph.at
        if i == 0 and fault == "scaled":
            xw = plain.GradScale.apply(xw, 2.0)
        elif i == 0 and fault == "transposed":
            at = graph.a
        h = torch.relu(plain.SparseAggregate.apply(xw, graph.a, at))
    return h
