"""The R-MAT stand-in graph, made on the device.

A copy of the rule of `repro_torch/graphs/generate.py::rmat_graph`
(Chakrabarti et al. 2004), kept here so that a change to the program
cannot change the benchmark's graphs: each of ceil(log2 N) levels picks
a quadrant per edge with probabilities (a, b, c, 1 - a - b - c); the
lower half of the rows for quadrants c and d, the right half of the
columns for b and d; ids are then taken mod N, and a relation is drawn
uniformly per edge where the dataset has relations.  The draws come from
one `torch.Generator` on the given device, in chunks of a fixed size, so
one seed gives one graph on one kind of device (not the numpy stream of
the program's generator).
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

CHUNK = 1 << 23        # edges drawn per round: fixed, so the graph is too


def levels_for(num_vertices: int) -> int:
    """The smallest L with 2**L >= num_vertices."""
    return max(0, int(num_vertices - 1).bit_length())


def rmat_edges(num_vertices: int, num_edges: int, seed: int,
               device: torch.device, a: float = 0.57, b: float = 0.19,
               c: float = 0.19, num_relations: int = 1
               ) -> Tuple[torch.Tensor, torch.Tensor, Optional[torch.Tensor]]:
    """(src, dst, rel) as int32 tensors on `device`; rel is None for an
    untyped graph."""
    gen = torch.Generator(device=device).manual_seed(int(seed))
    levels = levels_for(num_vertices)
    cdf = (a, a + b, a + b + c)
    src = torch.empty(num_edges, dtype=torch.int32, device=device)
    dst = torch.empty(num_edges, dtype=torch.int32, device=device)
    rel = (torch.empty(num_edges, dtype=torch.int32, device=device)
           if num_relations > 1 else None)
    for lo in range(0, num_edges, CHUNK):
        m = min(CHUNK, num_edges - lo)
        s = torch.zeros(m, dtype=torch.int32, device=device)
        d = torch.zeros(m, dtype=torch.int32, device=device)
        for _ in range(levels):
            r = torch.rand(m, generator=gen, device=device)
            quad = ((r > cdf[0]).to(torch.int32) + (r > cdf[1]).to(torch.int32)
                    + (r > cdf[2]).to(torch.int32))
            s = s * 2 + (quad >= 2).to(torch.int32)
            d = d * 2 + (quad % 2)
        src[lo:lo + m] = s % num_vertices
        dst[lo:lo + m] = d % num_vertices
        if rel is not None:
            rel[lo:lo + m] = torch.randint(
                0, num_relations, (m,), generator=gen, device=device,
                dtype=torch.int32)
    return src, dst, rel


def config_edges(cfg, device: torch.device):
    """The configuration's graph: its `graph` block names the sizes, the
    R-MAT probabilities and the graph's own seed.  Where it states
    `inverse_edges` (R-GCN's datasets: Schlichtkrull et al. 2018, S2.1),
    `triples` typed edges are drawn over `base_relations` and each is
    added again reversed under its own inverse relation, r + R, so the
    graph has 2 x `triples` edges over `relations` = 2 R; otherwise
    `edges` edges are drawn over `relations`."""
    g = cfg["graph"]
    if not g.get("inverse_edges"):
        return rmat_edges(g["vertices"], g["edges"], g["graph_seed"], device,
                          *g["rmat_abc"], num_relations=g.get("relations", 1))
    base = g["base_relations"]
    if g["relations"] != 2 * base:
        raise ValueError("an inverse-edge graph has 2 x base_relations")
    src, dst, rel = rmat_edges(g["vertices"], g["triples"], g["graph_seed"],
                               device, *g["rmat_abc"], num_relations=base)
    return (torch.cat([src, dst]), torch.cat([dst, src]),
            torch.cat([rel, rel + base]))
