"""L-hop subgraph extraction for request-time GNN inference (host numpy).

An L-layer GNN's output at a vertex v depends only on v's L-hop
*in*-neighbourhood.  Serving therefore never runs the model over the full
graph per request: given the requested seed vertices we walk the reversed
edges L times, collect the frontier closure, and emit a relabelled
`COOGraph` over just those vertices.  Running the same L layers over the
extracted subgraph reproduces the full-graph outputs at the seeds exactly
(tests/test_graphs.py::test_subgraph_inference_matches_full_graph).

Exactness argument: let V_l be the set of vertices within l reverse hops
of the seeds (V_0 = seeds).  After layer 1 the hidden state of a vertex is
correct iff all of its in-edges are present; that holds for every vertex
in V_{L-1}, because their in-neighbours all lie in V_L.  Inductively after
layer l the states of V_{L-l} are correct, so after L layers the seeds
(V_0) are exact.  We therefore keep every edge whose destination lies in
V_{L-1} (sources are then automatically inside V_L) and drop the rest —
edges into the outermost frontier cannot influence the seeds.

Optional `fanout` caps the in-degree expansion per hop (GraphSAGE-style
neighbour sampling) for latency-bounded serving; sampled extraction is
approximate by construction.  Sampling draws from a per-call
`np.random.default_rng(seed)`, and the seeds keep their first-occurrence
order, so a subgraph equals `repro.graphs.subgraph`'s for the same
arguments, array for array.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np

from repro_torch.graphs.format import COOGraph, coo_to_csr


@dataclasses.dataclass(frozen=True)
class Subgraph:
    """An extracted L-hop neighbourhood, relabelled to local vertex ids.

    `vertices[local_id] = global_id`; the first `num_seeds` local ids are
    the requested seeds in request order, so model outputs for the seeds
    are simply `y[:num_seeds]`.
    """
    graph: COOGraph           # local-id edge list (val carried over)
    vertices: np.ndarray      # (n_local,) int32 — local -> global
    num_seeds: int

    @property
    def seed_local_ids(self) -> np.ndarray:
        return np.arange(self.num_seeds, dtype=np.int32)


class SubgraphExtractor:
    """Repeated-extraction helper owning the dst-major CSR of the full
    graph (built once; the hot path is pure index arithmetic)."""

    def __init__(self, g: COOGraph):
        self.g = g
        self.csr = coo_to_csr(g)          # in-neighbours per dst vertex

    def _edge_positions_all(self, dsts: np.ndarray):
        """CSR positions + dst ids of every in-edge of `dsts` (vectorised
        ragged gather — no Python loop over edges)."""
        indptr = self.csr.indptr
        starts = indptr[dsts]
        take = indptr[dsts + 1] - starts
        total = int(take.sum())
        if total == 0:
            return np.zeros(0, np.int64), np.zeros(0, np.int32)
        offs = np.arange(total) - np.repeat(np.cumsum(take) - take, take)
        return (np.repeat(starts, take) + offs,
                np.repeat(dsts, take).astype(np.int32))

    def _in_edges(self, dsts: np.ndarray, fanout: Optional[int],
                  rng: Optional[np.random.Generator]):
        """In-edges of `dsts` as (src, dst, val, rel).  With `fanout`,
        vertices whose in-degree exceeds it get `fanout` neighbours
        sampled with replacement; everyone else keeps the exact
        neighbourhood.  `rel` is None on untyped graphs."""
        indptr, indices, val = self.csr.indptr, self.csr.indices, self.csr.val
        rel = self.csr.rel
        if fanout is None:
            pos, rep_dst = self._edge_positions_all(dsts)
        else:
            deg = indptr[dsts + 1] - indptr[dsts]
            big = dsts[deg > fanout]
            pos, rep_dst = self._edge_positions_all(dsts[deg <= fanout])
            if big.size:
                rng = rng or np.random.default_rng(0)
                starts = np.repeat(indptr[big], fanout)
                deg_rep = np.repeat((indptr[big + 1] - indptr[big]), fanout)
                offs = (rng.random(big.size * fanout) * deg_rep).astype(
                    np.int64)
                pos = np.concatenate([pos, starts + offs])
                rep_dst = np.concatenate(
                    [rep_dst, np.repeat(big, fanout).astype(np.int32)])
        if pos.size == 0:
            z = np.zeros(0, np.int32)
            return z, z, np.zeros(0, np.float32), (
                z if rel is not None else None)
        return (indices[pos].astype(np.int32), rep_dst, val[pos],
                rel[pos].astype(np.int32) if rel is not None else None)

    def extract(self, seeds: Sequence[int], num_hops: int,
                fanout: Optional[int] = None,
                seed: int = 0) -> Subgraph:
        """Extract the `num_hops`-hop in-neighbourhood of `seeds`.

        Deduplicates the seed list (the subgraph's leading vertices are
        the *unique* seeds in first-occurrence order — callers that allow
        duplicate requests should map through `vertices`).
        """
        seeds = np.asarray(seeds, np.int32)
        uniq, first = np.unique(seeds, return_index=True)
        seeds = seeds[np.sort(first)]                    # stable unique
        rng = np.random.default_rng(seed) if fanout is not None else None

        visited = np.zeros(self.g.num_vertices, bool)
        visited[seeds] = True
        order = [seeds]                                  # BFS level sets
        edges_src, edges_dst, edges_val, edges_rel = [], [], [], []
        frontier = seeds
        for _ in range(num_hops):
            if frontier.size == 0:
                break
            s, d, v, r = self._in_edges(frontier, fanout, rng)
            edges_src.append(s)
            edges_dst.append(d)
            edges_val.append(v)
            if r is not None:
                edges_rel.append(r)
            new = np.unique(s[~visited[s]])
            visited[new] = True
            order.append(new)
            frontier = new

        vertices = np.concatenate(order).astype(np.int32)
        local = np.full(self.g.num_vertices, -1, np.int32)
        local[vertices] = np.arange(vertices.size, dtype=np.int32)
        src = (local[np.concatenate(edges_src)] if edges_src
               else np.zeros(0, np.int32))
        dst = (local[np.concatenate(edges_dst)] if edges_dst
               else np.zeros(0, np.int32))
        val = (np.concatenate(edges_val) if edges_val
               else np.zeros(0, np.float32))
        typed = self.csr.rel is not None
        rel = (np.concatenate(edges_rel) if edges_rel
               else np.zeros(0, np.int32)) if typed else None
        sub = COOGraph(int(vertices.size), src, dst,
                       val if self.g.val is not None else None,
                       rel=rel,
                       num_relations=(self.csr.num_relations
                                      if typed else 1))
        return Subgraph(sub, vertices, int(seeds.size))


def extract_khop(g: COOGraph, seeds: Sequence[int], num_hops: int,
                 fanout: Optional[int] = None, seed: int = 0) -> Subgraph:
    """One-shot convenience wrapper (builds the CSR each call — serving
    uses a persistent `SubgraphExtractor`)."""
    return SubgraphExtractor(g).extract(seeds, num_hops, fanout, seed)
