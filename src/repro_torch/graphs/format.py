"""Graph storage formats (numpy, host-side).

The paper stores the input graph as a COO edge list (src, dst, val) and
converts it with a hardware "format converter".  Here the converter is
host preprocessing: COO -> CSR (the dst-major neighbour lists subgraph
extraction walks) and COO -> BlockedAdjacency, the dense T x T tiles
the `rer_spmm` and `fused_engn` kernels consume.  The arrays and their
order are those of `repro.graphs.format`, field for field.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from repro_torch.tracing import stage


@dataclasses.dataclass(frozen=True)
class COOGraph:
    """Edge-centric coordinate-list graph, the paper's canonical input:
    (src, dst, val) edges, an optional relation id per edge."""
    num_vertices: int
    src: np.ndarray          # (E,) int32
    dst: np.ndarray          # (E,) int32
    val: Optional[np.ndarray] = None   # (E,) float32 edge weight
    rel: Optional[np.ndarray] = None   # (E,) int32 relation type (R-GCN)
    num_relations: int = 1

    @property
    def num_edges(self) -> int:
        return int(self.src.shape[0])

    def weights(self) -> np.ndarray:
        if self.val is None:
            return np.ones(self.num_edges, dtype=np.float32)
        return self.val

    def out_degrees(self) -> np.ndarray:
        return np.bincount(self.src, minlength=self.num_vertices).astype(np.int32)

    def in_degrees(self) -> np.ndarray:
        return np.bincount(self.dst, minlength=self.num_vertices).astype(np.int32)

    def degrees(self) -> np.ndarray:
        return self.out_degrees() + self.in_degrees()

    def with_self_loops(self) -> "COOGraph":
        """A~ = A + I_N (GCN Eq. 1)."""
        loops = np.arange(self.num_vertices, dtype=np.int32)
        src = np.concatenate([self.src, loops])
        dst = np.concatenate([self.dst, loops])
        val = None
        if self.val is not None:
            val = np.concatenate([self.val, np.ones(self.num_vertices, np.float32)])
        rel = None
        if self.rel is not None:
            rel = np.concatenate([self.rel, np.zeros(self.num_vertices, np.int32)])
        return COOGraph(self.num_vertices, src.astype(np.int32), dst.astype(np.int32),
                        val, rel, self.num_relations)

    def gcn_normalized(self) -> "COOGraph":
        """Edge weights D~^-1/2 A~ D~^-1/2 (GCN Eq. 1), computed host-side
        (the `graph.normalise` stage)."""
        with stage("graph.normalise"):
            g = self.with_self_loops()
            deg = np.bincount(g.dst, weights=np.ones(g.num_edges),
                              minlength=g.num_vertices)
            dinv = 1.0 / np.sqrt(np.maximum(deg, 1.0))
            val = (dinv[g.src] * dinv[g.dst]).astype(np.float32)
            return COOGraph(g.num_vertices, g.src, g.dst, val, g.rel,
                            g.num_relations)


@dataclasses.dataclass(frozen=True)
class CSRGraph:
    """Destination-major CSR: for each dst vertex, its in-neighbours."""
    num_vertices: int
    indptr: np.ndarray    # (N+1,) int64
    indices: np.ndarray   # (E,) int32 — source vertex ids
    val: np.ndarray       # (E,) float32
    rel: Optional[np.ndarray] = None   # (E,) int32 edge types, if typed
    num_relations: int = 1


def coo_to_csr(g: COOGraph) -> CSRGraph:
    order = np.argsort(g.dst, kind="stable")
    dst = g.dst[order]
    indices = g.src[order].astype(np.int32)
    val = g.weights()[order]
    rel = g.rel[order].astype(np.int32) if g.rel is not None else None
    indptr = np.zeros(g.num_vertices + 1, np.int64)
    np.add.at(indptr, dst + 1, 1)
    indptr = np.cumsum(indptr)
    return CSRGraph(g.num_vertices, indptr, indices, val,
                    rel=rel, num_relations=int(g.num_relations))


@dataclasses.dataclass(frozen=True)
class BlockedAdjacency:
    """Block-sparse tiled adjacency.

    Vertices are grid-partitioned into Q intervals of size T (padded);
    only non-empty T x T tiles are materialised, as a flat (nnzb, T, T)
    tensor plus (nnzb,) block-row/col indices.

    blocks[k][i, j] = weight of edge (src = col_block[k]*T + j,
                                      dst = row_block[k]*T + i).
    """
    num_vertices: int
    tile: int                       # T
    q: int                          # number of intervals
    blocks: np.ndarray              # (nnzb, T, T) float32
    block_row: np.ndarray           # (nnzb,) int32 — dst interval
    block_col: np.ndarray           # (nnzb,) int32 — src interval

    @property
    def nnzb(self) -> int:
        return int(self.blocks.shape[0])

    @property
    def padded_vertices(self) -> int:
        return self.q * self.tile


def coo_to_blocked(g: COOGraph, tile: int, order: str = "column") -> BlockedAdjacency:
    """Grid-partition a COO graph into dense T x T tiles, visited in
    `order`: "column" (dst-stationary), "row" (src-stationary) or "s"
    (S-shape snake over columns, paper Fig. 8)."""
    t = tile
    q = -(-g.num_vertices // t)  # ceil
    bi = (g.dst // t).astype(np.int64)
    bj = (g.src // t).astype(np.int64)
    key = bi * q + bj
    uniq, inv = np.unique(key, return_inverse=True)
    nnzb = uniq.shape[0]
    blocks = np.zeros((nnzb, t, t), np.float32)
    li = (g.dst % t).astype(np.int64)
    lj = (g.src % t).astype(np.int64)
    np.add.at(blocks, (inv, li, lj), g.weights())
    block_row = (uniq // q).astype(np.int32)
    block_col = (uniq % q).astype(np.int32)
    if order == "column":
        sort = np.lexsort((block_col, block_row))      # dst outer, src inner
    elif order == "row":
        sort = np.lexsort((block_row, block_col))      # src outer, dst inner
    elif order == "s":
        col_key = np.where(block_row % 2 == 0, block_col, q - 1 - block_col)
        sort = np.lexsort((col_key, block_row))
    else:
        raise ValueError(f"unknown order {order!r}")
    return BlockedAdjacency(g.num_vertices, t, q, blocks[sort],
                            block_row[sort], block_col[sort])
