"""Grid partitioning and tile stores (paper S5.3, Table 3, Eq. 8).

What the inference path needs from `repro.graphs.partition`: the
adaptive schedule order and its I/O cost, the host-side `EdgeTileStore`
and its packed (CSR-within-tile) form, and the pow2 nnz buckets the
packed groups pad to.  Field for field the same arrays as the reference.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np

from repro_torch.graphs.format import COOGraph


# Table 3 of the paper (units: interval-loads of property vectors):
#   column-major: read (Q^2 - Q + 1) F + Q H,  write Q H
#   row-major:    read Q F + (Q^2 - Q + 1) H,  write Q^2 H
def io_cost(order: str, q: int, f: int, h: int) -> Tuple[float, float]:
    if order == "column":
        read = (q * q - q + 1) * f + q * h
        write = q * h
    elif order == "row":
        read = q * f + (q * q - q + 1) * h
        write = q * q * h
    else:
        raise ValueError(order)
    return float(read), float(write)


def tile_schedule_order(f: int, h: int) -> str:
    """Adaptive scheduling (Eq. 8): column-major wins iff F < 2H."""
    return "column" if f < 2 * h else "row"


def pow2_bucket(n: int, floor: int = 8) -> int:
    """Smallest power of two >= max(n, floor) — the nnz bucket a packed
    tile is padded to."""
    n = max(int(n), int(floor), 1)
    return 1 << (n - 1).bit_length()


@dataclasses.dataclass(frozen=True)
class EdgeTileStore:
    """The Q x Q edge-tile grid kept in host memory: per-tile edge lists
    in one flat edge array grouped by tile (`edge_ptr`), indexed by
    destination row and source column."""
    num_vertices: int
    tile: int
    q: int
    block_row: np.ndarray           # (nnzb,) int32 dst interval
    block_col: np.ndarray           # (nnzb,) int32 src interval
    edge_ptr: np.ndarray            # (nnzb+1,) int64 — edges per tile
    edge_li: np.ndarray             # (E,) int32 dst offset within tile
    edge_lj: np.ndarray             # (E,) int32 src offset within tile
    edge_w: np.ndarray              # (E,) float32 edge weight
    in_counts: np.ndarray           # (N,) float32 in-edge counts
    _row_ptr: np.ndarray            # (q+1,) indices into _row_order
    _row_order: np.ndarray          # tiles sorted (row, col)
    _col_ptr: np.ndarray            # (q+1,) indices into _col_order
    _col_order: np.ndarray          # tiles sorted (col, row)
    block_rel: Optional[np.ndarray] = None   # (nnzb,) int32 tile edge type
    num_relations: int = 1

    @property
    def nnzb(self) -> int:
        return int(self.block_row.shape[0])

    @property
    def padded_vertices(self) -> int:
        return self.q * self.tile


@dataclasses.dataclass(frozen=True)
class PackedTileStore:
    """The tile grid as packed per-tile `(row_local, col_local, val)`
    entries, multi-edges merged by summation, sorted (row, col) within
    each tile.  Staged groups pad to a pow2 nnz bucket with (0, 0, 0.0)
    entries: a no-op for sum, masked out of max by val != 0."""
    num_vertices: int
    tile: int
    q: int
    block_row: np.ndarray           # (nnzb,) int32 dst interval
    block_col: np.ndarray           # (nnzb,) int32 src interval
    entry_ptr: np.ndarray           # (nnzb+1,) int64 — merged entries/tile
    row_local: np.ndarray           # (M,) int32 dst offset within tile
    col_local: np.ndarray           # (M,) int32 src offset within tile
    val: np.ndarray                 # (M,) float32 merged edge weight
    in_counts: np.ndarray           # (N,) float32 in-edge counts
    block_rel: Optional[np.ndarray] = None   # (nnzb,) int32 tile edge type
    num_relations: int = 1

    @property
    def nnzb(self) -> int:
        return int(self.block_row.shape[0])

    @property
    def nnz(self) -> int:
        return int(self.row_local.shape[0])

    @property
    def padded_vertices(self) -> int:
        return self.q * self.tile

    def tile_nnz(self) -> np.ndarray:
        return np.diff(self.entry_ptr)

    def packed_slots(self, floor: int = 8) -> int:
        """Total padded entry slots if every tile is staged at its own
        pow2 bucket — the denominator of `fill_factor`."""
        nnz = self.tile_nnz()
        if nnz.size == 0:
            return 0
        buckets = np.maximum(np.maximum(nnz, floor), 1)
        exp = np.ceil(np.log2(buckets)).astype(np.int64)
        return int((1 << exp).sum())

    def fill_factor(self, floor: int = 8) -> float:
        slots = self.packed_slots(floor)
        return float(self.nnz) / slots if slots else 1.0

    def dense_fill(self) -> float:
        if self.nnzb == 0:
            return 1.0
        return float(self.nnz) / (self.nnzb * self.tile * self.tile)

    def pack(self, tiles, width: int, bucket: int
             ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Stage the given tiles as `(rows, cols, vals)` arrays of shape
        `(width, bucket)`; a tile id of -1 stays all padding."""
        tiles = np.asarray(tiles, np.int64)
        rows = np.zeros((width, bucket), np.int32)
        cols = np.zeros((width, bucket), np.int32)
        vals = np.zeros((width, bucket), np.float32)
        for c, k in enumerate(tiles):
            if k < 0:
                continue
            lo, hi = int(self.entry_ptr[k]), int(self.entry_ptr[k + 1])
            m = hi - lo
            rows[c, :m] = self.row_local[lo:hi]
            cols[c, :m] = self.col_local[lo:hi]
            vals[c, :m] = self.val[lo:hi]
        return rows, cols, vals


def merge_by_key(key: np.ndarray, w: np.ndarray
                 ) -> Tuple[np.ndarray, np.ndarray]:
    """Merge duplicate keys by summing their weights (float64
    accumulation).  Returns (sorted unique keys, float32 weights)."""
    order = np.argsort(key, kind="stable")
    ks = key[order]
    first = np.ones(ks.size, bool)
    if ks.size:
        first[1:] = ks[1:] != ks[:-1]
    seg = np.cumsum(first) - 1
    val = np.zeros(int(seg[-1]) + 1 if ks.size else 0, np.float64)
    np.add.at(val, seg, w[order].astype(np.float64))
    return ks[first], val.astype(np.float32)


def pack_tile_store(store: EdgeTileStore) -> PackedTileStore:
    """Derive the packed form: one argsort over (tile, row, col) merges
    multi-edges by summation."""
    t = store.tile
    counts = np.diff(store.edge_ptr)
    tile_of = np.repeat(np.arange(store.nnzb, dtype=np.int64), counts)
    key = ((tile_of * t + store.edge_li.astype(np.int64)) * t
           + store.edge_lj.astype(np.int64))
    ku, val = merge_by_key(key, store.edge_w)
    entry_tile = ku // (t * t)
    entry_ptr = np.searchsorted(entry_tile,
                                np.arange(store.nnzb + 1)).astype(np.int64)
    return PackedTileStore(
        store.num_vertices, t, store.q, store.block_row, store.block_col,
        entry_ptr,
        ((ku // t) % t).astype(np.int32),
        (ku % t).astype(np.int32),
        val,
        store.in_counts,
        block_rel=store.block_rel, num_relations=store.num_relations)


def _tile_index(keys: np.ndarray, q: int) -> Tuple[np.ndarray, np.ndarray]:
    order = np.argsort(keys, kind="stable").astype(np.int64)
    groups = keys[order] // q
    ptr = np.searchsorted(groups, np.arange(q + 1))
    return ptr.astype(np.int64), order


def build_tile_store(g: COOGraph, tile: int) -> EdgeTileStore:
    """Partition a COO graph into the host tile store: one argsort of the
    edge list by tile key.  Typed graphs split a grid cell into one tile
    per edge type present."""
    t = tile
    q = -(-g.num_vertices // t)
    bi = (g.dst // t).astype(np.int64)
    bj = (g.src // t).astype(np.int64)
    typed = g.rel is not None and g.num_relations > 1
    r = int(g.num_relations) if typed else 1
    key = (bi * q + bj) * r
    if typed:
        key = key + g.rel.astype(np.int64)
    order = np.argsort(key, kind="stable")
    key_sorted = key[order]
    uniq, ptr_starts = np.unique(key_sorted, return_index=True)
    edge_ptr = np.concatenate([ptr_starts,
                               [key_sorted.size]]).astype(np.int64)
    cell = uniq // r
    block_row = (cell // q).astype(np.int32)
    block_col = (cell % q).astype(np.int32)
    block_rel = (uniq % r).astype(np.int32) if typed else None
    row = block_row.astype(np.int64)
    col = block_col.astype(np.int64)
    row_ptr, row_order = _tile_index(row * q + col, q)
    col_ptr, col_order = _tile_index(col * q + row, q)
    counts = np.bincount(g.dst, minlength=g.num_vertices).astype(np.float32)
    return EdgeTileStore(
        g.num_vertices, t, q, block_row, block_col, edge_ptr,
        (g.dst[order] % t).astype(np.int32),
        (g.src[order] % t).astype(np.int32),
        g.weights()[order].astype(np.float32),
        counts, row_ptr, row_order, col_ptr, col_order,
        block_rel=block_rel, num_relations=r)
