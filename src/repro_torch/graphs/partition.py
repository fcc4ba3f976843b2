"""Grid partitioning and tile stores (paper S5.3, Table 3, Eq. 8).

The port's copy of `repro.graphs.partition`: the grid partition and the
tile schedule with its S-shape (`grid_partition`, `schedule_tiles`), the
adaptive schedule order and its I/O cost (closed form and the replay
`simulated_io_bytes`), the host-side `EdgeTileStore` (with the row /
column tile indexes and `densify` the streamed executor walks) and its
packed (CSR-within-tile) form, staged fp32 or int8 (`pack_quantized`),
their A^T views (`transpose_*`, the backward's carriers), the pow2 nnz
buckets the packed groups pad to, and `chunk_tile_row`, the S-shape
chunking of one interval's tiles.  Field for field the same arrays as
the reference.  `transpose_blocks` has no
counterpart there: it lays out the dense blocked carrier of A^T as
`prepare_blocks` lays out A's.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.distributed.compression import quantize_int8_np
from repro_torch.graphs.format import COOGraph


@dataclasses.dataclass(frozen=True)
class GridPartition:
    q: int
    interval: int                     # vertices per interval (last padded)
    shard_edges: List[np.ndarray]     # q*q entries: edge ids, key order


def grid_partition(g: COOGraph, q: int) -> GridPartition:
    """The N vertices cut into q intervals; edge ids fall into the q^2
    shards (dst interval, src interval), stably ordered within each."""
    interval = -(-g.num_vertices // q)
    bi = g.dst // interval
    bj = g.src // interval
    key = bi.astype(np.int64) * q + bj
    order = np.argsort(key, kind="stable")
    key_sorted = key[order]
    bounds = np.searchsorted(key_sorted, np.arange(q * q + 1))
    shards = [order[bounds[k]:bounds[k + 1]] for k in range(q * q)]
    return GridPartition(q, interval, shards)


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


def schedule_tiles(q: int, order: str, s_shape: bool = True):
    """(i, j) = (dst interval, src interval) visit order: "column" keeps
    the destination interval stationary (outer loop over i), "row" the
    source interval (outer loop over j); with `s_shape` every other outer
    step walks the inner axis backwards, so the boundary tile is reused
    (Fig. 8)."""
    out = []
    if order == "column":
        for i in range(q):
            cols = (range(q) if (not s_shape or i % 2 == 0)
                    else range(q - 1, -1, -1))
            out.extend((i, j) for j in cols)
    elif order == "row":
        for j in range(q):
            rows = (range(q) if (not s_shape or j % 2 == 0)
                    else range(q - 1, -1, -1))
            out.extend((i, j) for i in rows)
    else:
        raise ValueError(order)
    return out


def simulated_io_bytes(q: int, order: str, f: int, h: int, interval: int,
                       bytes_per_el: int = 4, s_shape: bool = True
                       ) -> Tuple[int, int]:
    """(read, write) bytes of a replay of the tile schedule under the
    paper's accounting (Table 3), S-shape reuse on reads: a new source
    interval reads interval x F, a new destination interval interval x H;
    column order flushes each destination once (Q x H writes), row order
    spills a partial after every tile (Q^2 x H).  With s_shape it equals
    Table 3's closed form."""
    reads = 0
    writes = 0
    cur_src = None
    cur_dst = None
    for (i, j) in schedule_tiles(q, order, s_shape):
        if j != cur_src:
            reads += interval * f
            cur_src = j
        if i != cur_dst:
            reads += interval * h
            cur_dst = i
        if order == "row":
            writes += interval * h
    if order == "column":
        writes = q * interval * h
    return reads * bytes_per_el, writes * bytes_per_el


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

    def nbytes(self) -> int:
        rel = self.block_rel.nbytes if self.block_rel is not None else 0
        return int(self.edge_li.nbytes + self.edge_lj.nbytes
                   + self.edge_w.nbytes + self.edge_ptr.nbytes
                   + self.block_row.nbytes + self.block_col.nbytes + rel)

    def row_tiles(self, i: int) -> np.ndarray:
        """The tiles of destination interval i, by source interval."""
        return self._row_order[self._row_ptr[i]:self._row_ptr[i + 1]]

    def col_tiles(self, j: int) -> np.ndarray:
        """The tiles of source interval j, by destination interval."""
        return self._col_order[self._col_ptr[j]:self._col_ptr[j + 1]]

    def densify(self, tiles, out: np.ndarray) -> np.ndarray:
        """Scatter the given tiles' edge lists into `out` (k, T, T), one
        dense tile each (zeroed here; multi-edges add up)."""
        out[:len(tiles)] = 0.0
        for c, k in enumerate(tiles):
            lo, hi = self.edge_ptr[k], self.edge_ptr[k + 1]
            np.add.at(out[c], (self.edge_li[lo:hi], self.edge_lj[lo:hi]),
                      self.edge_w[lo:hi])
        return out


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

    def bucket_of(self, tiles, floor: int = 8) -> int:
        """The pow2 nnz bucket a staged group of tiles pads to."""
        tiles = np.asarray(tiles, np.int64)
        if tiles.size == 0:
            return pow2_bucket(0, floor)
        nnz = (self.entry_ptr[tiles + 1] - self.entry_ptr[tiles])
        return pow2_bucket(int(nnz.max()), floor)

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

    def nbytes(self) -> int:
        rel = self.block_rel.nbytes if self.block_rel is not None else 0
        return int(self.row_local.nbytes + self.col_local.nbytes
                   + self.val.nbytes + self.entry_ptr.nbytes
                   + self.block_row.nbytes + self.block_col.nbytes + rel)

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

    def pack_quantized(self, tiles, width: int, bucket: int, quantizer=None
                       ) -> Tuple[np.ndarray, np.ndarray, np.ndarray,
                                  np.ndarray]:
        """`pack` with the value plane as int8 and one f32 scale per
        staged tile: (rows, cols, qvals int8, scales (width,) f32).  A
        `StreamingTileQuantizer` feeds each tile's rounding back into the
        next staging of the same entries, through its `quantize_range`
        over this store's flat entry offsets (which `transpose_packed_store`
        keeps).  Padding tiles carry scale 1.0."""
        tiles = np.asarray(tiles, np.int64)
        rows = np.zeros((width, bucket), np.int32)
        cols = np.zeros((width, bucket), np.int32)
        qvals = np.zeros((width, bucket), np.int8)
        scales = np.ones(width, np.float32)
        for c, k in enumerate(tiles):
            if k < 0:
                continue
            lo, hi = int(self.entry_ptr[k]), int(self.entry_ptr[k + 1])
            m = hi - lo
            rows[c, :m] = self.row_local[lo:hi]
            cols[c, :m] = self.col_local[lo:hi]
            if m == 0:
                continue
            if quantizer is not None:
                q, s = quantizer.quantize_range(self.val[lo:hi], lo, hi)
            else:
                q, s, _ = quantize_int8_np(self.val[lo:hi])
            qvals[c, :m] = q
            scales[c] = s
        return rows, cols, qvals, scales


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


def _out_counts(num_vertices: int, tile: int, block_col: np.ndarray,
                entry_ptr: np.ndarray, col_local: np.ndarray) -> np.ndarray:
    """Per-vertex out-degree recovered from a store's per-tile entry
    lists (the transposed store's `in_counts`)."""
    counts = np.diff(entry_ptr)
    tile_of = np.repeat(np.arange(block_col.shape[0], dtype=np.int64),
                        counts)
    gsrc = block_col[tile_of].astype(np.int64) * tile + col_local
    return np.bincount(gsrc[gsrc < num_vertices],
                       minlength=num_vertices).astype(np.float32)


def transpose_tile_store(store: EdgeTileStore) -> EdgeTileStore:
    """The A^T view of a tile store, sharing every edge array: source
    and destination swap (`block_row` <-> `block_col`, `edge_li` <->
    `edge_lj`, the row and column tile indexes with them); only
    `in_counts` is recomputed, as the out-degree."""
    return EdgeTileStore(
        store.num_vertices, store.tile, store.q,
        store.block_col, store.block_row, store.edge_ptr,
        store.edge_lj, store.edge_li, store.edge_w,
        _out_counts(store.num_vertices, store.tile, store.block_col,
                    store.edge_ptr, store.edge_lj),
        store._col_ptr, store._col_order, store._row_ptr,
        store._row_order,
        block_rel=store.block_rel, num_relations=store.num_relations)


def transpose_packed_store(ps: PackedTileStore) -> PackedTileStore:
    """The A^T view of a packed store, sharing every entry array: tiles
    keep their indexing, `row_local` <-> `col_local` swap, so the
    entries of a tile come in (col, row) order."""
    return PackedTileStore(
        ps.num_vertices, ps.tile, ps.q,
        ps.block_col, ps.block_row, ps.entry_ptr,
        ps.col_local, ps.row_local, ps.val,
        _out_counts(ps.num_vertices, ps.tile, ps.block_col,
                    ps.entry_ptr, ps.col_local),
        block_rel=ps.block_rel, num_relations=ps.num_relations)


def transpose_block_index(block_row: np.ndarray, block_col: np.ndarray,
                          q: int) -> Tuple[np.ndarray, np.ndarray,
                                           np.ndarray]:
    """The tile order of the transposed dense carrier, as
    `prepare_blocks` lays it out for A^T: the tiles' roles swap, a pad
    tile (i, i) is appended for every interval that is no tile's source,
    and one stable argsort orders them by their new destination.
    Returns (`tile_of`, new `block_row`, new `block_col`): `tile_of[k]`
    is the forward tile that transposed tile k comes from, -1 for a pad."""
    present = np.zeros(q, bool)
    present[block_col] = True
    missing = np.nonzero(~present)[0].astype(np.int32)
    tile_of = np.concatenate([np.arange(block_row.size, dtype=np.int64),
                              np.full(missing.size, -1, np.int64)])
    new_row = np.concatenate([block_col, missing])
    new_col = np.concatenate([block_row, missing])
    order = np.argsort(new_row, kind="stable")
    return (tile_of[order], new_row[order].astype(np.int32),
            new_col[order].astype(np.int32))


def transpose_blocks(blocks: np.ndarray, block_row: np.ndarray,
                     block_col: np.ndarray, q: int
                     ) -> Tuple[np.ndarray, np.ndarray, np.ndarray,
                                np.ndarray]:
    """The dense blocked carrier of A^T: each tile becomes A_k^T, in the
    order of `transpose_block_index` (pad tiles are zero).  Returns
    (blocks, block_row, block_col, tile_of)."""
    tile_of, brow, bcol = transpose_block_index(block_row, block_col, q)
    out = np.zeros((tile_of.size,) + blocks.shape[1:], blocks.dtype)
    real = tile_of >= 0
    out[real] = blocks[tile_of[real]].transpose(0, 2, 1)
    return out, brow, bcol, tile_of


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


def chunk_tile_row(tiles: Sequence[int], chunk: int,
                   snake: bool = False) -> List[np.ndarray]:
    """Split one interval's tile list into chunks of `chunk` tiles,
    reversed first when `snake` (the S-shape walk of Fig. 8: the next
    interval's sweep starts where this one ended, so the boundary source
    interval is still resident)."""
    tiles = np.asarray(tiles, np.int64)
    if snake:
        tiles = tiles[::-1]
    if tiles.size == 0:
        return []
    return [tiles[k:k + chunk] for k in range(0, tiles.size, chunk)]
