"""Dynamic-graph support: an edge insert/delete log with epoch
snapshots, and delta-merges of the streaming tile stores.

The paper's accelerator assumes a static graph; real serving graphs
grow.  `UpdateLog` accumulates edge inserts and deletes against a base
`COOGraph` and compacts them into an `EpochSnapshot` on demand.  The
snapshot's epoch graph has a *canonical edge order* — surviving base
edges in their original order, then inserts in insertion order — chosen
so the incremental store merges below reproduce `build_tile_store` /
`pack_tile_store` of the epoch graph **bitwise**:

  * `build_tile_store` stable-sorts edges by tile key, so each tile's
    edge list is the epoch-order subsequence that falls in the tile.
    Compacting the old store's per-tile lists with a keep mask keeps
    surviving base edges in base order; appending the (stable-sorted)
    inserts after them reproduces exactly that subsequence.
  * tile keys are lexicographic in (block_row, block_col, rel) for any
    valid grid width q, so when the graph grows vertices (q grows) the
    old tiles keep their relative order under the new keys and a sorted
    merge suffices — no re-sort of surviving edges.
  * `pack_tile_store` merges per tile independently (stable sort +
    ordered float64 accumulation), so tiles untouched by the delta keep
    bitwise-identical packed entries and only touched tiles re-merge.

Deletes are tombstones: logged immediately, applied (compacted) at
snapshot time.  A delete removes *all* edges at its (src, dst[, rel])
coordinate — multi-edges included — matching the merged-weight "0 means
no edge" convention of the packed stores.

Host numpy, copied from `repro.graphs.updates`: the same log gives the
same snapshot and the same merged stores, array for array.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import numpy as np

from repro_torch.graphs.format import COOGraph
from repro_torch.graphs.partition import (EdgeTileStore, PackedTileStore,
                                    _tile_index, merge_by_key)


def _as_i32(a) -> np.ndarray:
    return np.atleast_1d(np.asarray(a, np.int32))


def _coord_key(src: np.ndarray, dst: np.ndarray, rel: Optional[np.ndarray],
               n: int, r: int) -> np.ndarray:
    """One int64 per edge coordinate; `n` must bound every vertex id."""
    k = src.astype(np.int64) * n + dst.astype(np.int64)
    if r > 1:
        k = k * r + (rel.astype(np.int64) if rel is not None
                     else np.zeros(k.shape, np.int64))
    return k


def _in_sorted(keys: np.ndarray, sorted_targets: np.ndarray) -> np.ndarray:
    """Boolean membership of `keys` in a sorted target array."""
    if sorted_targets.size == 0:
        return np.zeros(keys.shape, bool)
    pos = np.searchsorted(sorted_targets, keys)
    pos = np.minimum(pos, sorted_targets.size - 1)
    return sorted_targets[pos] == keys


def _group_positions(starts: np.ndarray, counts: np.ndarray) -> np.ndarray:
    """Flat destination indices for groups laid out back to back:
    group g occupies starts[g] .. starts[g] + counts[g)."""
    total = int(counts.sum())
    if total == 0:
        return np.zeros(0, np.int64)
    firsts = np.cumsum(counts) - counts          # exclusive prefix
    intra = np.arange(total, dtype=np.int64) - np.repeat(firsts, counts)
    return np.repeat(starts.astype(np.int64), counts) + intra


@dataclasses.dataclass(frozen=True)
class UpdateBatch:
    """The compacted delta between two epochs, in epoch-graph order.

    keep_mask: (E_base,) bool over the *previous* epoch's edges, in
               that graph's edge order — False where a tombstone landed.
    del_*:     unique coordinates of the deleted base edges (what the
               store merges match against — no base permutation needed).
    ins_*:     surviving inserts, in insertion order (deletes logged
               after an insert cancel it before it ever materialises).
    """
    keep_mask: np.ndarray
    del_src: np.ndarray
    del_dst: np.ndarray
    del_rel: Optional[np.ndarray]
    ins_src: np.ndarray
    ins_dst: np.ndarray
    ins_val: np.ndarray
    ins_rel: Optional[np.ndarray]

    @property
    def num_deleted(self) -> int:
        return int((~self.keep_mask).sum())

    @property
    def num_inserted(self) -> int:
        return int(self.ins_src.shape[0])


@dataclasses.dataclass(frozen=True)
class EpochSnapshot:
    """One epoch boundary: the full epoch graph (canonical edge order),
    the delta that produced it, and the vertices whose in-neighbourhood
    changed (dst endpoints of every inserted or deleted edge — the seed
    set for serving-cache invalidation)."""
    epoch: int
    graph: COOGraph
    batch: UpdateBatch
    touched_dst: np.ndarray    # unique, sorted int32
    touched_src: np.ndarray    # unique, sorted int32


class UpdateLog:
    """Edge insert/delete log over a base `COOGraph`.

    Ops are applied in log order at `snapshot()`: a delete removes all
    matching base edges *and* any matching earlier pending inserts; an
    insert logged after a delete of the same coordinate survives.
    Inserts may name vertices beyond the current vertex count — the
    epoch graph grows to fit them.
    """

    def __init__(self, base: COOGraph):
        self.graph = base
        self.epoch = 0
        self._ops: List[Tuple[str, tuple]] = []

    @property
    def pending(self) -> int:
        return len(self._ops)

    def insert(self, src, dst, val=None, rel=None) -> None:
        src, dst = _as_i32(src), _as_i32(dst)
        if val is None:
            val = np.ones(src.shape[0], np.float32)
        val = np.broadcast_to(np.asarray(val, np.float32),
                              src.shape).astype(np.float32).copy()
        if rel is not None:
            rel = np.broadcast_to(_as_i32(rel), src.shape).copy()
            if int(rel.max(initial=0)) >= self.graph.num_relations:
                raise ValueError(
                    f"relation id {int(rel.max())} out of range for "
                    f"num_relations={self.graph.num_relations}")
        if int(src.min(initial=0)) < 0 or int(dst.min(initial=0)) < 0:
            raise ValueError("negative vertex id")
        self._ops.append(("ins", (src, dst, val, rel)))

    def delete(self, src, dst, rel=None) -> None:
        """Tombstone every edge at (src, dst[, rel]).  With `rel` None
        on a typed graph, all relations at the coordinate die."""
        src, dst = _as_i32(src), _as_i32(dst)
        if rel is not None:
            rel = np.broadcast_to(_as_i32(rel), src.shape).copy()
        self._ops.append(("del", (src, dst, rel)))

    def snapshot(self) -> EpochSnapshot:
        """Compact pending ops into the next epoch.  The log's base
        graph advances to the epoch graph; the returned batch is the
        delta against the *previous* base (what the store merges eat)."""
        g = self.graph
        r = int(g.num_relations)
        typed = r > 1
        # vertex bound across base + every op (inserts may grow n)
        n_new = g.num_vertices
        for _, args in self._ops:
            n_new = max(n_new, int(args[0].max(initial=-1)) + 1,
                        int(args[1].max(initial=-1)) + 1)

        base_key = _coord_key(g.src, g.dst, g.rel, n_new, r)
        keep = np.ones(g.num_edges, bool)
        ins_src: List[np.ndarray] = []
        ins_dst: List[np.ndarray] = []
        ins_val: List[np.ndarray] = []
        ins_rel: List[np.ndarray] = []
        ins_keys: List[np.ndarray] = []

        for kind, args in self._ops:
            if kind == "ins":
                src, dst, val, rel = args
                ins_src.append(src)
                ins_dst.append(dst)
                ins_val.append(val)
                ins_rel.append(rel if rel is not None
                               else np.zeros(src.shape[0], np.int32))
                ins_keys.append(_coord_key(src, dst, rel, n_new, r))
                continue
            src, dst, rel = args
            if typed and rel is None:
                # wildcard delete: expand to every relation id
                src = np.repeat(src, r)
                dst = np.repeat(dst, r)
                rel = np.tile(np.arange(r, dtype=np.int32),
                              args[0].shape[0])
            tgt = np.sort(_coord_key(src, dst, rel, n_new, r))
            if tgt.size == 0:
                continue
            keep &= ~_in_sorted(base_key, tgt)
            for c, k in enumerate(ins_keys):
                alive = ~_in_sorted(k, tgt)
                if alive.all():
                    continue
                ins_src[c] = ins_src[c][alive]
                ins_dst[c] = ins_dst[c][alive]
                ins_val[c] = ins_val[c][alive]
                ins_rel[c] = ins_rel[c][alive]
                ins_keys[c] = k[alive]

        def _cat(parts, dtype):
            return (np.concatenate(parts).astype(dtype) if parts
                    else np.zeros(0, dtype))

        i_src = _cat(ins_src, np.int32)
        i_dst = _cat(ins_dst, np.int32)
        i_val = _cat(ins_val, np.float32)
        i_rel = _cat(ins_rel, np.int32) if typed else None
        kill = ~keep
        d_src = g.src[kill]
        d_dst = g.dst[kill]
        d_rel = g.rel[kill] if (typed and g.rel is not None) else None
        # unique deleted coordinates (multi-edges collapse to one coord)
        if d_src.size:
            dk, first = np.unique(_coord_key(d_src, d_dst, d_rel,
                                             n_new, r),
                                  return_index=True)
            d_src, d_dst = d_src[first], d_dst[first]
            d_rel = d_rel[first] if d_rel is not None else None
        batch = UpdateBatch(keep, d_src.astype(np.int32),
                            d_dst.astype(np.int32), d_rel,
                            i_src, i_dst, i_val, i_rel)

        new_src = np.concatenate([g.src[keep], i_src]).astype(np.int32)
        new_dst = np.concatenate([g.dst[keep], i_dst]).astype(np.int32)
        new_val = np.concatenate([g.weights()[keep],
                                  i_val]).astype(np.float32)
        new_rel = None
        if typed:
            base_rel = (g.rel if g.rel is not None
                        else np.zeros(g.num_edges, np.int32))
            new_rel = np.concatenate([base_rel[keep],
                                      i_rel]).astype(np.int32)
        new_graph = COOGraph(n_new, new_src, new_dst, new_val, new_rel, r)

        touched_dst = np.unique(np.concatenate(
            [g.dst[kill], i_dst]).astype(np.int32))
        touched_src = np.unique(np.concatenate(
            [g.src[kill], i_src]).astype(np.int32))
        self.graph = new_graph
        self.epoch += 1
        self._ops = []
        return EpochSnapshot(self.epoch, new_graph, batch,
                             touched_dst, touched_src)


# ----------------------------------------------------------------------
# Incremental store merges (no full rebuild)
# ----------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class StoreDelta:
    """What one `update_tile_store` call changed, in *new*-store tile
    indices — the packed merge re-packs exactly `touched_tiles` and
    copies every other tile's entries from the old packed store via
    `old_of_new` (old tile index per new tile, -1 for created tiles)."""
    touched_tiles: np.ndarray    # sorted unique int64
    old_of_new: np.ndarray       # (nnzb_new,) int64
    edges_kept: int
    edges_inserted: int
    tiles_dropped: int           # delete-to-empty tiles compacted away


def update_tile_store(store: EdgeTileStore, batch: UpdateBatch,
                      num_vertices: int
                      ) -> Tuple[EdgeTileStore, StoreDelta]:
    """Merge one epoch's delta into an `EdgeTileStore` without a full
    rebuild: O(E) keep-compaction + O(dE log dE) insert sort + an
    O(nnzb) sorted tile merge.  Bitwise-equal to
    `build_tile_store(snapshot.graph, store.tile)` — see the module
    docstring for the order argument.  `num_vertices` is the epoch
    graph's (possibly grown) vertex count; the grid width q grows with
    it while the tile size stays fixed."""
    t = store.tile
    r = int(store.num_relations)
    typed = r > 1
    q_new = -(-num_vertices // t)
    counts_old = np.diff(store.edge_ptr)
    tile_of = np.repeat(np.arange(store.nnzb, dtype=np.int64), counts_old)

    # --- keep mask in store-edge order (match deleted coordinates) ----
    if batch.del_src.size:
        gsrc = (store.block_col[tile_of].astype(np.int64) * t
                + store.edge_lj)
        gdst = (store.block_row[tile_of].astype(np.int64) * t
                + store.edge_li)
        erel = store.block_rel[tile_of] if typed else None
        ekey = _coord_key(gsrc, gdst, erel, num_vertices, r)
        dkey = np.sort(_coord_key(batch.del_src, batch.del_dst,
                                  batch.del_rel, num_vertices, r))
        keep = ~_in_sorted(ekey, dkey)
    else:
        keep = np.ones(tile_of.shape[0], bool)

    kept_per_tile = np.bincount(tile_of[keep],
                                minlength=store.nnzb).astype(np.int64)
    alive = kept_per_tile > 0
    alive_idx = np.nonzero(alive)[0]
    k_li = store.edge_li[keep]
    k_lj = store.edge_lj[keep]
    k_w = store.edge_w[keep]
    del_tiles_old = np.unique(tile_of[~keep]) if (~keep).any() \
        else np.zeros(0, np.int64)

    # --- insert edges, stable-sorted by their (new-q) tile key --------
    i_bi = (batch.ins_dst // t).astype(np.int64)
    i_bj = (batch.ins_src // t).astype(np.int64)
    ikey = (i_bi * q_new + i_bj) * r
    if typed and batch.ins_rel is not None:
        ikey = ikey + batch.ins_rel.astype(np.int64)
    iord = np.argsort(ikey, kind="stable")
    ikey_s = ikey[iord]
    i_li = (batch.ins_dst[iord] % t).astype(np.int32)
    i_lj = (batch.ins_src[iord] % t).astype(np.int32)
    i_w = batch.ins_val[iord].astype(np.float32)
    ikey_u, istarts = np.unique(ikey_s, return_index=True)
    icounts = np.diff(np.concatenate([istarts,
                                      [ikey_s.size]])).astype(np.int64)

    # --- sorted merge of surviving old tiles with insert tiles --------
    okey = (store.block_row.astype(np.int64) * q_new
            + store.block_col.astype(np.int64)) * r
    if typed:
        okey = okey + store.block_rel.astype(np.int64)
    okey_a = okey[alive]                       # sorted: old tile order
    merged = np.union1d(okey_a, ikey_u)        # is (bi, bj, rel)-lexic.
    nnzb_new = merged.shape[0]
    pos_a = np.searchsorted(merged, okey_a)
    pos_b = np.searchsorted(merged, ikey_u)
    cnt_a = np.zeros(nnzb_new, np.int64)
    cnt_a[pos_a] = kept_per_tile[alive]
    cnt_b = np.zeros(nnzb_new, np.int64)
    cnt_b[pos_b] = icounts
    edge_ptr = np.zeros(nnzb_new + 1, np.int64)
    np.cumsum(cnt_a + cnt_b, out=edge_ptr[1:])

    e_new = int(edge_ptr[-1])
    li = np.zeros(e_new, np.int32)
    lj = np.zeros(e_new, np.int32)
    w = np.zeros(e_new, np.float32)
    # surviving base edges first within each tile (epoch-graph order)
    dest_a = _group_positions(edge_ptr[pos_a], kept_per_tile[alive])
    li[dest_a], lj[dest_a], w[dest_a] = k_li, k_lj, k_w
    dest_b = _group_positions(edge_ptr[pos_b] + cnt_a[pos_b], icounts)
    li[dest_b], lj[dest_b], w[dest_b] = i_li, i_lj, i_w

    cell = merged // r
    block_row = (cell // q_new).astype(np.int32)
    block_col = (cell % q_new).astype(np.int32)
    block_rel = (merged % r).astype(np.int32) if typed else None
    row_ptr, row_order = _tile_index(
        block_row.astype(np.int64) * q_new + block_col, q_new)
    col_ptr, col_order = _tile_index(
        block_col.astype(np.int64) * q_new + block_row, q_new)

    # --- in-counts: exact integer adjustment --------------------------
    in_counts = np.zeros(num_vertices, np.float32)
    in_counts[:store.num_vertices] = store.in_counts
    if (~keep).any():
        in_counts -= np.bincount(gdst[~keep],
                                 minlength=num_vertices
                                 ).astype(np.float32)
    if batch.ins_dst.size:
        in_counts += np.bincount(batch.ins_dst.astype(np.int64),
                                 minlength=num_vertices
                                 ).astype(np.float32)

    new_store = EdgeTileStore(
        num_vertices, t, q_new, block_row, block_col, edge_ptr,
        li, lj, w, in_counts, row_ptr, row_order, col_ptr, col_order,
        block_rel=block_rel, num_relations=r)

    # --- delta bookkeeping for the packed merge -----------------------
    old_of_new = np.full(nnzb_new, -1, np.int64)
    old_of_new[pos_a] = alive_idx
    rank = np.cumsum(alive) - 1                # old tile -> alive rank
    touched_old = del_tiles_old[alive[del_tiles_old]]
    touched = np.union1d(pos_a[rank[touched_old]]
                         if touched_old.size else np.zeros(0, np.int64),
                         pos_b)
    delta = StoreDelta(touched, old_of_new, int(keep.sum()),
                       int(ikey.size), int((~alive).sum()))
    return new_store, delta


def update_packed_store(packed: PackedTileStore, new_store: EdgeTileStore,
                        delta: StoreDelta) -> PackedTileStore:
    """Re-derive the packed form after `update_tile_store`: only
    `delta.touched_tiles` re-merge (stable per-tile float64 merge, the
    `merge_by_key` semantics); every other tile's entries copy over
    from the old packed store byte-for-byte, so the result is
    bitwise-equal to `pack_tile_store(new_store)` at a cost linear in
    the touched tiles' edges."""
    t = new_store.tile
    nnzb = new_store.nnzb
    touched = np.zeros(nnzb, bool)
    touched[delta.touched_tiles] = True
    old_idx = delta.old_of_new

    # --- merge the touched tiles' edge lists --------------------------
    tt = delta.touched_tiles
    tcounts = (new_store.edge_ptr[tt + 1]
               - new_store.edge_ptr[tt]).astype(np.int64)
    src_pos = _group_positions(new_store.edge_ptr[tt], tcounts)
    rank_rep = np.repeat(np.arange(tt.size, dtype=np.int64), tcounts)
    mkey = ((rank_rep * t + new_store.edge_li[src_pos]) * t
            + new_store.edge_lj[src_pos])
    ku, mval = merge_by_key(mkey, new_store.edge_w[src_pos])
    m_rank = ku // (t * t)
    m_row = ((ku // t) % t).astype(np.int32)
    m_col = (ku % t).astype(np.int32)
    m_counts = np.bincount(m_rank, minlength=tt.size).astype(np.int64)

    # --- per-tile entry counts, then stitch ---------------------------
    entry_counts = np.zeros(nnzb, np.int64)
    keep_tiles = np.nonzero(~touched)[0]
    old_nnz = np.diff(packed.entry_ptr)
    entry_counts[keep_tiles] = old_nnz[old_idx[keep_tiles]]
    entry_counts[tt] = m_counts
    entry_ptr = np.zeros(nnzb + 1, np.int64)
    np.cumsum(entry_counts, out=entry_ptr[1:])

    m_total = int(entry_ptr[-1])
    row_local = np.zeros(m_total, np.int32)
    col_local = np.zeros(m_total, np.int32)
    val = np.zeros(m_total, np.float32)
    # untouched tiles: straight copy of the old entry slices
    kc = entry_counts[keep_tiles]
    dst_pos = _group_positions(entry_ptr[keep_tiles], kc)
    src_old = _group_positions(packed.entry_ptr[old_idx[keep_tiles]], kc)
    row_local[dst_pos] = packed.row_local[src_old]
    col_local[dst_pos] = packed.col_local[src_old]
    val[dst_pos] = packed.val[src_old]
    # touched tiles: the freshly merged entries (already tile-grouped)
    dst_t = _group_positions(entry_ptr[tt], m_counts)
    row_local[dst_t] = m_row
    col_local[dst_t] = m_col
    val[dst_t] = mval

    return PackedTileStore(
        new_store.num_vertices, t, new_store.q,
        new_store.block_row, new_store.block_col, entry_ptr,
        row_local, col_local, val, new_store.in_counts,
        block_rel=new_store.block_rel,
        num_relations=new_store.num_relations)
