"""Ring-Edge-Reduce across shards (paper S4.1.2, DESIGN.md C2) in PyTorch.

The ASIC connects the PEs of a column into a ring: vertex properties flow
around it and every PE reduces the edges it owns.  The reference lifts
that one level up, to devices: destination shards stay put, source-feature
shards rotate with `lax.ppermute`, and each shard reduces its stripe of
the adjacency against whichever source shard it holds.

The port keeps one controller.  A ring plan holds P shards as P sets of
tensors, on the ring's device (`distributed/sharding.py::RingMesh`), and
a ring step is an explicit copy between them: `RingHop`, an autograd
Function whose forward gives shard i a fresh copy of shard (i + 1) mod P
(the reference's ppermute with `_ring_step_perm`) and whose backward
rotates the cotangents the other way (ppermute's transpose).  Each
step's hop is issued before that step's contraction, as the reference
issues its ppermute; every copy runs on the current stream.  The scan
bodies are the reference's XLA arithmetic in plain torch (gathers,
`bmm`, `index_add`, `scatter_reduce`), not kernels.

Three carriers share the dataflow:

* `ring_aggregate_dense` / `make_ring_aggregate`: the dense oracle, each
  shard holding its (P, n_loc, n_loc) stripe of the full adjacency;
* `build_ring_tile_shards` / `make_ring_tiled_aggregate`: each shard
  keeps only the non-empty T x T tiles of its stripe, grouped by source
  shard and padded to `s_max` zero tiles;
* `build_packed_ring_shards` / `make_ring_packed_aggregate`: each
  (dst, src) shard pair carries its merged edge entries `(row, col,
  val)`, padded to the pow2 nnz bucket `l_max`.

The typed (R-GCN) and gated (Gated-GCN) stage contracts ride the same
rotation (`make_ring_typed_sum_*`, `make_ring_gated_*`).  The host
builders and `ring_stripe_bytes` are numpy copies of the reference's and
equal to them field for field.

Zero-weight caveat (shared with every dense-tile backend): an explicit
0.0-weight edge is indistinguishable from no edge, so max masks it out
where the segment reference would include its 0*x term.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from repro_torch.distributed.sharding import RingMesh
from repro_torch.graphs.format import COOGraph
from repro_torch.graphs.partition import (build_tile_store, merge_by_key,
                                          pow2_bucket)
from repro_torch.kernels.autotune import packed_entry_bytes

# the dense max body's (tiles, T, T, F) product is formed a slab of
# tiles at a time, each slab at most this many bytes
MAX_TEMP_BYTES = 1 << 28


def _ring_step_perm(p: int):
    # receive from the southern neighbour: (i+1) % p sends to i
    return [((i + 1) % p, i) for i in range(p)]


# ----------------------------------------------------------------------
# The rotation
# ----------------------------------------------------------------------

# forward hops and the bytes they copied, and the backward's, since the
# last `reset_hop_counts()`
hop_counts: Dict[str, int] = {"hops": 0, "bytes": 0,
                              "bwd_hops": 0, "bwd_bytes": 0}


def reset_hop_counts() -> None:
    for key in hop_counts:
        hop_counts[key] = 0


def _rotate(shards, perm) -> tuple:
    """out[dst] = a fresh copy of shards[src] for each (src, dst)."""
    out = [None] * len(shards)
    for src, dst in perm:
        out[dst] = shards[src].clone()
    return tuple(out)


class RingHop(torch.autograd.Function):
    """One ring step over the P shards: shard i receives a copy of shard
    (i + 1) mod P in a fresh buffer (the double buffer that
    `ring_feature_bytes` prices).  The backward sends each cotangent back
    the way its shard came."""

    @staticmethod
    def forward(ctx, *shards):
        hop_counts["hops"] += 1
        hop_counts["bytes"] += sum(s.numel() * s.element_size()
                                   for s in shards)
        return _rotate(shards, _ring_step_perm(len(shards)))

    @staticmethod
    def backward(ctx, *grads):
        hop_counts["bwd_hops"] += 1
        hop_counts["bwd_bytes"] += sum(g.numel() * g.element_size()
                                       for g in grads)
        return _rotate(grads, [(d, s) for s, d
                               in _ring_step_perm(len(grads))])


def ring_hop(shards: Sequence[torch.Tensor]) -> tuple:
    out = RingHop.apply(*shards)
    return out if isinstance(out, tuple) else (out,)


def _ring_scan(x_shards: Sequence[torch.Tensor], init: Callable,
               step: Callable) -> List[torch.Tensor]:
    """The P ring steps every body shares: at step k shard d holds the
    features of source shard s = (d + k) mod P.  The hop that delivers
    step k+1's shards is issued before step k's contraction, and every
    step hops (P hops an aggregate, `RingStats.ring_steps`).  Returns
    the P accumulators `step(d, s, x_rot, acc)` left."""
    p = len(x_shards)
    x_rot = tuple(x_shards)
    accs = [init(d) for d in range(p)]
    for k in range(p):
        x_next = ring_hop(x_rot)
        for d in range(p):
            accs[d] = step(d, (d + k) % p, x_rot[d], accs[d])
        x_rot = x_next
    return accs


def _check_ring(mesh: RingMesh, axis: str, name: str, operand) -> int:
    if axis != mesh.axis:
        raise ValueError(f"axis {axis!r} is not the ring's ({mesh.axis!r})")
    p = mesh.num_shards
    if len(operand) != p:
        raise ValueError(f"{name} holds {len(operand)} shards, the ring "
                         f"has {p}")
    return p


def _split(x: torch.Tensor, p: int, n_loc: int, name: str = "X"):
    if x.shape[0] != p * n_loc:
        raise ValueError(f"{name} has {x.shape[0]} rows, the ring expects "
                         f"{p} shards of {n_loc}")
    return x.split(n_loc)


def _segment_max(vals: torch.Tensor, idx: torch.Tensor, n: int):
    """Per-segment max of `vals` rows, -inf where a segment is empty."""
    out = torch.full((n,) + tuple(vals.shape[1:]), -torch.inf,
                     dtype=vals.dtype, device=vals.device)
    index = idx.reshape((-1,) + (1,) * (vals.dim() - 1)).expand_as(vals)
    return out.scatter_reduce(0, index, vals, "amax", include_self=False)


def _finish(y: torch.Tensor, op: str, counts: torch.Tensor):
    if op == "max":
        y = torch.where(torch.isneginf(y), 0.0, y)
    if op == "mean":
        y = y / torch.clamp_min(counts, 1.0)[:, None]
    return y


# ----------------------------------------------------------------------
# Dense reference ring (oracle; small graphs only)
# ----------------------------------------------------------------------

def ring_aggregate_dense(a_blocks, x_shards: Sequence[torch.Tensor],
                         op: str = "sum") -> List[torch.Tensor]:
    """One RER rotation over the P shards.

    a_blocks[d]: (P, n_loc, n_loc), shard d's destination rows of A split
                 by source shard (a_blocks[d][s] multiplies the features
                 of shard s).
    x_shards[d]: (n_loc, F), shard d's vertex features.
    Returns the P (n_loc, F) aggregates."""
    def init(d):
        x = x_shards[d]
        return (torch.zeros_like(x) if op == "sum"
                else torch.full_like(x, -torch.inf))

    def step(d, s, x_rot, acc):
        blk = a_blocks[d][s]
        if op == "sum":
            return acc + blk @ x_rot
        # max: elementwise per edge, non-edges contribute -inf
        vals = torch.where(blk[:, :, None] != 0.0,
                           blk[:, :, None] * x_rot[None, :, :], -torch.inf)
        return torch.maximum(acc, vals.amax(dim=1))

    accs = _ring_scan(x_shards, init, step)
    if op == "max":
        accs = [torch.where(torch.isinf(a), 0.0, a) for a in accs]
    return accs


def pad_ring_features(x, num_shards: int):
    """Pad vertex-feature rows up to a multiple of `num_shards` (the
    companion of `shard_adjacency_for_ring`, which pads A the same way:
    padded rows are zero and contribute nothing)."""
    n = x.shape[0]
    pad = (-n) % num_shards
    if pad == 0:
        return np.asarray(x)
    return np.concatenate(
        [np.asarray(x), np.zeros((pad,) + x.shape[1:], x.dtype)])


def make_ring_aggregate(mesh: RingMesh, axis: str,
                        op: str = "sum") -> Callable:
    """(A_blocks_global, X_global) -> AX over the ring.

    A_blocks_global: (P, P, n_loc, n_loc) with A_blocks_global[d, s] the
    block of A mapping shard s sources to shard d destinations.
    X_global: (N, F) with N a multiple of the ring size (pad with
    `pad_ring_features`)."""
    p = mesh.num_shards
    if axis != mesh.axis:
        raise ValueError(f"axis {axis!r} is not the ring's ({mesh.axis!r})")

    def call(a_blocks, x):
        if a_blocks.shape[0] != p or a_blocks.shape[1] != p:
            raise ValueError(
                f"a_blocks must be (P, P, n_loc, n_loc) with P={p} ring "
                f"shards, got {tuple(a_blocks.shape)} (build it with "
                f"shard_adjacency_for_ring(a, {p}))")
        if x.shape[0] != p * a_blocks.shape[2]:
            raise ValueError(
                f"X has {x.shape[0]} rows but the ring blocks expect "
                f"{p} shards of {a_blocks.shape[2]} vertices — pad the "
                f"features to {p * a_blocks.shape[2]} rows with "
                f"pad_ring_features (shard_adjacency_for_ring already "
                f"pads A the same way)")
        return torch.cat(ring_aggregate_dense(
            a_blocks, x.split(a_blocks.shape[2]), op))

    return call


def shard_adjacency_for_ring(a_dense, num_shards: int):
    """Host-side: dense A (N, N) -> (P, P, n_loc, n_loc) ring blocks,
    padding N up to a multiple of P."""
    if num_shards < 1:
        raise ValueError(f"num_shards must be >= 1, got {num_shards}")
    a_dense = np.asarray(a_dense)
    if a_dense.ndim != 2 or a_dense.shape[0] != a_dense.shape[1]:
        raise ValueError(f"adjacency must be square, got {a_dense.shape}")
    n = a_dense.shape[0]
    n_loc = -(-n // num_shards)
    pad = num_shards * n_loc - n
    if pad:
        a_dense = np.pad(a_dense, ((0, pad), (0, pad)))
    a = a_dense.reshape(num_shards, n_loc, num_shards, n_loc)
    return np.ascontiguousarray(a.transpose(0, 2, 1, 3))


# ----------------------------------------------------------------------
# Ring stripes: the host carriers and their prices
# ----------------------------------------------------------------------

@dataclasses.dataclass
class RingStats:
    """Traffic counters of one ring aggregate, computed from the plan
    (the reference's, field for field)."""
    shards: int = 0
    ring_steps: int = 0        # hops per aggregate (= P)
    tiles: int = 0             # non-empty tiles reduced across the ring
    padded_tiles: int = 0      # tiles staged after S_max padding
    block_bytes: int = 0       # resident tile/entry bytes per shard
    ppermute_bytes: int = 0    # feature bytes rotated per aggregate
    x_shard_bytes: int = 0     # one resident feature shard
    acc_bytes: int = 0         # the resident destination accumulator
    tile_format: str = "dense"
    # real edge entries vs resident padded slots (dense: T^2 per staged
    # tile; packed: the pow2 nnz bucket)
    nnz: int = 0
    padded_slots: int = 0

    def fill_factor(self) -> float:
        if not self.padded_slots:
            return 1.0
        return self.nnz / self.padded_slots

    def as_dict(self) -> Dict[str, float]:
        d = dataclasses.asdict(self)
        d["fill_factor"] = self.fill_factor()
        return d


@dataclasses.dataclass(frozen=True)
class RingTileShards:
    """The Q x Q edge-tile grid split for the ring: destination vertices
    in P contiguous shards of `n_loc` (= q_loc * tile) vertices; each
    shard owns the row-stripe of tiles whose destination interval it
    contains, grouped by the source shard the rotation delivers.

    blocks[d, s, i] is the i-th non-empty dense tile mapping sources of
    shard s to destinations of shard d; (tile_row, tile_col)[d, s, i]
    are its local destination / source interval.  Pairs pad to `s_max`
    tiles with all-zero tiles (nothing to a sum, masked out of a max)."""
    num_shards: int
    tile: int
    q_loc: int                  # tile intervals per shard
    n_loc: int                  # padded vertices per shard (q_loc * tile)
    s_max: int                  # padded tiles per (dst, src) shard pair
    nnzb: int                   # non-empty tiles (unpadded)
    num_vertices: int
    blocks: np.ndarray          # (P, P, s_max, T, T) float32
    tile_row: np.ndarray        # (P, P, s_max) int32, local dst interval
    tile_col: np.ndarray        # (P, P, s_max) int32, local src interval
    in_counts: np.ndarray       # (P, n_loc) float32 in-edge counts
    # relation-typed stripes: every entry of a tile shares its tile's
    # relation; None on untyped graphs
    tile_rel: Optional[np.ndarray] = None    # (P, P, s_max) int32
    num_relations: int = 1

    @property
    def padded_vertices(self) -> int:
        return self.num_shards * self.n_loc

    def device_bytes(self) -> int:
        """Resident bytes per shard: the tile stripe, its indices and the
        in-count shard (`ring_feature_bytes` prices the features)."""
        p = self.num_shards
        per_dev_tiles = p * self.s_max
        rel = 4 * per_dev_tiles if self.tile_rel is not None else 0
        return int(4 * per_dev_tiles * self.tile * self.tile
                   + 2 * 4 * per_dev_tiles
                   + 4 * self.n_loc + rel)

    def stats(self, feat_dim: int, out_dim: Optional[int] = None) -> RingStats:
        p = self.num_shards
        h = out_dim if out_dim is not None else feat_dim
        return RingStats(
            shards=p,
            ring_steps=p,
            tiles=self.nnzb,
            padded_tiles=p * p * self.s_max,
            block_bytes=4 * p * self.s_max * self.tile * self.tile,
            ppermute_bytes=4 * p * p * self.n_loc * feat_dim,
            x_shard_bytes=4 * self.n_loc * feat_dim,
            acc_bytes=4 * self.n_loc * h,
            tile_format="dense",
            nnz=int((self.blocks != 0.0).sum()),
            padded_slots=p * p * self.s_max * self.tile * self.tile,
        )


def ring_feature_bytes(n_loc: int, in_dim: int, out_dim: int) -> int:
    """Per-shard bytes of the rotating feature buffers: the resident
    shard, the hop's receive buffer, and the accumulator."""
    return int(4 * n_loc * (2 * in_dim + out_dim))


def _ring_geometry(num_vertices: int, num_shards: int, tile: int):
    """(t, q_loc, n_loc): shard-aligned tile geometry shared by the
    builder and the sizing pass."""
    n_loc_raw = -(-num_vertices // num_shards)
    t = max(1, min(tile, n_loc_raw))
    q_loc = -(-n_loc_raw // t)
    return t, q_loc, q_loc * t


def ring_stripe_bytes(g: COOGraph, num_shards: int, tile: int = 256,
                      in_dim: int = 0, out_dim: int = 0,
                      tile_format: str = "dense",
                      bucket_floor: int = 8,
                      value_dtype: str = "fp32") -> int:
    """Exact per-shard resident bytes of the ring plan for `g`, from one
    binning pass (no tile densified): `RingTileShards.device_bytes()`
    (dense) or `PackedRingShards.device_bytes()` (packed), plus
    `ring_feature_bytes` when dims are given; "auto" the cheaper of the
    two (the format `prepare_ring` picks).  `value_dtype="int8"` prices
    the packed value plane quantised (9 B a slot and one f32 scale a
    stripe) to compare fairly with a quantised alternative; the ring
    itself runs fp32."""
    p = num_shards
    t, q_loc, n_loc = _ring_geometry(g.num_vertices, p, tile)
    feat = ring_feature_bytes(n_loc, in_dim, out_dim)

    def dense_bytes() -> int:
        q = p * q_loc
        key = (g.dst // t).astype(np.int64) * q + (g.src // t)
        uniq = np.unique(key)
        pair = (uniq // q) // q_loc * p + (uniq % q) // q_loc
        counts = np.bincount(pair, minlength=p * p)
        s_max = int(max(counts.max() if counts.size else 0, 1))
        per_dev = p * s_max
        return int(4 * per_dev * t * t + 8 * per_dev + 4 * n_loc)

    def packed_bytes() -> int:
        n_loc_p = -(-g.num_vertices // p)
        n_pad = p * n_loc_p
        uniq = np.unique(g.dst.astype(np.int64) * n_pad + g.src)
        pair = (uniq // n_pad) // n_loc_p * p + (uniq % n_pad) // n_loc_p
        counts = np.bincount(pair, minlength=p * p)
        l_max = pow2_bucket(int(counts.max()) if counts.size else 0,
                            bucket_floor)
        scale_b = 4 if value_dtype == "int8" else 0
        return int(packed_entry_bytes(p * l_max, value_dtype)
                   + scale_b * p + 4 * n_loc_p)

    if tile_format == "dense":
        return dense_bytes() + feat
    if tile_format == "packed":
        return packed_bytes() + feat
    return min(dense_bytes(), packed_bytes()) + feat


def build_ring_tile_shards(g: COOGraph, num_shards: int,
                           tile: int = 256) -> RingTileShards:
    """Partition a COO graph into the per-shard tile stripes: one
    `EdgeTileStore` build over the shard-aligned padded vertex space,
    then the non-empty tiles densified once and grouped by (dst shard,
    src shard).  Padded vertices have no edges and zero features."""
    if num_shards < 1:
        raise ValueError(f"num_shards must be >= 1, got {num_shards}")
    p = num_shards
    n = g.num_vertices
    t, q_loc, n_loc = _ring_geometry(n, p, tile)
    n_pad = p * n_loc
    store = build_tile_store(
        dataclasses.replace(g, num_vertices=n_pad), t)
    assert store.q == p * q_loc

    d_of = store.block_row // q_loc            # dst shard per tile
    s_of = store.block_col // q_loc            # src shard per tile
    pair = d_of.astype(np.int64) * p + s_of
    order = np.argsort(pair, kind="stable").astype(np.int64)
    pair_sorted = pair[order]
    counts = np.bincount(pair_sorted, minlength=p * p)
    s_max = int(max(counts.max() if counts.size else 0, 1))
    starts = np.searchsorted(pair_sorted, np.arange(p * p))
    slot = np.arange(order.size) - starts[pair_sorted]

    blocks = np.zeros((p, p, s_max, t, t), np.float32)
    tile_row = np.zeros((p, p, s_max), np.int32)
    tile_col = np.zeros((p, p, s_max), np.int32)
    tile_rel = (np.zeros((p, p, s_max), np.int32)
                if store.block_rel is not None else None)
    if order.size:
        buf = np.zeros((order.size, t, t), np.float32)
        store.densify(order, buf)
        di, si = d_of[order], s_of[order]
        blocks[di, si, slot] = buf
        tile_row[di, si, slot] = (store.block_row[order] % q_loc)
        tile_col[di, si, slot] = (store.block_col[order] % q_loc)
        if tile_rel is not None:
            tile_rel[di, si, slot] = store.block_rel[order]

    return RingTileShards(
        num_shards=p, tile=t, q_loc=q_loc, n_loc=n_loc, s_max=s_max,
        nnzb=int(store.nnzb), num_vertices=n,
        blocks=blocks, tile_row=tile_row, tile_col=tile_col,
        in_counts=store.in_counts.reshape(p, n_loc).astype(np.float32),
        tile_rel=tile_rel, num_relations=store.num_relations)


@dataclasses.dataclass(frozen=True)
class PackedRingShards:
    """The packed form of the ring stripes: destination vertices in P
    contiguous shards of `n_loc`; each (dst shard d, src shard s) pair
    carries its merged edge entries (`rows[d, s, i]` / `cols[d, s, i]`
    the shard-local destination / source vertex of entry i, `vals` its
    merged weight), padded to the pow2 nnz bucket `l_max` with (0, 0,
    0.0) entries (nothing to a sum, masked out of a max)."""
    num_shards: int
    n_loc: int                  # padded vertices per shard
    l_max: int                  # pow2 padded entries per shard pair
    nnz: int                    # merged edge entries (unpadded)
    num_vertices: int
    rows: np.ndarray            # (P, P, L) int32 local dst vertex
    cols: np.ndarray            # (P, P, L) int32 local src vertex
    vals: np.ndarray            # (P, P, L) float32 (0.0 = padding)
    in_counts: np.ndarray       # (P, n_loc) float32 in-edge counts
    tile: int = 0               # no tiles in this form (meta compat)
    q_loc: int = 1
    s_max: int = 0              # = l_max (meta compat with the dense plan)
    nnzb: int = 0               # = nnz  (meta compat with the dense plan)
    # per-entry relation on typed graphs (multi-edges merge per (dst,
    # src, rel), so distinct relations never collapse); else None
    rels: Optional[np.ndarray] = None        # (P, P, L) int32
    num_relations: int = 1

    @property
    def padded_vertices(self) -> int:
        return self.num_shards * self.n_loc

    def device_bytes(self) -> int:
        """Resident bytes per shard: the packed stripe (12 B per entry
        slot over the P source pairs, 16 B with a rel column) and the
        in-count shard."""
        per_slot = 16 if self.rels is not None else 12
        return int(per_slot * self.num_shards * self.l_max
                   + 4 * self.n_loc)

    def stats(self, feat_dim: int, out_dim: Optional[int] = None) -> RingStats:
        p = self.num_shards
        h = out_dim if out_dim is not None else feat_dim
        return RingStats(
            shards=p,
            ring_steps=p,
            tiles=self.nnz,
            padded_tiles=p * p * self.l_max,
            block_bytes=12 * p * self.l_max,
            ppermute_bytes=4 * p * p * self.n_loc * feat_dim,
            x_shard_bytes=4 * self.n_loc * feat_dim,
            acc_bytes=4 * self.n_loc * h,
            tile_format="packed",
            nnz=self.nnz,
            padded_slots=p * p * self.l_max,
        )


def pair_counts(plan) -> np.ndarray:
    """(P, P): for each (dst, src) shard pair, its slots up to the last
    one holding a nonzero value (packed entries, or dense tiles with a
    nonzero); the slots after it are padding, or entries of value 0,
    which add nothing to a sum and are masked out of a max."""
    if isinstance(plan, PackedRingShards):
        live = plan.vals != 0.0
    else:
        live = plan.blocks.any(axis=(3, 4))
    return (live * np.arange(1, live.shape[-1] + 1)).max(axis=-1)


def _merge_edges(g: COOGraph, n_pad: int):
    """Merge multi-edges by summation over the padded vertex space (the
    coefficients the dense tiles' scatter-add produces); typed graphs
    merge per (dst, src, rel).  Returns (dst, src, val, rel-or-None)."""
    typed = g.rel is not None and g.num_relations > 1
    r = int(g.num_relations) if typed else 1
    key = (g.dst.astype(np.int64) * n_pad + g.src) * r
    if typed:
        key = key + g.rel.astype(np.int64)
    ku, val = merge_by_key(key, g.weights())
    cell = ku // r
    rel = (ku % r).astype(np.int32) if typed else None
    return (cell // n_pad).astype(np.int64), \
        (cell % n_pad).astype(np.int64), val, rel


def build_packed_ring_shards(g: COOGraph, num_shards: int,
                             bucket_floor: int = 8) -> PackedRingShards:
    """Partition a COO graph into per-(dst, src)-shard-pair packed edge
    lists: one argsort to merge multi-edges, one binning pass to group
    by shard pair, no T^2 anywhere."""
    if num_shards < 1:
        raise ValueError(f"num_shards must be >= 1, got {num_shards}")
    p = num_shards
    n = g.num_vertices
    n_loc = -(-n // p)
    n_pad = p * n_loc
    dst, src, val, rel = _merge_edges(g, n_pad)
    d_of = dst // n_loc
    s_of = src // n_loc
    pair = d_of * p + s_of
    order = np.argsort(pair, kind="stable")
    pair_sorted = pair[order]
    counts = np.bincount(pair_sorted, minlength=p * p)
    l_max = pow2_bucket(int(counts.max()) if counts.size else 0,
                        bucket_floor)
    starts = np.searchsorted(pair_sorted, np.arange(p * p))
    slot = np.arange(order.size) - starts[pair_sorted]

    rows = np.zeros((p, p, l_max), np.int32)
    cols = np.zeros((p, p, l_max), np.int32)
    vals = np.zeros((p, p, l_max), np.float32)
    rels = np.zeros((p, p, l_max), np.int32) if rel is not None else None
    if order.size:
        di, si = d_of[order], s_of[order]
        rows[di, si, slot] = (dst[order] % n_loc)
        cols[di, si, slot] = (src[order] % n_loc)
        vals[di, si, slot] = val[order]
        if rels is not None:
            rels[di, si, slot] = rel[order]
    in_counts = np.bincount(g.dst, minlength=n_pad).astype(np.float32)
    return PackedRingShards(
        num_shards=p, n_loc=n_loc, l_max=l_max, nnz=int(dst.size),
        num_vertices=n, rows=rows, cols=cols, vals=vals,
        in_counts=in_counts.reshape(p, n_loc),
        s_max=l_max, nnzb=int(dst.size),
        rels=rels, num_relations=int(g.num_relations))


# ----------------------------------------------------------------------
# The scan bodies.  Each `make_*` returns a callable over the plan's
# operands, indexed [d][s] for the (dst shard d, src shard s) pair: e.g.
# blocks[d][s] the tiles of shard d's stripe that shard s's features
# meet (a stacked (P, P, s_max, ...) array serves, as do per-pair
# tensors cut to different lengths), X padded to P * n_loc rows, and the
# in-count shards; it returns the padded (P * n_loc, H) aggregate.
# ----------------------------------------------------------------------

def _tile_products(blk: torch.Tensor, xs: torch.Tensor) -> torch.Tensor:
    """(k, T, T, F): blk[k, t, u] * xs[k, u, f] where blk != 0, else
    -inf."""
    b = blk[..., None]
    return torch.where(b != 0.0, b * xs[:, None, :, :], -torch.inf)


def _slabs(k: int, per_tile_bytes: int):
    step = max(1, MAX_TEMP_BYTES // max(per_tile_bytes, 1))
    return [(lo, min(lo + step, k)) for lo in range(0, k, step)]


class TileMax(torch.autograd.Function):
    """part[k, t, f] = max over u of blk[k, t, u] * xs[k, u, f] over the
    tile's nonzeros (-inf in a tile row without one): the dense max
    body's (tiles, T, T, F) product, formed a slab of tiles at a time so
    no temporary passes `MAX_TEMP_BYTES`.  The backward recomputes each
    slab and splits a cotangent evenly over the tile's tied winners
    (`jnp.max`'s convention).  The tiles are a constant of the graph."""

    @staticmethod
    def forward(ctx, blk, xs):
        k, t, _ = blk.shape
        out = torch.empty((k, t, xs.shape[2]), dtype=xs.dtype,
                          device=xs.device)
        per_tile = 4 * t * t * xs.shape[2]
        for lo, hi in _slabs(k, per_tile):
            out[lo:hi] = _tile_products(blk[lo:hi], xs[lo:hi]).amax(dim=2)
        ctx.save_for_backward(blk, xs, out)
        return out

    @staticmethod
    def backward(ctx, g):
        blk, xs, out = ctx.saved_tensors
        k, t, _ = blk.shape
        gx = torch.empty_like(xs)
        # three slab-sized temporaries live here: the products, the
        # winners, the shared cotangent
        per_tile = 3 * 4 * t * t * xs.shape[2]
        for lo, hi in _slabs(k, per_tile):
            win = _tile_products(blk[lo:hi], xs[lo:hi]) \
                == out[lo:hi, :, None, :]
            share = g[lo:hi, :, None, :] / win.sum(dim=2, keepdim=True)
            gx[lo:hi] = (torch.where(win, share, 0.0)
                         * blk[lo:hi, :, :, None]).sum(dim=1)
        return None, gx


def _acc_init(shape, dtype, device, op):
    if op == "sum":
        return torch.zeros(shape, dtype=dtype, device=device)
    return torch.full(shape, -torch.inf, dtype=dtype, device=device)


def make_ring_tiled_aggregate(mesh: RingMesh, axis: str, op: str,
                              q_loc: int, tile: int) -> Callable:
    """(blocks, tile_row, tile_col, X_padded, in_counts) -> A(X) over
    the dense tile stripes; `op` is "sum" | "max" | "mean" (mean = the
    ring sum divided by the resident in-count shard)."""
    if op not in ("sum", "max", "mean"):
        raise ValueError(op)
    base = "sum" if op == "mean" else op

    def call(blocks, tile_row, tile_col, x, counts):
        p = _check_ring(mesh, axis, "blocks", blocks)
        n_loc = q_loc * tile
        xs_ = _split(x, p, n_loc)
        f = x.shape[1]

        def step(d, s, x_rot, acc):
            trow = tile_row[d][s].long()
            xs = x_rot.reshape(q_loc, tile, f)[tile_col[d][s].long()]
            if base == "sum":
                return acc.index_add(0, trow, torch.bmm(blocks[d][s], xs))
            # padded (all-zero) tiles give -inf rows: a no-op max
            part = TileMax.apply(blocks[d][s], xs)
            return torch.maximum(acc, _segment_max(part, trow, q_loc))

        accs = _ring_scan(
            xs_, lambda d: _acc_init((q_loc, tile, f), x.dtype, x.device,
                                     base), step)
        return torch.cat([_finish(a.reshape(n_loc, f), op, counts[d])
                          for d, a in enumerate(accs)])

    return call


def make_ring_packed_aggregate(mesh: RingMesh, axis: str, op: str,
                               n_loc: int) -> Callable:
    """(rows, cols, vals, X_padded, in_counts) -> A(X) over the packed
    stripes: a gather and a segment reduce a ring step."""
    if op not in ("sum", "max", "mean"):
        raise ValueError(op)
    base = "sum" if op == "mean" else op

    def call(rows, cols, vals, x, counts):
        p = _check_ring(mesh, axis, "rows", rows)
        f = x.shape[1]

        def step(d, s, x_rot, acc):
            r, v = rows[d][s].long(), vals[d][s]
            gathered = x_rot[cols[d][s].long()]             # (L, F)
            if base == "sum":
                return acc.index_add(0, r, v[:, None] * gathered)
            scaled = torch.where((v != 0.0)[:, None], v[:, None] * gathered,
                                 -torch.inf)
            return torch.maximum(acc, _segment_max(scaled, r, n_loc))

        accs = _ring_scan(
            _split(x, p, n_loc),
            lambda d: _acc_init((n_loc, f), x.dtype, x.device, base), step)
        return torch.cat([_finish(a, op, counts[d])
                          for d, a in enumerate(accs)])

    return call


def make_ring_typed_sum_tiled(mesh: RingMesh, axis: str, q_loc: int,
                              tile: int, num_relations: int) -> Callable:
    """(blocks, tile_row, tile_col, tile_rel, X_payload, in_counts)
        -> sum_r A_r X[:, rH:(r+1)H]
    with X_payload (P * n_loc, R*H): each tile contracts the H-wide
    slice of its own relation."""
    r = num_relations

    def call(blocks, tile_row, tile_col, tile_rel, x, counts):
        p = _check_ring(mesh, axis, "blocks", blocks)
        n_loc = q_loc * tile
        h = x.shape[1] // r
        lanes = torch.arange(tile, device=x.device)

        def step(d, s, x_rot, acc):
            tcol = tile_col[d][s].long()[:, None]
            trel = tile_rel[d][s].long()[:, None]
            sel = x_rot.reshape(q_loc, tile, r, h)[tcol, lanes, trel]
            return acc.index_add(0, tile_row[d][s].long(),
                                 torch.bmm(blocks[d][s], sel))

        accs = _ring_scan(
            _split(x, p, n_loc),
            lambda d: torch.zeros((q_loc, tile, h), dtype=x.dtype,
                                  device=x.device), step)
        return torch.cat([a.reshape(n_loc, h) for a in accs])

    return call


def make_ring_typed_sum_packed(mesh: RingMesh, axis: str, n_loc: int,
                               num_relations: int) -> Callable:
    """(rows, cols, vals, rels, X_payload, in_counts)
        -> sum_r A_r X[:, rH:(r+1)H]: each entry's relation selects its
    slice of the gathered payload row."""
    r = num_relations

    def call(rows, cols, vals, rels, x, counts):
        p = _check_ring(mesh, axis, "rows", rows)
        h = x.shape[1] // r

        def step(d, s, x_rot, acc):
            sel = x_rot.reshape(n_loc, r, h)[cols[d][s].long(),
                                             rels[d][s].long()]
            return acc.index_add(0, rows[d][s].long(),
                                 vals[d][s][:, None] * sel)

        accs = _ring_scan(
            _split(x, p, n_loc),
            lambda d: torch.zeros((n_loc, h), dtype=x.dtype,
                                  device=x.device), step)
        return torch.cat(accs)

    return call


def make_ring_gated_tiled(mesh: RingMesh, axis: str, q_loc: int,
                          tile: int) -> Callable:
    """(blocks, tile_row, tile_col, PH, PCX, in_counts) -> agg with
    message = val * sigmoid(ph[dst] + pc[src]) * x[src]: PH (P * n_loc,
    F) stays on its destination shard, the (pc || x) stack PCX
    (P * n_loc, 2F) rotates.  Materialises (s_max, T, T, F) a step, as
    the reference's does (priced by `engn.gated_dense_bytes`)."""

    def call(blocks, tile_row, tile_col, ph, pcx, counts):
        p = _check_ring(mesh, axis, "blocks", blocks)
        n_loc = q_loc * tile
        f = pcx.shape[1] // 2
        ph_t = [a.reshape(q_loc, tile, f) for a in _split(ph, p, n_loc,
                                                          "PH")]

        def step(d, s, x_rot, acc):
            trow = tile_row[d][s].long()
            st = x_rot.reshape(q_loc, tile, 2 * f)[tile_col[d][s].long()]
            pc_s, x_s = st[..., :f], st[..., f:]          # (s_max, T, F)
            z = torch.sigmoid(ph_t[d][trow][:, :, None, :]
                              + pc_s[:, None, :, :])
            b = blocks[d][s][..., None]
            contrib = torch.where(b != 0.0, b * z * x_s[:, None, :, :], 0.0)
            return acc.index_add(0, trow, contrib.sum(dim=2))

        accs = _ring_scan(
            _split(pcx, p, n_loc, "PCX"),
            lambda d: torch.zeros((q_loc, tile, f), dtype=pcx.dtype,
                                  device=pcx.device), step)
        return torch.cat([a.reshape(n_loc, f) for a in accs])

    return call


def make_ring_gated_packed(mesh: RingMesh, axis: str, n_loc: int) -> Callable:
    """(rows, cols, vals, PH, PCX, in_counts) -> agg: the gated message
    on the packed stripes, one gather of both endpoints a step."""

    def call(rows, cols, vals, ph, pcx, counts):
        p = _check_ring(mesh, axis, "rows", rows)
        f = pcx.shape[1] // 2
        ph_s = _split(ph, p, n_loc, "PH")

        def step(d, s, x_rot, acc):
            rw, v = rows[d][s].long(), vals[d][s]
            st = x_rot[cols[d][s].long()]                 # (L, 2F)
            z = torch.sigmoid(ph_s[d][rw] + st[:, :f])
            contrib = torch.where((v != 0.0)[:, None],
                                  v[:, None] * z * st[:, f:], 0.0)
            return acc.index_add(0, rw, contrib)

        accs = _ring_scan(
            _split(pcx, p, n_loc, "PCX"),
            lambda d: torch.zeros((n_loc, f), dtype=pcx.dtype,
                                  device=pcx.device), step)
        return torch.cat(accs)

    return call


__all__ = ["RingHop", "RingStats", "RingTileShards", "PackedRingShards",
           "TileMax", "build_packed_ring_shards", "build_ring_tile_shards",
           "hop_counts", "make_ring_aggregate", "make_ring_gated_packed",
           "pair_counts",
           "make_ring_gated_tiled", "make_ring_packed_aggregate",
           "make_ring_tiled_aggregate", "make_ring_typed_sum_packed",
           "make_ring_typed_sum_tiled", "pad_ring_features",
           "reset_hop_counts", "ring_aggregate_dense", "ring_feature_bytes",
           "ring_hop", "ring_stripe_bytes", "shard_adjacency_for_ring"]
