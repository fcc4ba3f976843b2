"""The device-budget gate of `prepare_graph`.

Only the pricing is ported: `dense_footprint_bytes` estimates what a
graph-resident backend places on the device, and `DeviceBudgetExceeded`
is what a strict budget raises.  Where the reference spills to its
streamed out-of-core executor, the port raises `NotImplementedError`
until that executor is ported (ROADMAP A7).
"""
from __future__ import annotations

from repro_torch.kernels.autotune import packed_entry_bytes


class DeviceBudgetExceeded(RuntimeError):
    """A dense execution path needs more device memory than the budget."""


def dense_footprint_bytes(num_vertices: int, num_edges: int, in_dim: int,
                          out_dim: int, backend: str = "segment",
                          tile: int = 256, has_val: bool = True,
                          num_shards: int = 1,
                          tile_format: str = "dense",
                          training: bool = False,
                          value_dtype: str = "fp32") -> int:
    """Device bytes a graph-resident backend needs.  `training=True`
    doubles every activation-shaped term (cotangent twins); the tile
    formats are priced in the bytes they stage (dense 4 T^2 per tile,
    packed pow2-bucketed entries, "auto" the cheaper); ring is priced
    per shard of a `num_shards`-device ring."""
    n, e, f, h = num_vertices, num_edges, in_dim, out_dim
    act = 2 if training else 1
    feat = act * 4 * n * (f + h)
    scale_b = 4 if value_dtype == "int8" else 0
    if backend == "segment":
        edges = e * (8 + (4 if has_val else 0))
        return feat + edges + act * 4 * e * max(f, h)
    if backend in ("blocked", "fused"):
        q = -(-n // tile)
        nnzb_ub = min(q * q, max(e, 1))
        dense = feat + 4 * nnzb_ub * tile * tile
        packed = (feat
                  + packed_entry_bytes(2 * e + 8 * nnzb_ub, value_dtype)
                  + (8 + scale_b) * nnzb_ub)
        if tile_format == "dense" or backend == "fused":
            return dense
        return packed if tile_format == "packed" else min(dense, packed)
    if backend == "ring":
        p = max(num_shards, 1)
        n_loc_raw = -(-n // p)
        t = max(1, min(tile, n_loc_raw))
        q_loc = -(-n_loc_raw // t)
        n_loc = q_loc * t
        q = p * q_loc
        per_dev_tiles = min(q_loc * q, p * max(e, 1))
        feat_ring = act * 4 * n_loc * (2 * f + h)
        dense = feat_ring + 4 * per_dev_tiles * t * t + 8 * per_dev_tiles
        packed = (feat_ring
                  + packed_entry_bytes(2 * e + 8 * p, value_dtype)
                  + scale_b * p + 4 * n_loc)
        if tile_format == "dense":
            return dense
        return packed if tile_format == "packed" else min(dense, packed)
    raise ValueError(backend)
