"""Tile-format choice: packed vs dense, per (graph, backend).

`EnGNConfig.tile_format="auto"` asks `choose_tile_format`, which prices
the bytes each format stages — packed entries cost 12 B each (row, col,
val) after pow2 nnz-bucket padding, dense tiles 4 T^2 B regardless of
fill — and records a `TileFormatChoice` in the prepared plan.  The
reference's measured mode, which times one staged chunk both ways, waits
until the port's kernels have been timed on the card.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional

from repro_torch.graphs.partition import PackedTileStore

TILE_FORMATS = ("dense", "packed", "auto")


@dataclasses.dataclass(frozen=True)
class TileFormatChoice:
    fmt: str                     # "dense" | "packed"
    bucket_floor: int            # packed nnz-bucket floor (pow2)
    fill_factor: float           # packed: nnz / padded entry slots
    dense_fill: float            # nnz / (nnzb * T^2)
    packed_bytes: int            # staged entry bytes, all tiles
    dense_bytes: int             # staged dense-tile bytes, all tiles
    reason: str                  # "forced" | "cost-model"
    value_dtype: str = "fp32"    # how the value plane travels

    def as_dict(self) -> Dict:
        return dataclasses.asdict(self)


def packed_entry_bytes(slots: int, value_dtype: str = "fp32") -> int:
    """Bytes per staged packed entry slot: int32 row + int32 col + the
    value (float32, or int8 under quantised streaming)."""
    vb = 1 if value_dtype == "int8" else 4
    return (8 + vb) * slots


def _model_choice(packed: PackedTileStore, bucket_floor: int = 8,
                  value_dtype: str = "fp32") -> TileFormatChoice:
    dense_bytes = 4 * packed.nnzb * packed.tile * packed.tile
    pbytes = (packed_entry_bytes(packed.packed_slots(bucket_floor),
                                 value_dtype)
              + (4 * packed.nnzb if value_dtype == "int8" else 0))
    fmt = "packed" if pbytes < dense_bytes else "dense"
    return TileFormatChoice(fmt, bucket_floor,
                            packed.fill_factor(bucket_floor),
                            packed.dense_fill(), pbytes, dense_bytes,
                            "cost-model", value_dtype)


def _forced_choice(fmt: str, packed: Optional[PackedTileStore],
                   bucket_floor: int = 8,
                   value_dtype: str = "fp32") -> TileFormatChoice:
    if packed is None:
        return TileFormatChoice(fmt, bucket_floor, 1.0, 1.0, 0, 0,
                                "forced", value_dtype)
    base = _model_choice(packed, bucket_floor, value_dtype)
    return dataclasses.replace(base, fmt=fmt, reason="forced")


def choose_tile_format(requested: str, packed: Optional[PackedTileStore],
                       *, backend: str = "tiled",
                       bucket_floor: int = 8, measure: bool = False,
                       value_dtype: str = "fp32") -> TileFormatChoice:
    """Resolve an `EnGNConfig.tile_format` request into the concrete
    choice recorded in the prepared plan."""
    if requested not in TILE_FORMATS:
        raise ValueError(
            f"tile_format must be one of {TILE_FORMATS}, got "
            f"{requested!r}")
    if requested != "auto":
        return _forced_choice(requested, packed, bucket_floor,
                              value_dtype)
    if packed is None:
        return _forced_choice("dense", None, bucket_floor, value_dtype)
    if measure:
        raise NotImplementedError(
            "measured tile-format choice needs the port's kernels timed on "
            "the card first (ROADMAP B-queue); use the cost model")
    return _model_choice(packed, bucket_floor, value_dtype)
