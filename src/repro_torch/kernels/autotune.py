"""Tile-format choice: packed vs dense, per (graph, backend).

`EnGNConfig.tile_format="auto"` asks `choose_tile_format`, which records
a `TileFormatChoice` in the prepared plan.  Two policies:

* cost model (the default): the bytes each format stages — packed
  entries cost 12 B each (row, col, val) after pow2 nnz-bucket padding,
  dense tiles 4 T^2 B regardless of fill;
* measured (`measure=True`, which `TiledExecutor(autotune_measure=True)`
  asks for): time one staged chunk of the `sample` densest tiles both
  ways on the executor's device, per candidate bucket floor, and keep
  the faster, cached per graph fingerprint.  On the card the dense step
  is the einsum over the densified tiles and the packed step B2's tile
  part (`rer_gather_part_launch`); on the CPU the tile part's plain
  version.
"""
from __future__ import annotations

import dataclasses
import time
from functools import partial
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.device import DeviceLike, resolve_device
from repro_torch.graphs.partition import (EdgeTileStore, PackedTileStore,
                                          pow2_bucket)

TILE_FORMATS = ("dense", "packed", "auto")


@dataclasses.dataclass(frozen=True)
class TileFormatChoice:
    fmt: str                     # "dense" | "packed"
    bucket_floor: int            # packed nnz-bucket floor (pow2)
    fill_factor: float           # packed: nnz / padded entry slots
    dense_fill: float            # nnz / (nnzb * T^2)
    packed_bytes: int            # staged entry bytes, all tiles
    dense_bytes: int             # staged dense-tile bytes, all tiles
    reason: str                  # "forced" | "cost-model" | "measured"
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


# measured choices, per graph fingerprint: the sample's timing must not
# recur per layer or per executor; MEASURED_TIMES keeps, per fingerprint,
# the seconds each choice rests on ("dense", and "packed" per floor)
_MEASURED: Dict[Tuple, TileFormatChoice] = {}
MEASURED_TIMES: Dict[Tuple, Dict] = {}


def _fingerprint(packed: PackedTileStore, backend: str, dim: int) -> Tuple:
    return (backend, packed.num_vertices, packed.nnz, packed.nnzb,
            packed.tile, pow2_bucket(dim, 1))


def _timer(device: torch.device, iters: int) -> Callable[[Callable], float]:
    """Median seconds of `iters` calls of fn after a warm call, host clock
    around a synchronise of the card (none on the CPU)."""
    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    def run(fn) -> float:
        fn()
        sync()
        ts = []
        for _ in range(iters):
            t0 = time.perf_counter()
            fn()
            sync()
            ts.append(time.perf_counter() - t0)
        return float(np.median(ts))
    return run


def measured_choice(store: EdgeTileStore, packed: PackedTileStore, *,
                    backend: str = "tiled", dim: int = 32,
                    sample: int = 4, iters: int = 3,
                    bucket_floors: Tuple[int, ...] = (8, 32),
                    device: DeviceLike = None) -> TileFormatChoice:
    """Time one staged chunk of the `sample` densest tiles (packed's worst
    case) dense and packed on `device` (None: `cuda`), the packed step
    once per candidate bucket floor; returns the faster, with the floor
    that won, cached per graph fingerprint."""
    from repro_torch.kernels.rer_gather import ops as gather_ops
    key = _fingerprint(packed, backend, dim)
    hit = _MEASURED.get(key)
    if hit is not None:
        return hit
    nnz = packed.tile_nnz()
    if nnz.size == 0:
        choice = _model_choice(packed)
        _MEASURED[key] = choice
        return choice
    dev = resolve_device(device)
    idx = np.argsort(-nnz, kind="stable")[:sample].astype(np.int64)
    t = packed.tile
    k = idx.size
    rng = np.random.default_rng(0)
    xs = torch.from_numpy(rng.standard_normal((k, t, dim)).astype(
        np.float32)).to(dev)
    timed = _timer(dev, iters)
    blocks = torch.from_numpy(store.densify(
        idx, np.zeros((k, t, t), np.float32))).to(dev)
    t_dense = timed(lambda: torch.einsum("ktu,kuf->tf", blocks, xs))
    part = (gather_ops.packed_tile_part_plain if dev.type == "cpu"
            # the store's local indices lie in [0, T): no call reads back
            else partial(gather_ops.packed_tile_part, checked=True))
    best: Optional[Tuple[float, int]] = None
    packed_s = {}
    for floor in bucket_floors:
        rows, cols, vals = (torch.from_numpy(a).to(dev) for a in packed.pack(
            idx, k, packed.bucket_of(idx, floor)))
        t_packed = timed(lambda: part(rows, cols, vals, xs, op="sum"))
        packed_s[floor] = t_packed
        if best is None or t_packed < best[0]:
            best = (t_packed, floor)
    MEASURED_TIMES[key] = {"dense": t_dense, "packed": packed_s,
                           "device": str(dev)}
    t_packed, floor = best
    base = _model_choice(packed, floor)
    fmt = "packed" if t_packed < t_dense else "dense"
    choice = dataclasses.replace(base, fmt=fmt, reason="measured")
    _MEASURED[key] = choice
    return choice


def choose_tile_format(requested: str, packed: Optional[PackedTileStore],
                       *, backend: str = "tiled",
                       bucket_floor: int = 8, measure: bool = False,
                       store: Optional[EdgeTileStore] = None,
                       dim: int = 32, value_dtype: str = "fp32",
                       device: DeviceLike = None) -> TileFormatChoice:
    """Resolve an `EnGNConfig.tile_format` request into the concrete
    choice recorded in the prepared plan.  `value_dtype` prices the
    packed value plane as it travels (int8 plus per-tile scales), which
    can flip a near-dense graph to packed.  `measure` with a `store`
    times the sample (`measured_choice`) on `device`."""
    if requested not in TILE_FORMATS:
        raise ValueError(
            f"tile_format must be one of {TILE_FORMATS}, got "
            f"{requested!r}")
    if requested != "auto":
        return _forced_choice(requested, packed, bucket_floor,
                              value_dtype)
    if packed is None:
        return _forced_choice("dense", None, bucket_floor, value_dtype)
    if measure and store is not None:
        choice = measured_choice(store, packed, backend=backend, dim=dim,
                                 bucket_floors=(bucket_floor,
                                                4 * bucket_floor),
                                 device=device)
        return dataclasses.replace(choice, value_dtype=value_dtype)
    return _model_choice(packed, bucket_floor, value_dtype)
