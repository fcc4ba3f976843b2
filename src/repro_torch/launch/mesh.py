"""Mesh construction: the reference's shapes on the port's one-controller
model.

A port mesh is the reference's axis names and sizes plus the one device
its tensors live on: every shard of a (data, model) mesh is co-located
there, as the ring's shards are (`distributed/sharding.py::RingMesh`).
It is not a set of `torch.distributed` ranks.  Single pod: (data=16,
model=16); multi-pod adds a leading "pod" axis: (2, 16, 16).
`make_elastic_mesh` builds the best (data, model) shape for whatever
devices survive, by the reference's shrink rule — the elastic-scaling
entry point of `checkpoint/elastic.py`.  Every constructor takes its
device from `device` (`cuda` unless the caller passes "cpu").
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.device import DeviceLike, resolve_device, visible_devices


@dataclasses.dataclass(frozen=True)
class Mesh:
    """Axis names and sizes, every shard on `device`."""
    axis_sizes: Tuple[int, ...]
    axis_names: Tuple[str, ...]
    device: torch.device

    @property
    def shape(self) -> Dict[str, int]:
        """Axis name -> size, as the reference mesh's `shape`."""
        return dict(zip(self.axis_names, self.axis_sizes))

    @property
    def size(self) -> int:
        return int(np.prod(self.axis_sizes))

    @property
    def devices(self) -> np.ndarray:
        """The reference mesh's device array: here each entry is the
        one device every shard lives on."""
        out = np.empty(self.axis_sizes, dtype=object)
        out.fill(self.device)
        return out


def make_mesh(shape: Sequence[int], axes: Sequence[str],
              device: DeviceLike = None) -> Mesh:
    if len(shape) != len(axes):
        raise ValueError(f"mesh shape {tuple(shape)} vs axes {tuple(axes)}")
    return Mesh(tuple(int(s) for s in shape), tuple(axes),
                resolve_device(device))


def make_production_mesh(*, multi_pod: bool = False,
                         device: DeviceLike = None) -> Mesh:
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, axes, device)


def make_elastic_mesh(n_devices: Optional[int] = None,
                      model_parallel: int = 16,
                      device: DeviceLike = None) -> Mesh:
    """Best-effort (data, model) mesh from the available device count —
    used on restart after losing nodes.  The model axis shrinks to the
    largest power-of-two divisor <= model_parallel if needed."""
    dev = resolve_device(device)
    n = n_devices if n_devices is not None else visible_devices(dev)
    mp = min(model_parallel, n)
    while n % mp != 0:
        mp //= 2
    mp = max(mp, 1)
    return make_mesh((n // mp, mp), ("data", "model"), dev)


def single_device_mesh(device: DeviceLike = None) -> Mesh:
    return make_mesh((1, 1), ("data", "model"), device)


__all__ = ["Mesh", "make_elastic_mesh", "make_mesh", "make_production_mesh",
           "single_device_mesh"]
