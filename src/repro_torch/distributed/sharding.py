"""The ring's shard layout: the GNN half of the reference's sharding
module (`ring_mesh`).

The reference runs the RER ring as `shard_map` over a 1-D mesh of local
devices, one shard a device.  The port keeps its one-controller process
model: a `RingMesh` names how many shards the ring has and the device
they live on, and the ring's plan holds P shards as P sets of tensors
(`core/dataflow.py`).  All P shards live on one device: the card (or the
CPU, when asked), which is how a one-card machine runs a P-shard ring.
Where the reference refuses more shards than devices, the port
co-locates them.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch.device import DeviceLike, resolve_device


@dataclasses.dataclass(frozen=True)
class RingMesh:
    """A 1-D ring of `num_shards` shards, all on `device`, along `axis`."""
    axis: str
    num_shards: int
    device: torch.device


def ring_mesh(num_shards: Optional[int] = None, axis: str = "ring",
              device: DeviceLike = None) -> RingMesh:
    """The ring for the RER dataflow (DESIGN.md C2).

    `num_shards` defaults to the visible devices, as the reference's
    does: `torch.cuda.device_count()` on `cuda`, 1 on the CPU.  Any
    count of at least 1 is taken, and its shards are co-located on
    `device` (`cuda` unless the caller passes "cpu")."""
    dev = resolve_device(device)
    visible = torch.cuda.device_count() if dev.type == "cuda" else 1
    p = num_shards or visible
    if p < 1:
        raise ValueError(f"a ring needs at least 1 shard, got {p}")
    return RingMesh(axis, int(p), dev)


__all__ = ["RingMesh", "ring_mesh"]
