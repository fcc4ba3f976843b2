"""Sharding rules on the port's one-controller model: logical axes ->
mesh axes, parameter and batch PartitionSpecs, the activation
constrainer, and the ring's shard layout (`ring_mesh`).

The 2-D scheme (DESIGN.md S5): parameters shard input dims over "data"
(FSDP-style just-in-time gather) and output dims over "model" (TP);
activations shard batch over ("pod", "data") and sequence over "model".
Logical axes that don't divide evenly fall back to replication.  Every
spec is the reference's, tuple for tuple.

A mesh here (`launch/mesh.py::Mesh`, or the ring's `RingMesh`) names
axes and sizes and the one device all its shards live on: the card (or
the CPU, when asked).  A "sharding" is (mesh, spec), and placing a
tensor under one moves it whole to the mesh's device, since the shards
are co-located; the `Constrainer` computes the reference's
per-dimension fallback spec and returns its input unchanged, which is
what the reference does on a one-device mesh.  The reference runs the
RER ring as `shard_map` over a 1-D mesh of local devices, one shard a
device; the port's ring plan holds P shards as P sets of tensors
(`core/dataflow.py`) on one device, which is how a one-card machine
runs a P-shard ring, and where the reference refuses more shards than
devices, the port co-locates them.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import numpy as np
import torch

from repro_torch.device import DeviceLike, resolve_device, visible_devices
from repro_torch.nn.param import (DEFAULT_RULES, PartitionSpec, map_tree,
                                  tree_pspecs)

P = PartitionSpec


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
    p = num_shards or visible_devices(dev)
    if p < 1:
        raise ValueError(f"a ring needs at least 1 shard, got {p}")
    return RingMesh(axis, int(p), dev)


def mesh_shape_dict(mesh) -> Dict[str, int]:
    """Axis name -> size of a mesh (anything with `axis_names` and a
    `devices` array, as the reference reads it)."""
    return dict(zip(mesh.axis_names, mesh.devices.shape))


def make_rules(mesh, seq_sharded: bool = True) -> Dict[str, object]:
    """Adapt DEFAULT_RULES to the mesh at hand (drop missing axes)."""
    names = set(mesh.axis_names)
    rules = {}
    for k, v in DEFAULT_RULES.items():
        if isinstance(v, tuple):
            v2 = tuple(a for a in v if a in names)
            rules[k] = v2 if v2 else None
        else:
            rules[k] = v if v in names else None
    if not seq_sharded:
        rules["seq"] = None
    return rules


def param_pspecs(cfg, mesh, rules=None):
    """PartitionSpec tree matching the model parameter tree."""
    from repro_torch.nn.transformer import model_specs
    rules = rules or make_rules(mesh)
    return tree_pspecs(model_specs(cfg), mesh_shape_dict(mesh), rules)


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A PartitionSpec on a mesh.  Its shards are co-located on the
    mesh's device, so placing a tensor moves it whole there."""
    mesh: object
    spec: PartitionSpec

    def place(self, x: torch.Tensor) -> torch.Tensor:
        if len(self.spec) > x.dim():
            raise ValueError(f"spec {self.spec} has more entries than the "
                             f"{x.dim()}-d tensor it places")
        return x.to(self.mesh.device)


def _is_pspec(x) -> bool:
    return isinstance(x, PartitionSpec)


def param_shardings(cfg, mesh, rules=None):
    return map_tree(lambda s: NamedSharding(mesh, s),
                    param_pspecs(cfg, mesh, rules), is_leaf=_is_pspec)


def device_put(x, sharding) -> torch.Tensor:
    """`x` (a tensor or an array) placed under `sharding`, which must be
    a `NamedSharding`."""
    if not isinstance(sharding, NamedSharding):
        raise TypeError(f"not a sharding: {sharding!r}")
    return sharding.place(torch.as_tensor(x))


class Constrainer:
    """The reference's activation constrainer: the spec from logical
    axes, with divisibility fallback per dimension (replicate what
    doesn't divide).  With every shard on one device it returns `x`
    unchanged, as the reference's constraint does on a one-device
    mesh."""

    def __init__(self, mesh, rules: Optional[dict] = None):
        self.mesh = mesh
        self.rules = rules or make_rules(mesh)
        self.shape = mesh_shape_dict(mesh)

    def _axis_size(self, ax) -> int:
        if ax is None:
            return 1
        if isinstance(ax, tuple):
            return int(np.prod([self.shape.get(a, 1) for a in ax]))
        return self.shape.get(ax, 1)

    def spec(self, shape, logical_axes) -> PartitionSpec:
        out = []
        for dim, ax in zip(shape, logical_axes):
            mesh_ax = self.rules.get(ax) if ax is not None else None
            if mesh_ax is None or dim % self._axis_size(mesh_ax) != 0:
                out.append(None)
            else:
                out.append(mesh_ax)
        return PartitionSpec(*out)

    def __call__(self, x, logical_axes):
        self.spec(x.shape, logical_axes)
        return x


def batch_pspec(mesh, rank: int, seq_axis: Optional[int] = None,
                rules=None, shape=None) -> PartitionSpec:
    """PartitionSpec for a batch-leading array (tokens, labels, ...).

    When `shape` is given, any dim that does not divide its mesh-axis
    size falls back to replication (e.g. batch 1 cannot shard over
    data=16)."""
    rules = rules or make_rules(mesh)
    spec = [rules.get("batch")] + [None] * (rank - 1)
    if seq_axis is not None and rules.get("seq"):
        spec[seq_axis] = rules["seq"]
    if shape is not None:
        ms = mesh_shape_dict(mesh)

        def _size(ax):
            if ax is None:
                return 1
            if isinstance(ax, tuple):
                return int(np.prod([ms.get(a, 1) for a in ax]))
            return ms.get(ax, 1)

        spec = [ax if (ax is not None and dim % _size(ax) == 0) else None
                for dim, ax in zip(shape, spec)]
    return PartitionSpec(*spec)


__all__ = ["Constrainer", "NamedSharding", "P", "PartitionSpec", "RingMesh",
           "batch_pspec", "device_put", "make_rules", "mesh_shape_dict",
           "param_pspecs", "param_shardings", "ring_mesh"]
