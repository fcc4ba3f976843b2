"""Elastic scaling: resume a run on a different device count / mesh.

Checkpoints are mesh-agnostic (logical arrays), so elasticity is: build
the best mesh for the surviving devices (`launch/mesh.py::
make_elastic_mesh`), derive the parameter shardings for that mesh, and
place the restored tensors under them.  The data cursor stored in the
checkpoint metadata lets the stream resume without sample loss; the
global batch is kept by adjusting the per-shard batch (or the
gradient-accumulation steps when the shard count no longer divides it).

The port's mesh co-locates its shards on one device, so a placement
moves each tensor whole to that device (`distributed/sharding.py::
NamedSharding`).
"""
from __future__ import annotations

import warnings
from typing import Optional, Tuple

from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.distributed.sharding import device_put, param_shardings
from repro_torch.launch.mesh import make_elastic_mesh
from repro_torch.training.optimizer import tree_map


def _place_like_params(subtree, shardings):
    """Place a params-shaped subtree (opt `m` / `v` mirror params)."""
    return tree_map(device_put, subtree, shardings)


def elastic_restore(cfg, ckpt: CheckpointManager, tree_like,
                    n_devices: Optional[int] = None,
                    model_parallel: int = 16,
                    shardings=None,
                    on_placement_error: str = "warn",
                    device=None):
    """Returns (mesh, restored_tree, metadata, step).

    Params AND the params-shaped optimizer moments (`opt["m"]`,
    `opt["v"]`) are re-placed under the surviving mesh's shardings;
    `opt["count"]` and the metadata are kept.  `shardings` overrides the
    derived `param_shardings(cfg, mesh)` (a params-shaped tree of
    `NamedSharding`).  Placement failures are loud:
    `on_placement_error="warn"` (default) keeps the restored tensors
    where `tree_like`'s leaves live and emits a RuntimeWarning naming
    the placement; `"raise"` propagates.  The mesh lives on `device`
    (`cuda` unless the caller passes "cpu")."""
    if on_placement_error not in ("warn", "raise"):
        raise ValueError(f"on_placement_error={on_placement_error!r}")
    mesh = make_elastic_mesh(n_devices, model_parallel, device=device)
    sh = param_shardings(cfg, mesh) if shardings is None else shardings
    tree, meta, step = ckpt.restore(tree_like)
    if not (isinstance(tree, dict) and "params" in tree):
        return mesh, tree, meta, step
    try:
        placed = dict(tree)
        placed["params"] = _place_like_params(tree["params"], sh)
        if isinstance(tree.get("opt"), dict):
            opt = dict(tree["opt"])
            for moment in ("m", "v"):
                if moment in opt:
                    opt[moment] = _place_like_params(opt[moment], sh)
            placed["opt"] = opt
    except Exception as e:  # noqa: BLE001 — surfaced, never swallowed
        if on_placement_error == "raise":
            raise
        warnings.warn(
            f"elastic_restore: placement onto {mesh.shape} on "
            f"{mesh.device} failed ({e!r}); returning the restored "
            f"arrays where they are", RuntimeWarning, stacklevel=2)
        return mesh, tree, meta, step
    return mesh, placed, meta, step


def adjust_microbatching(global_batch: int, n_data_shards: int,
                         prev_micro_steps: int = 1) -> Tuple[int, int]:
    """Keep the global batch constant across a device-count change:
    returns (per_shard_batch, micro_steps) with
    per_shard * micro * n_shards == global_batch when an exact split
    exists, otherwise the largest feasible batch <= global_batch."""
    for micro in range(prev_micro_steps, global_batch + 1):
        if global_batch % (n_data_shards * micro) == 0:
            return global_batch // (n_data_shards * micro), micro
    # no exact split (shard count does not divide the batch):
    # best-effort under the target with one micro step
    return max(global_batch // n_data_shards, 1), 1


__all__ = ["adjust_microbatching", "elastic_restore"]
