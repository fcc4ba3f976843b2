"""Carry parameters from the reference package into the port.

`load_reference_params(layers, params)` takes the reference's per-layer
GNN parameter dicts (`w`, `w_pool`, `b_pool`, `w_z`, ... as numpy
arrays, or anything `np.asarray` reads) and copies them into the port's
layers, on the layers' device; `load_reference_lm_params(tree)` turns
the reference's LM parameter tree (nested dicts keyed as `model_specs`
keys them) into the port's tree of tensors.  Either way both packages
compute the same function.
"""
from __future__ import annotations

from typing import Any, Mapping, Sequence

import numpy as np
import torch


def load_reference_params(layers: Sequence[torch.nn.Module],
                          params: Sequence[Mapping[str, object]]) -> None:
    if len(layers) != len(params):
        raise ValueError(f"{len(layers)} layers but {len(params)} "
                         f"parameter dicts")
    for i, (layer, p) in enumerate(zip(layers, params)):
        own = dict(layer.named_parameters())
        if set(own) != set(p):
            raise ValueError(f"layer {i}: port has {sorted(own)}, "
                             f"reference has {sorted(p)}")
        with torch.no_grad():
            for key, val in p.items():
                arr = np.array(val, dtype=np.float32)
                if tuple(arr.shape) != tuple(own[key].shape):
                    raise ValueError(f"layer {i} {key}: shape {arr.shape} "
                                     f"vs {tuple(own[key].shape)}")
                own[key].copy_(torch.from_numpy(arr))


def load_reference_lm_params(params: Mapping[str, Any], device=None):
    """The reference's LM parameter tree (numpy arrays, or anything
    `np.asarray` reads) as the port's: the same nested dicts, each leaf
    a tensor of the leaf's dtype on `device` (`cuda` unless the caller
    passes "cpu")."""
    from repro_torch.device import resolve_device
    dev = resolve_device(device)

    def convert(node):
        if isinstance(node, Mapping):
            return {k: convert(v) for k, v in node.items()}
        return torch.from_numpy(np.array(node)).to(dev)
    return convert(params)
