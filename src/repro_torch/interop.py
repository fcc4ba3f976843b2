"""Carry parameters from the reference package into the port.

`load_reference_params(layers, params)` takes the reference's per-layer
GNN parameter dicts (`w`, `w_pool`, `b_pool`, `w_z`, ... as numpy
arrays, or anything `np.asarray` reads) and copies them into the port's
layers, on the layers' device; `load_reference_lm_params(tree)` turns
the reference's LM parameter tree (nested dicts keyed as `model_specs`
keys them) into the port's tree of tensors, and
`load_reference_decode_state(state)` a reference decode state (from its
`prefill`, `decode_step` or `init_decode_state`) into the port's, so
`decode_step` can be held alone from one state.  Either way both
packages compute the same function.
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


def _tensor(value, device: torch.device) -> torch.Tensor:
    """An array as a tensor of its dtype (bfloat16, which numpy lacks,
    through an exact fp32 copy)."""
    arr = np.array(value)
    if arr.dtype.name == "bfloat16":
        return torch.from_numpy(arr.astype(np.float32)).to(
            device=device, dtype=torch.bfloat16)
    return torch.from_numpy(arr).to(device)


def _convert_tree(tree, device=None):
    from repro_torch.device import resolve_device
    dev = resolve_device(device)

    def convert(node):
        if isinstance(node, Mapping):
            return {k: convert(v) for k, v in node.items()}
        return _tensor(node, dev)
    return convert(tree)


def load_reference_lm_params(params: Mapping[str, Any], device=None):
    """The reference's LM parameter tree (numpy arrays, or anything
    `np.asarray` reads) as the port's: the same nested dicts, each leaf
    a tensor of the leaf's dtype on `device` (`cuda` unless the caller
    passes "cpu")."""
    return _convert_tree(params, device)


def load_reference_decode_state(state: Mapping[str, Any], device=None):
    """A reference decode state (`{"layers": {slot: {"k", "v", "mk",
    "mv", "conv", "ssm"}}, "pos"}`, arrays of any dtype) as the port's:
    the same tree of tensors on `device`, `pos` a 0-d int32 tensor."""
    out = _convert_tree(state, device)
    out["pos"] = out["pos"].to(torch.int32).reshape(())
    return out
