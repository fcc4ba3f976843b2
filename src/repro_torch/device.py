"""The port's device rule: `cuda` unless the caller asks for the CPU.

Every entry point (`prepare_graph`, the layers, `make_gnn_stack`)
resolves its `device` argument here.  `None` means `cuda`; with no card
present that raises instead of quietly running on the CPU.
"""
from __future__ import annotations

from typing import Optional, Union

import torch

DeviceLike = Optional[Union[str, torch.device]]


def resolve_device(device: DeviceLike = None) -> torch.device:
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch runs on a CUDA card by default and none is "
            "available; pass device='cpu' to run the plain PyTorch path")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev


def visible_devices(device: torch.device) -> int:
    """Devices a mesh or ring spans by default, as the reference counts
    `jax.devices()`: the cards on `cuda`, 1 on the CPU."""
    return torch.cuda.device_count() if device.type == "cuda" else 1
