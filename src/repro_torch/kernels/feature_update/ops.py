"""Fused linear + activation: Y = act(X W + b), the feature-extraction /
update stage with its epilogue fused (paper S4, the XPE).

`fused_linear_act` launches the hand-written CUDA kernel
`csrc/feature_update.cu` for CUDA tensors and runs
`fused_linear_act_plain` for CPU tensors.  `act` is "relu", "sigmoid" or
"tanh"; any other name is the identity, as in the reference kernel.
Ragged N, K and H are masked inside the kernel, so nothing is padded.
Forward only, like the reference's entry point: a call that autograd
would have to differentiate is refused.  No layer calls it (the
reference wires it into none).

Source note.  Replaces `repro/kernels/feature_update/feature_update.py::
fused_linear_act_kernel` (wrapper `ops.py::fused_linear_act`).  On the
H100 it is bound by operations at the update stage's shapes (about 30
fp32 operations per byte of X at H = 64): a tiled fp32 GEMM on the CUDA
cores, 64 x 64 output tiles, a 16-deep K loop through shared memory,
4 x 4 outputs per thread, bias and activation applied in registers.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels import _build
from repro_torch.kernels._common import (check_status, check_tensor,
                                         refuse_grad, stream_handle)

_ACT_CODE = {"relu": 1, "sigmoid": 2, "tanh": 3}

# kernel launches by activation ("identity" for any other name), counted
# where the kernel is launched
LAUNCHES = {"relu": 0, "sigmoid": 0, "tanh": 0, "identity": 0}


def _act_name(act: str) -> str:
    return act if act in _ACT_CODE else "identity"


def fused_linear_act_plain(x: torch.Tensor, w: torch.Tensor,
                           b: Optional[torch.Tensor] = None, *,
                           act: str = "relu") -> torch.Tensor:
    """act(x @ w + b) in plain PyTorch, on any device."""
    y = x @ w
    if b is not None:
        y = y + b[None, :]
    if act == "relu":
        return torch.relu(y)
    if act == "sigmoid":
        return torch.sigmoid(y)
    if act == "tanh":
        return torch.tanh(y)
    return y


_LIB = None


def _lib():
    global _LIB
    if _LIB is None:
        lib = _build.load("feature_update")
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.feature_update_launch.argtypes = [p, p, p, p, i, i, i, i, p]
        lib.feature_update_launch.restype = i
        _LIB = lib
    return _LIB


def fused_linear_act(x: torch.Tensor, w: torch.Tensor,
                     b: Optional[torch.Tensor] = None, *,
                     act: str = "relu") -> torch.Tensor:
    """Y (N, H) = act(X (N, K) @ W (K, H) + b (H,)), float32; `b=None`
    is a zero bias.  CPU tensors take the plain version; CUDA tensors
    the kernel."""
    refuse_grad("feature_update", *(t for t in (x, w, b) if t is not None),
                why="is forward only, as the reference's entry point")
    if x.device.type == "cpu":
        return fused_linear_act_plain(x, w, b, act=act)
    if x.device.type != "cuda":
        raise ValueError(f"no feature_update for device {x.device}")
    dev = x.device
    if b is None:
        b = torch.zeros((w.shape[1],), dtype=torch.float32, device=dev)
    check_tensor(x, "x", torch.float32, dev, 2)
    check_tensor(w, "w", torch.float32, dev, 2)
    check_tensor(b, "b", torch.float32, dev, 1)
    n, k = x.shape
    if w.shape[0] != k or b.shape[0] != w.shape[1]:
        raise ValueError(f"x {tuple(x.shape)}, w {tuple(w.shape)} and b "
                         f"{tuple(b.shape)} do not chain")
    h = w.shape[1]
    y = torch.empty((n, h), dtype=torch.float32, device=dev)
    status = _lib().feature_update_launch(
        x.data_ptr(), w.data_ptr(), b.data_ptr(), y.data_ptr(), n, k, h,
        _ACT_CODE.get(act, 0), stream_handle(dev))
    check_status(status, "feature_update")
    LAUNCHES[_act_name(act)] += 1
    return y
