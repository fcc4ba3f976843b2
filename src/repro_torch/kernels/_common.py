"""What the kernel wrappers share: argument checks, the tile-span
pointers a CTA walks, the refusal of autograd where a kernel has no
backward, and the launch-status check."""
from __future__ import annotations

import weakref
from typing import Any, Dict, Tuple

import torch

# id(tensor) -> (weakref to it, its version, {check or value: result})
_MEMO: Dict[int, Tuple[weakref.ref, int, Dict[tuple, Any]]] = {}


def check_tensor(t: torch.Tensor, name: str, dtype: torch.dtype,
                 device: torch.device, ndim: int) -> None:
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name} must be a torch.Tensor")
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if t.dim() != ndim:
        raise ValueError(f"{name} must be {ndim}-D, got shape "
                         f"{tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _version(t: torch.Tensor) -> int:
    # inference tensors keep no version counter: identity alone keys them
    return -1 if t.is_inference() else t._version


def _memo(t: torch.Tensor) -> Dict[tuple, Any]:
    """Checks passed and values derived for one carrier tensor.  A check
    of the values reads back to the host, so each runs once per tensor;
    the entry is dropped when the tensor is modified in place or dies."""
    key, version = id(t), _version(t)
    hit = _MEMO.get(key)
    if hit is None or hit[0]() is not t or hit[1] != version:
        hit = (weakref.ref(t), version, {})
        _MEMO[key] = hit
        if len(_MEMO) > 256:
            for k in [k for k, v in _MEMO.items() if v[0]() is None]:
                del _MEMO[k]
    return hit[2]


def check_range(t: torch.Tensor, hi: int, name: str, lo: int = 0) -> None:
    """Every value of the index tensor `t` lies in [lo, hi): a kernel
    would read out of bounds otherwise."""
    memo = _memo(t)
    key = ("range", hi) if lo == 0 else ("range", lo, hi)
    if key in memo:
        return
    if t.numel() and bool((t.min() < lo) | (t.max() >= hi)):
        raise ValueError(f"{name} holds values outside [{lo}, {hi})")
    memo[key] = True


def tile_ptr(block_row: torch.Tensor, q: int) -> torch.Tensor:
    """(q+1,) int32 span pointers: the tiles of dst interval i are
    `[tile_ptr[i], tile_ptr[i+1])` of the dst-sorted tile list, derived
    on the device (count per interval + cumsum).  The checks that
    `block_row` is in range and non-decreasing read back to the host, so
    they and the pointers are memoised per carrier tensor: later launches
    of the same carrier never synchronise."""
    memo = _memo(block_row)
    ptr = memo.get(("tile_ptr", q))
    if ptr is None:
        check_range(block_row, q, "block_row")
        if (block_row.numel() > 1
                and bool((block_row[1:] < block_row[:-1]).any())):
            raise ValueError("block_row must be non-decreasing (dst-sorted "
                             "tiles, see prepare_blocks / "
                             "prepare_packed_groups)")
        counts = torch.zeros(q + 1, dtype=torch.int32,
                             device=block_row.device)
        counts.index_add_(0, block_row.long() + 1,
                          torch.ones_like(block_row, dtype=torch.int32))
        ptr = torch.cumsum(counts, 0, dtype=torch.int32)
        memo[("tile_ptr", q)] = ptr
    return ptr


def refuse_grad(what: str, *tensors: torch.Tensor, why: str) -> None:
    """Refuse a call that autograd would have to differentiate where the
    call form has no backward (`why` says what it is instead), rather
    than return a result with a silently missing gradient."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise NotImplementedError(
            f"{what} {why}; run inference under torch.no_grad() or "
            f"torch.inference_mode()")


def stream_handle(device: torch.device) -> int:
    """The raw handle of `device`'s current stream, where the kernels
    launch: PyTorch's own raw-stream query (what its compiled kernels
    launch on), which builds no Stream object as `current_stream`
    does."""
    return torch._C._cuda_getCurrentRawStream(
        device.index if device.index is not None
        else torch.cuda.current_device())


def check_status(status: int, what: str) -> None:
    """Raise on a nonzero `cudaGetLastError()` from a launcher: a launch
    refused for its configuration never runs, and no later synchronise
    would report it."""
    if status != 0:
        raise RuntimeError(f"{what} kernel launch failed: CUDA error "
                           f"{status}")
