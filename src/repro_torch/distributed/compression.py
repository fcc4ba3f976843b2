"""int8 quantisation with error feedback: gradients and tile values.

Two consumers share one symmetric per-tensor int8 transform:

* **Gradient reduction**: per-tensor int8 cuts a gradient's bytes 4x
  (f32), and the residual is carried to the next step (error feedback),
  so convergence is kept.  `quantize_int8` / `dequantize_int8` /
  `make_error_feedback_transform` / `compression_ratio` are the tensor
  twins, over a dict or a list of tensors.

* **Streamed tile values**: with `EnGNConfig.tile_value_dtype="int8"`
  the streamed executor's packed tile values travel as int8 with one f32
  scale per staged tile (or per chunk-queue slab).  `StreamingTileQuantizer`
  keeps a per-entry residual aligned with the packed store, so the
  rounding of sweep k is folded into sweep k+1's values: the time-averaged
  edge weight converges to the exact f32 value.  These are host-side
  numpy transforms (they run in the staging loop), the reference's own,
  so the port's quantised arrays equal the reference's bit for bit.
"""
from __future__ import annotations

from typing import Callable, Dict, List, Optional, Tuple, Union

import numpy as np
import torch

Tensors = Union[Dict[str, torch.Tensor], List[torch.Tensor],
                Tuple[torch.Tensor, ...]]


def quantize_int8(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-tensor int8: (q, scale), scale = max|x| / 127 (plus
    1e-12, so an all-zero tensor quantises to zeros)."""
    scale = x.abs().max() / 127.0 + 1e-12
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.to(torch.float32) * scale


def _map(fn: Callable, tree: Tensors, *others: Tensors):
    """fn over the tensors of a dict or a list, leaf by leaf; returns the
    same kind of container."""
    if isinstance(tree, dict):
        return {k: fn(v, *(o[k] for o in others)) for k, v in tree.items()}
    return [fn(v, *(o[i] for o in others)) for i, v in enumerate(tree)]


def _leaves(tree: Tensors) -> List[torch.Tensor]:
    return list(tree.values()) if isinstance(tree, dict) else list(tree)


def make_error_feedback_transform():
    """Returns (transform, init_error): transform(grads, err) ->
    (compressed grads, new err), each leaf quantised with its residual
    added first; init_error(params) is all zeros.  grads, err and params
    are dicts or lists of tensors."""

    def init_error(params: Tensors):
        return _map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                          device=p.device), params)

    def one(g, e):
        g32 = g.to(torch.float32) + e
        deq = dequantize_int8(*quantize_int8(g32))
        return deq, g32 - deq

    def transform(grads: Tensors, err: Tensors):
        out = _map(one, grads, err)
        if isinstance(out, dict):
            return ({k: v[0] for k, v in out.items()},
                    {k: v[1] for k, v in out.items()})
        return [o[0] for o in out], [o[1] for o in out]

    return transform, init_error


def compression_ratio(params: Tensors) -> float:
    """Bytes of int8 + one f32 scale per tensor over f32 bytes."""
    leaves = _leaves(params)
    total = sum(p.numel() * 4 for p in leaves)
    comp = sum(p.numel() * 1 + 4 for p in leaves)
    return comp / total


# -- host-side twins for the streamed tile values ----------------------------

def quantize_int8_np(x: np.ndarray, err: Optional[np.ndarray] = None
                     ) -> Tuple[np.ndarray, float, np.ndarray]:
    """Symmetric per-tensor int8 quantisation of a host array, with
    optional error feedback: quantises `x + err` and returns (q, scale,
    new_err), new_err the residual to fold into the next quantisation of
    the same values.  Round-trip error is at most scale / 2 = max|x +
    err| / 254 an element."""
    x = np.asarray(x, np.float32)
    v = x if err is None else x + err
    scale = float(np.max(np.abs(v)) / 127.0 + 1e-12) if v.size else 1e-12
    q = np.clip(np.rint(v / scale), -127, 127).astype(np.int8)
    new_err = (v - q.astype(np.float32) * scale).astype(np.float32)
    return q, scale, new_err


class StreamingTileQuantizer:
    """Error-feedback int8 quantiser for re-streamed packed tile values.

    The buffer is aligned with a `PackedTileStore`'s flat `val` array (one
    f32 residual per merged entry), so per-tile staging
    (`PackedTileStore.pack_quantized`) and whole-queue staging
    (`build_chunk_queue`) share one state: each quantisation of an entry
    range reads and rewrites exactly its slice.  A sum is linear in the
    values, so carrying the residual makes the time-averaged streamed sum
    unbiased across sweeps."""

    def __init__(self, num_entries: int):
        self.err = np.zeros(int(num_entries), np.float32)

    def quantize_range(self, vals: np.ndarray, lo: int, hi: int
                       ) -> Tuple[np.ndarray, float]:
        """Quantise `vals` (entries [lo, hi) of the store's flat values)
        with this buffer's residual for that range; the residual slice is
        updated in place."""
        q, scale, new_err = quantize_int8_np(vals, self.err[lo:hi])
        self.err[lo:hi] = new_err
        return q, scale

    def reset(self):
        self.err[:] = 0.0


def quantize_stream_np(vals2d: np.ndarray,
                       quantizer: Optional[StreamingTileQuantizer] = None,
                       entry_offset: int = 0
                       ) -> Tuple[np.ndarray, np.ndarray]:
    """Quantise a (steps, slab) host value array row by row, one f32
    scale a row (the chunk-queue slab).  With a `quantizer`, rows map to
    consecutive entry ranges of its buffer from `entry_offset`; the last
    row's padding tail (entries past the buffer) quantises exact zeros and
    carries no residual."""
    v = np.asarray(vals2d, np.float32)
    steps, slab = v.shape
    q = np.zeros((steps, slab), np.int8)
    scales = np.zeros((steps,), np.float32)
    for s in range(steps):
        if quantizer is None:
            q[s], scales[s], _ = quantize_int8_np(v[s])
            continue
        lo = entry_offset + s * slab
        m = max(0, min(slab, quantizer.err.size - lo))
        err_row = np.zeros(slab, np.float32)
        err_row[:m] = quantizer.err[lo:lo + m]
        q[s], scales[s], new_err = quantize_int8_np(v[s], err_row)
        quantizer.err[lo:lo + m] = new_err[:m]
    return q, scales
