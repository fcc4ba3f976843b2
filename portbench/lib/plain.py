"""Plain PyTorch pieces the references share: the sparse aggregate, the
products at a stated precision, the degree order, the loss, and the
optimizer and schedule the training cells state.  They import nothing of
the port: the optimizer and the schedule are written out again from
their published form (AdamW, Loshchilov & Hutter 2019, with global-norm
clipping; a linear warmup into a cosine decay to a tenth of the peak).
"""
from __future__ import annotations

import contextlib
import math
import warnings
from typing import Callable, Dict, List, Sequence, Tuple

import torch

Params = List[Dict[str, torch.Tensor]]


def round_tf32(t: torch.Tensor) -> torch.Tensor:
    """float32 cut to TF32's 10-bit mantissa (the low 13 bits dropped,
    toward zero): what a TF32 tensor core reads of a float32 register."""
    return (t.contiguous().view(torch.int32) & ~0x1FFF).view(torch.float32)


@contextlib.contextmanager
def tf32_products(on: bool):
    """TF32 for the card's float32 products while inside (the control's
    precision); off again on leaving."""
    old = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = on
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = old


class _RoundedMM(torch.autograd.Function):
    """a @ b with TF32-rounded inputs, its backward's products too."""

    @staticmethod
    def forward(ctx, a, b):
        ctx.save_for_backward(a, b)
        return round_tf32(a) @ round_tf32(b)

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        g = round_tf32(g)
        return g @ round_tf32(b).T, round_tf32(a).T @ g


def mm(a: torch.Tensor, b: torch.Tensor, precision: str) -> torch.Tensor:
    """a @ b in float32 ("fp32") or with TF32 inputs ("tf32": the card's
    TF32 products, or on the CPU, which has none, the inputs rounded to
    TF32 and multiplied in float32)."""
    if precision == "fp32":      # float64 inputs stay float64 (the witness)
        return a @ b
    if precision != "tf32":
        raise ValueError(precision)
    if a.is_cuda:
        with tf32_products(True):
            return a @ b
    return _RoundedMM.apply(a, b)


def sparse_pair(rows: torch.Tensor, cols: torch.Tensor, val: torch.Tensor,
                n: int) -> Tuple[torch.Tensor, torch.Tensor, int]:
    """(A, A^T) as CSR matrices from COO triples, duplicates summed, and
    the number of merged entries."""
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)    # "beta" notices
        a = torch.sparse_coo_tensor(torch.stack([rows, cols]), val,
                                    (n, n)).coalesce()
        nnz = int(a._nnz())
        at = torch.sparse_coo_tensor(a.indices().flip(0), a.values(),
                                     (n, n)).coalesce()
        return a.to_sparse_csr(), at.to_sparse_csr(), nnz


class SparseAggregate(torch.autograd.Function):
    """Y = A H, and dH = A^T dY, each one sparse product.  (The
    calibration's planted fault passes A as `at`: A G in place of
    A^T G.)"""

    @staticmethod
    def forward(ctx, h, a, at):
        ctx.at = at
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", UserWarning)
            return torch.sparse.mm(a, h)

    @staticmethod
    def backward(ctx, g):
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", UserWarning)
            return torch.sparse.mm(ctx.at, g.contiguous()), None, None


class GradScale(torch.autograd.Function):
    """The identity, whose backward multiplies the gradient by `scale`:
    the calibration's planted fault "a gradient returned scaled"."""

    @staticmethod
    def forward(ctx, x, scale: float):
        ctx.scale = scale
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g * ctx.scale, None


class EdgeSumTransposed(torch.autograd.Function):
    """out[dst] += val * msg, as `index_add` computes it, but with the
    backward taken at the edges' sources, d msg = val * G[src], in place
    of their destinations: the calibration's planted fault "A G in place
    of A^T G" for an edge-wise aggregate."""

    @staticmethod
    def forward(ctx, msg, dst, src, val, n: int):
        ctx.save_for_backward(src, val)
        out = torch.zeros((n, msg.shape[1]), dtype=msg.dtype,
                          device=msg.device)
        return out.index_add(0, dst, msg * val[:, None])

    @staticmethod
    def backward(ctx, g):
        src, val = ctx.saved_tensors
        return g[src] * val[:, None], None, None, None, None


def distinct(key: torch.Tensor) -> int:
    return int(torch.unique(key).numel())


def degree_order(src: torch.Tensor, dst: torch.Tensor, n: int
                 ) -> torch.Tensor:
    """order[new_id] = old_id: vertices by descending total degree (in +
    out, multi-edges counted), ties by id: the relabelling EnGN's DAVC
    applies, worked out again from the raw edges."""
    deg = (torch.bincount(src.long(), minlength=n)
           + torch.bincount(dst.long(), minlength=n))
    return torch.sort(-deg, stable=True).indices


def nll(logits: torch.Tensor, labels: torch.Tensor,
        nodes: torch.Tensor) -> torch.Tensor:
    """Mean negative log-likelihood of the labels at `nodes`."""
    ll = torch.log_softmax(logits[nodes], -1)
    return -torch.mean(torch.gather(ll, 1, labels[nodes][:, None]))


def cosine_lr(step: int, peak: float, warmup: int, total: int,
              final_frac: float = 0.1) -> float:
    if step < warmup:
        return peak * step / max(warmup, 1)
    prog = min(max((step - warmup) / max(total - warmup, 1), 0.0), 1.0)
    return peak * (final_frac
                   + (1 - final_frac) * 0.5 * (1 + math.cos(math.pi * prog)))


def train_steps(forward: Callable[[Params], torch.Tensor], params: Params,
                labels: torch.Tensor, batches: Sequence[torch.Tensor],
                traffic: Dict) -> Tuple[List[float], Params, Params]:
    """Steps of full-graph training, one per labelled set in `batches`:
    loss, gradient, global-norm clip, AdamW (decay on tensors of more
    than one dimension, bias correction on the step count), from a copy
    of `params`.  Returns (each step's loss, the first step's clipped
    gradient, the parameters after the last step)."""
    opt = traffic["optimizer"]
    b1, b2, eps, wd = opt["b1"], opt["b2"], opt["eps"], opt["weight_decay"]
    params = [{k: v.detach().clone() for k, v in p.items()} for p in params]
    keys = [(i, k) for i, p in enumerate(params) for k in sorted(p)]
    m = {key: torch.zeros_like(params[key[0]][key[1]]) for key in keys}
    v = {key: torch.zeros_like(params[key[0]][key[1]]) for key in keys}
    losses, first = [], None
    for step, nodes in enumerate(batches, start=1):
        leaves = [params[i][k].requires_grad_(True) for i, k in keys]
        with torch.enable_grad():
            loss = nll(forward(params), labels, nodes)
            grads = torch.autograd.grad(loss, leaves)
        losses.append(float(loss.detach()))
        with torch.no_grad():
            norm = torch.sqrt(sum(torch.sum(g * g) for g in grads))
            scale = torch.clamp(opt["clip_norm"] / torch.clamp_min(norm, 1e-9),
                                max=1.0)
            grads = [g * scale for g in grads]
            if first is None:
                first = [{} for _ in params]
                for (i, k), g in zip(keys, grads):
                    first[i][k] = g.clone()
            lr = cosine_lr(step, traffic["peak_lr"], traffic["warmup"],
                           traffic["total_steps"])
            bc1, bc2 = 1 - b1 ** step, 1 - b2 ** step
            for (i, k), g in zip(keys, grads):
                p = params[i][k].detach()
                m[i, k] = b1 * m[i, k] + (1 - b1) * g
                v[i, k] = b2 * v[i, k] + (1 - b2) * g * g
                upd = (m[i, k] / bc1) / (torch.sqrt(v[i, k] / bc2) + eps)
                decay = wd if p.dim() > 1 else 0.0
                params[i][k] = p - lr * (upd + decay * p)
    return losses, first, params
