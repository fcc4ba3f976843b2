"""Train-step factories: loss -> backward -> clip -> AdamW.

The LM steps (`make_train_step`, `make_grad_accum_train_step`,
`make_loss_fn`, `cast_params_for_compute`) keep fp32 master parameters
and compute in the config's dtype (bf16 for the assigned configs); the
GNN step (`make_gnn_train_step`) is the reference's GNN factory.

PyTorch runs eagerly: each step is a plain function, the counterpart of
the reference's jitted one, over the reference's parameter layout (a
dict tree for an LM, a list of per-layer dicts for a GNN).  On the GNN's
resident backends every aggregate in the loss is an autograd Function
whose backward is a kernel over the forward carrier (the sums' A^T G,
the max backward kernels), so one step's launches are the forward's
plus the backward's.  The LM stack reaches no kernel of its own (the
reference's is XLA).

Every step's phases are `repro_torch.tracing` spans: `step.forward`
(the loss), `step.backward` (autograd) and `step.optimizer` (the
schedule, the clip and AdamW).
"""
from __future__ import annotations

from typing import Callable, Optional

import torch

from repro_torch.nn import transformer as T
from repro_torch.tracing import span
from repro_torch.nn.config import ModelConfig
from repro_torch.training.optimizer import (AdamWConfig, adamw_update,
                                            clip_by_global_norm, tree_map)
from repro_torch.training.schedule import cosine_schedule, wsd_schedule


def cast_params_for_compute(cfg: ModelConfig, params):
    """Cast the fp32 matrix parameters to the compute dtype once, before
    the layer loop; 1-D parameters (norm scales, biases) stay fp32, as
    in the reference."""
    dt = cfg.compute_dtype
    return tree_map(
        lambda p: p.to(dt) if (isinstance(p, torch.Tensor) and p.dim() > 1
                               and p.dtype == torch.float32) else p,
        params)


def make_loss_fn(cfg: ModelConfig, sc=T.no_sc, q_chunk: int = 512,
                 loss_chunk: int = 256, remat: bool = True,
                 cast_weights: bool = True):
    def loss_fn(params, batch):
        if cast_weights:
            params = cast_params_for_compute(cfg, params)
        return T.forward_train(cfg, params, batch, sc, q_chunk, loss_chunk,
                               remat)
    return loss_fn


def value_and_grad(loss_fn: Callable, params, batch):
    """(loss, grads) of `loss_fn(params, batch)` with respect to the
    parameter tree: the loss detached, a gradient for every leaf (zeros
    where the loss does not reach one, as under `jax.grad`)."""
    leaves = tree_map(lambda p: p.detach().requires_grad_(True), params)
    with torch.enable_grad():
        with span("step.forward"):
            loss = loss_fn(leaves, batch)
        with span("step.backward"):
            loss.backward()
    grads = tree_map(lambda p: (p.grad if p.grad is not None
                                else torch.zeros_like(p)), leaves)
    return loss.detach(), grads


def _apply_update(opt_cfg, grads, opt_state, params, lr, inplace):
    with torch.no_grad():
        grads, gnorm = clip_by_global_norm(grads, opt_cfg.clip_norm,
                                           inplace=inplace)
        params, opt_state = adamw_update(
            opt_cfg, grads, opt_state, tree_map(torch.detach, params), lr,
            inplace=inplace)
    return params, opt_state, gnorm


def make_train_step(cfg: ModelConfig, opt_cfg: AdamWConfig = AdamWConfig(),
                    sc=T.no_sc, *, peak_lr: float = 3e-4,
                    warmup: int = 2000, total_steps: int = 100_000,
                    q_chunk: int = 512, loss_chunk: int = 256,
                    remat: bool = True,
                    grad_transform: Optional[Callable] = None,
                    donate: bool = False):
    """Returns train_step(params, opt_state, batch) -> (params, opt_state,
    {"loss", "grad_norm", "lr"}); `grad_transform` hooks gradient
    compression.  `batch` holds tensors on the parameters' device.  With
    `donate` the step writes the new parameters and moments into the
    given tensors (the reference launcher donates them to its jitted
    step); otherwise it returns new ones."""
    loss_fn = make_loss_fn(cfg, sc, q_chunk, loss_chunk, remat)
    sched = wsd_schedule if cfg.wsd_schedule else cosine_schedule

    def train_step(params, opt_state, batch):
        loss, grads = value_and_grad(loss_fn, params, batch)
        if grad_transform is not None:
            grads = grad_transform(grads)
        with span("step.optimizer"):
            lr = sched(opt_state["count"] + 1, peak_lr=peak_lr,
                       warmup=warmup, total=total_steps)
            params, opt_state, gnorm = _apply_update(
                opt_cfg, grads, opt_state, params, lr, donate)
        return params, opt_state, {"loss": loss, "grad_norm": gnorm,
                                   "lr": lr}

    return train_step


def make_grad_accum_train_step(cfg: ModelConfig,
                               opt_cfg: AdamWConfig = AdamWConfig(),
                               sc=T.no_sc, *, micro_steps: int = 4,
                               peak_lr: float = 3e-4, warmup: int = 2000,
                               total_steps: int = 100_000,
                               q_chunk: int = 512, loss_chunk: int = 256,
                               grad_transform: Optional[Callable] = None,
                               donate: bool = False):
    """Gradient accumulation over `micro_steps` microbatches (the batch's
    leading dimension must divide evenly): fp32 gradient sums, then one
    clip and update on their mean."""
    loss_fn = make_loss_fn(cfg, sc, q_chunk, loss_chunk)
    sched = wsd_schedule if cfg.wsd_schedule else cosine_schedule

    def train_step(params, opt_state, batch):
        def split(x):
            return x.reshape((micro_steps, x.shape[0] // micro_steps)
                             + tuple(x.shape[1:]))
        micro = tree_map(split, batch)
        gsum, lsum = None, None
        for i in range(micro_steps):
            mb = tree_map(lambda x: x[i], micro)
            lv, g = value_and_grad(loss_fn, params, mb)
            g = tree_map(lambda a: a.to(torch.float32), g)
            gsum = g if gsum is None else tree_map(torch.add, gsum, g)
            lsum = lv if lsum is None else lsum + lv
        grads = tree_map(lambda g: g / micro_steps, gsum)
        if grad_transform is not None:
            grads = grad_transform(grads)
        with span("step.optimizer"):
            lr = sched(opt_state["count"] + 1, peak_lr=peak_lr,
                       warmup=warmup, total=total_steps)
            params, opt_state, gnorm = _apply_update(
                opt_cfg, grads, opt_state, params, lr, donate)
        return params, opt_state, {"loss": lsum / micro_steps,
                                   "grad_norm": gnorm, "lr": lr}

    return train_step


def make_gnn_train_step(loss_fn: Callable, *,
                        opt_cfg: Optional[AdamWConfig] = None,
                        peak_lr: float = 5e-3, warmup: int = 20,
                        total_steps: int = 100):
    """Returns train_step(params, opt_state, batch) -> (params,
    opt_state, {"loss", "grad_norm", "lr"}) for a `loss_fn(params,
    batch)` over any resident aggregation backend.  The metrics are 0-d
    tensors on the parameters' device (reading one waits for the step).
    New parameter and moment tensors are returned; the arguments are
    not written."""
    opt_cfg = opt_cfg if opt_cfg is not None else AdamWConfig(
        weight_decay=0.01)

    def train_step(params, opt_state, batch):
        loss, grads = value_and_grad(loss_fn, params, batch)
        with span("step.optimizer"):
            lr = cosine_schedule(opt_state["count"] + 1, peak_lr=peak_lr,
                                 warmup=warmup, total=total_steps)
            params, opt_state, gnorm = _apply_update(
                opt_cfg, grads, opt_state, params, lr, False)
        return params, opt_state, {"loss": loss, "grad_norm": gnorm,
                                   "lr": lr}

    return train_step
