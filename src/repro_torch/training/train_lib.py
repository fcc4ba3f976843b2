"""The GNN train step: loss -> backward -> clip -> AdamW on a cosine
schedule (`make_gnn_train_step`, the reference's GNN factory; its LM
steps are ROADMAP A12).

PyTorch runs eagerly: the step is a plain function, the counterpart of
the reference's jitted one, over the reference's parameter layout (a
list of per-layer dicts of tensors).  On the resident backends every
aggregate in the loss is an autograd Function whose backward is a
kernel over the forward carrier (the sums' A^T G, the max backward
kernels), so one step's launches are the forward's plus the backward's.
"""
from __future__ import annotations

from typing import Callable, Optional

import torch

from repro_torch.training.optimizer import (AdamWConfig, adamw_update,
                                            clip_by_global_norm, tree_map)
from repro_torch.training.schedule import cosine_schedule


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
        leaves = tree_map(lambda p: p.detach().requires_grad_(True), params)
        with torch.enable_grad():
            loss = loss_fn(leaves, batch)
            loss.backward()
        # a parameter the loss does not reach gets a zero gradient, as
        # under jax.grad
        grads = tree_map(lambda p: (p.grad if p.grad is not None
                                    else torch.zeros_like(p)), leaves)
        with torch.no_grad():
            grads, gnorm = clip_by_global_norm(grads, opt_cfg.clip_norm)
            lr = cosine_schedule(opt_state["count"] + 1, peak_lr=peak_lr,
                                 warmup=warmup, total=total_steps)
            params, opt_state = adamw_update(opt_cfg, grads, opt_state,
                                             tree_map(torch.detach, leaves),
                                             lr)
        return params, opt_state, {"loss": loss.detach(), "grad_norm": gnorm,
                                   "lr": lr}

    return train_step
