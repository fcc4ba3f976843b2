"""`ElasticGNNTrainer`: the mutable half of a `--gnn` training run.

It owns the prepared plan (`PreparedPlan`) and the train step behind a
stable `step()` callable, so the fault-tolerance hooks of
`FaultTolerantRunner` can swap both underneath a running loop
(`rebuild`).  The reference's hooks re-mesh the sharded ring onto the
surviving shards; the ring is not ported yet (ROADMAP A8), so here they
are the reference's no-ops off the ring, and a ring re-mesh raises.
Shard-loss errors and chaos injection come with ROADMAP A11.
"""
from __future__ import annotations

from typing import Dict

import torch

from repro_torch.core.engn import _NOT_PORTED


class ElasticGNNTrainer:
    """Owns (plan, train step) for a GNN stack on the plan's device (the
    layers' device)."""

    def __init__(self, *, layers, graph, x, y_true,
                 hidden: int, peak_lr: float, steps: int):
        self.layers = layers
        self.graph = graph
        self.x = x
        self.y_true = y_true
        self.hidden = hidden
        self.peak_lr = peak_lr
        self.steps = steps
        self.plan = None
        self._step = None
        self.stats: Dict[str, int] = {"strikes": 0}
        self.rebuild()

    def rebuild(self):
        """(Re)prepare the plan from the layers' config (and `graph`) and
        rebuild the step."""
        from repro_torch.core.engn import prepare_graph
        from repro_torch.training.train_lib import make_gnn_train_step

        plan = prepare_graph(self.graph, self.layers[0].cfg,
                             out_dim=self.hidden,
                             device=self.layers[0].device)
        if plan.backend == "tiled":
            # a budget spill: the streamed backward is not ported
            raise NotImplementedError(_NOT_PORTED["train_tiled"])
        self.plan = plan
        self._step = make_gnn_train_step(
            self.loss, peak_lr=self.peak_lr, warmup=min(20, self.steps),
            total_steps=self.steps)
        return self.plan

    def loss(self, params, batch, plan=None):
        """The node-classification loss: mean negative log-likelihood of
        the teacher's labels at the batch's vertices, through `plan`
        (the trainer's own unless given)."""
        from repro_torch.core.models import apply_stack
        plan = self.plan if plan is None else plan
        nodes = torch.as_tensor(batch["nodes"],
                                device=self.x.device).long()
        logits = apply_stack(self.layers, plan, self.x, params=params)[nodes]
        ll = torch.log_softmax(logits, -1)
        return -torch.mean(torch.gather(ll, 1, self.y_true[nodes][:, None]))

    def step(self, params, opt, batch):
        """Stable train-step callable; delegates to the current step."""
        return self._step(params, opt, batch)

    def remesh(self, num_shards: int):
        """Rebuild the ring for `num_shards` survivors (ROADMAP A8)."""
        raise NotImplementedError(_NOT_PORTED["ring"])

    def on_failure(self, exc: Exception):
        """FaultTolerantRunner hook: off the ring a failure retries with
        replay unchanged (shard loss re-meshes the ring, ROADMAP A8)."""
        return

    def on_straggler(self, step: int, dt: float):
        """FaultTolerantRunner hook: count the strike; off the ring
        nothing else happens."""
        self.stats["strikes"] += 1


__all__ = ["ElasticGNNTrainer"]
