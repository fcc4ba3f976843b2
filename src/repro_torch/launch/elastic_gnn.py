"""`ElasticGNNTrainer`: the mutable half of a `--gnn` training run.

It owns the prepared plan (`PreparedPlan`) and the train step behind a
stable `step()` callable, so the fault-tolerance hooks of
`FaultTolerantRunner` can swap both underneath a running loop:

  * `on_failure`: a `ShardLossError` on the ring rebuilds the plan for
    the surviving shard count (`remesh`); when the survivors cannot hold
    the per-shard footprint under `device_budget_bytes`, the budget gate
    degrades the plan to the streamed `tiled` backend and training goes
    on through its streamed backward.  Any other failure retries with
    replay, unchanged.
  * `on_straggler`: `strike_limit` straggler episodes shrink the ring by
    one shard (never below one).

Checkpoints hold the parameters and optimizer state only, so the
runner's restore-and-replay works unchanged across a re-mesh.  The
seeded chaos schedule (`distributed/chaos.py`, `launch/train.py
--chaos-seed`) raises these faults.
"""
from __future__ import annotations

import time
from typing import Any, Dict, Optional

import torch

from repro_torch.distributed.chaos import ShardLossError


class ElasticGNNTrainer:
    """Owns (plan, train step) for a GNN stack on the plan's device (the
    layers' device) and re-meshes the ring on demand."""

    def __init__(self, *, layers, graph, x, y_true,
                 hidden: int, peak_lr: float, steps: int,
                 strike_limit: int = 3):
        self.layers = layers
        self.graph = graph
        self.x = x
        self.y_true = y_true
        self.hidden = hidden
        self.peak_lr = peak_lr
        self.steps = steps
        self.strike_limit = int(strike_limit)
        self.plan = None
        self._step = None
        self.stats: Dict[str, Any] = {
            "remesh_count": 0, "remesh_s": 0.0, "strikes": 0,
            "degraded": 0, "shards": None,
        }
        self.rebuild()

    @property
    def backend(self) -> Optional[str]:
        return None if self.plan is None else self.plan.backend

    @property
    def shards(self) -> Optional[int]:
        """Current ring shard count (None when the plan is not a ring)."""
        if self.plan is None or self.plan.backend != "ring":
            return None
        return self.plan.meta.get("shards")

    def rebuild(self, num_shards: Optional[int] = None):
        """(Re)prepare the plan from the layers' config (and `graph`) and
        rebuild the step.  `num_shards` re-targets the ring at that many
        survivors; the budget gate may still degrade the plan to the
        streamed `tiled` backend."""
        from repro_torch.core.engn import prepare_graph
        from repro_torch.training.train_lib import make_gnn_train_step

        if num_shards is not None:
            for layer in self.layers:
                layer.cfg.ring_shards = int(num_shards)
        self.plan = prepare_graph(self.graph, self.layers[0].cfg,
                                  out_dim=self.hidden,
                                  device=self.layers[0].device)
        self._step = make_gnn_train_step(
            self.loss, peak_lr=self.peak_lr, warmup=min(20, self.steps),
            total_steps=self.steps)
        self.stats["shards"] = self.shards
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
        """Rebuild for `num_shards` survivors (at least 1), recording the
        recovery time."""
        if self.plan is not None and self.plan.device.type == "cuda":
            torch.cuda.synchronize(self.plan.device)
        t0 = time.perf_counter()
        self.rebuild(num_shards=max(1, int(num_shards)))
        self.stats["remesh_s"] += time.perf_counter() - t0
        self.stats["remesh_count"] += 1
        if self.plan.backend != "ring":
            self.stats["degraded"] += 1
        self.stats["strikes"] = 0
        return self.plan

    def on_failure(self, exc: Exception):
        """FaultTolerantRunner hook: shard loss shrinks the ring to the
        survivor count; other failures retry with replay unchanged."""
        if not isinstance(exc, ShardLossError):
            return
        if self.layers[0].cfg.backend != "ring":
            return          # shard loss means something only on the ring
        current = self.shards or self.layers[0].cfg.ring_shards or 1
        self.remesh(max(1, current - exc.lost_shards))

    def on_straggler(self, step: int, dt: float):
        """FaultTolerantRunner hook: `strike_limit` straggler episodes
        shrink the ring by one (evict the chronically slow shard)."""
        self.stats["strikes"] += 1
        if self.layers[0].cfg.backend != "ring":
            return
        current = self.shards
        if (self.stats["strikes"] >= self.strike_limit
                and current is not None and current > 1):
            self.remesh(current - 1)


__all__ = ["ElasticGNNTrainer"]
