"""Fault classes of the training stack's fault injection.

The reference's error classes, so that a failure hook can tell a lost
shard from a step-level blip: `ElasticGNNTrainer.on_failure` shrinks the
ring by `ShardLossError.lost_shards`.  The seeded schedule that raises
them (`FaultPlan`, `ChaosInjector`, `VirtualClock`) is not ported yet
(ROADMAP A11).
"""
from __future__ import annotations


class InjectedFault(RuntimeError):
    """Base class for all injector-raised faults."""


class ShardLossError(InjectedFault):
    """A device shard (or host) died; the survivor count shrank.

    Carries `lost_shards` so an elastic `on_failure` hook can rebuild
    the ring plan for the surviving shard count.
    """

    def __init__(self, lost_shards: int = 1, message: str = ""):
        super().__init__(message or f"lost {lost_shards} shard(s)")
        self.lost_shards = int(lost_shards)


__all__ = ["InjectedFault", "ShardLossError"]
