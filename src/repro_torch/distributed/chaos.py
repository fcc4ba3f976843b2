"""Deterministic fault injection for the training and serving stacks.

A `FaultPlan` is a seeded, fully deterministic schedule of faults —
shard loss, transient step exceptions, straggler delays, torn
checkpoint writes — and a `ChaosInjector` replays that schedule against
any step function, checkpoint manager or serving stage without
touching the happy path: the wrapped objects behave identically when
no event is due.  Time is virtual (`VirtualClock`), so straggler
episodes and MTTR measurements are exact and repeatable.

Event steps index step-function invocations (attempt count), not
logical training steps: retries after a failure advance the counter, so
each event fires exactly once per run however many replays the
recovery path performs (DESIGN.md C13).

The reference's module, line for line: plans are drawn by numpy's
`default_rng(seed)` as the reference draws them, so the same seed gives
the same plan event for event, and torn saves corrupt the port's
`CheckpointManager` layout (the reference's, file for file).
"""
from __future__ import annotations

import dataclasses
import json
from typing import Callable, Dict, Iterable, Optional, Tuple

import numpy as np

KINDS = ("shard_loss", "transient", "straggler", "torn_ckpt")
TORN_STYLES = ("tmp", "manifest", "leaf")


class InjectedFault(RuntimeError):
    """Base class for all injector-raised faults."""


class TransientError(InjectedFault):
    """A step-level blip: retry-with-replay is the correct response."""


class ShardLossError(InjectedFault):
    """A device shard (or host) died; the survivor count shrank.

    Carries `lost_shards` so an elastic `on_failure` hook can rebuild
    the ring plan for the surviving shard count.
    """

    def __init__(self, lost_shards: int = 1, message: str = ""):
        super().__init__(message or f"lost {lost_shards} shard(s)")
        self.lost_shards = int(lost_shards)


@dataclasses.dataclass(frozen=True)
class FaultEvent:
    """One scheduled fault.

    step: the 0-based step-function invocation index at which the event
          fires (for torn_ckpt: the first save at or after this index).
    kind: one of ("shard_loss", "transient", "straggler", "torn_ckpt").
    lost_shards: shard_loss only — how many shards die.
    delay_s: straggler only — extra virtual seconds added to the step.
    style: torn_ckpt only — "tmp" (crash mid-write, leftover temp dir,
           no checkpoint produced), "manifest" (truncated manifest
           JSON), or "leaf" (complete manifest, missing leaf file).
    """

    step: int
    kind: str
    lost_shards: int = 1
    delay_s: float = 0.0
    style: str = "tmp"

    def __post_init__(self):
        if self.kind not in KINDS:
            raise ValueError(f"unknown fault kind {self.kind!r}")
        if self.kind == "torn_ckpt" and self.style not in TORN_STYLES:
            raise ValueError(f"unknown torn style {self.style!r}")


@dataclasses.dataclass(frozen=True)
class FaultPlan:
    """An ordered, seeded fault schedule (the chaos plan)."""

    events: Tuple[FaultEvent, ...] = ()
    seed: int = 0

    @staticmethod
    def sample(seed: int, num_steps: int, *,
               kinds: Iterable[str] = KINDS,
               straggler_delay_s: float = 50.0,
               lost_shards: int = 1) -> "FaultPlan":
        """One event of each requested kind at distinct random steps.

        Deterministic in `seed`: the same (seed, num_steps) always
        yields the same plan.  Events land in the middle 80% of the run
        so warmup steps establish the EWMA baseline and there is at
        least one step after the last event.
        """
        kinds = tuple(kinds)
        rng = np.random.default_rng(seed)
        lo = max(1, num_steps // 10)
        hi = max(lo + len(kinds), num_steps - max(1, num_steps // 10))
        steps = sorted(rng.choice(np.arange(lo, hi), size=len(kinds),
                                  replace=False).tolist())
        events = []
        for at, kind in zip(steps, kinds):
            if kind == "straggler":
                events.append(FaultEvent(at, kind,
                                         delay_s=straggler_delay_s))
            elif kind == "shard_loss":
                events.append(FaultEvent(at, kind,
                                         lost_shards=lost_shards))
            elif kind == "torn_ckpt":
                style = TORN_STYLES[int(rng.integers(len(TORN_STYLES)))]
                events.append(FaultEvent(at, kind, style=style))
            else:
                events.append(FaultEvent(at, kind))
        return FaultPlan(events=tuple(events), seed=seed)


class VirtualClock:
    """A manually advanced clock, pluggable wherever the stack accepts
    an injectable `clock` / `sleep` (FaultTolerantRunner, StepTimer)."""

    def __init__(self, t0: float = 0.0):
        self.t = float(t0)

    def __call__(self) -> float:
        return self.t

    def advance(self, dt: float):
        self.t += float(dt)

    def sleep(self, dt: float):  # drop-in for time.sleep
        self.advance(dt)


class _TornCheckpointProxy:
    """Checkpoint-manager proxy that tears scheduled saves.

    Non-scheduled saves pass straight through; a due `torn_ckpt` event
    replaces (or corrupts) exactly one save, then the proxy is
    transparent again.
    """

    def __init__(self, mgr, injector: "ChaosInjector"):
        self._mgr = mgr
        self._inj = injector

    def __getattr__(self, name):
        return getattr(self._mgr, name)

    def save(self, step: int, tree, metadata: Optional[dict] = None):
        ev = self._inj._due_torn()
        if ev is None:
            return self._mgr.save(step, tree, metadata=metadata)
        self._inj._fire(ev)
        if ev.style == "tmp":
            # crash mid-write: leftover dot-prefixed temp dir, no
            # checkpoint produced for this step at all
            tmp = self._mgr.dir / f".tmp_step_{step}_torn"
            tmp.mkdir(parents=True, exist_ok=True)
            (tmp / "00000.npy").write_bytes(b"\x93NUMPY torn")
            return None
        # write a real checkpoint, then corrupt it in place
        self._mgr.save(step, tree, metadata=metadata)
        self._mgr.wait()
        d = self._mgr.dir / f"step_{step:010d}"
        if ev.style == "manifest":
            mf = d / "manifest.json"
            mf.write_text(mf.read_text()[: max(4, len(mf.read_text()) // 3)])
        else:  # "leaf": manifest claims complete but a leaf is gone
            leaves = sorted(d.glob("*.npy"))
            if leaves:
                leaves[0].unlink()
        return None


class ChaosInjector:
    """Replays a `FaultPlan` against wrapped step fns / checkpoint
    managers / serving callables.  Each event fires exactly once."""

    def __init__(self, plan: FaultPlan, clock: Optional[VirtualClock] = None,
                 base_step_s: float = 1.0):
        self.plan = plan
        self.clock = clock
        self.base_step_s = float(base_step_s)
        self._calls = 0
        self._fired: set = set()
        self.stats: Dict[str, int] = {k: 0 for k in KINDS}

    # ------------------------------------------------------- internals
    def _due(self, kind: str) -> Optional[FaultEvent]:
        for i, ev in enumerate(self.plan.events):
            if i in self._fired or ev.kind != kind:
                continue
            if ev.step <= self._calls:
                self._fired.add(i)  # mark before raising — fire once
                self.stats[kind] += 1
                return ev
        return None

    def _due_torn(self) -> Optional[FaultEvent]:
        for i, ev in enumerate(self.plan.events):
            if i in self._fired or ev.kind != "torn_ckpt":
                continue
            if ev.step <= self._calls:
                return ev
        return None

    def _fire(self, ev: FaultEvent):
        i = self.plan.events.index(ev)
        self._fired.add(i)
        self.stats[ev.kind] += 1

    # -------------------------------------------------------- wrappers
    def wrap_step(self, step_fn: Callable) -> Callable:
        """Wrap a train-step fn: raises shard-loss / transient faults
        before running the step (the step is lost, recovery replays it)
        and stretches straggler steps on the virtual clock."""

        def chaotic_step(*args, **kwargs):
            ev = self._due("shard_loss")
            if ev is not None:
                self._calls += 1
                raise ShardLossError(ev.lost_shards)
            ev = self._due("transient")
            if ev is not None:
                self._calls += 1
                raise TransientError(f"injected transient at call "
                                     f"{self._calls - 1}")
            ev = self._due("straggler")
            out = step_fn(*args, **kwargs)
            if self.clock is not None:
                self.clock.advance(self.base_step_s)
                if ev is not None:
                    self.clock.advance(ev.delay_s)
            self._calls += 1
            return out

        return chaotic_step

    def wrap_checkpoint(self, mgr) -> _TornCheckpointProxy:
        """Wrap a CheckpointManager so scheduled saves are torn."""
        return _TornCheckpointProxy(mgr, self)

    def wrap_callable(self, fn: Callable, *, kind: str = "transient",
                      calls: Iterable[int] = ()) -> Callable:
        """Generic wrapper for serving stages: raise at the given
        0-based call indices (independent of the step schedule)."""
        fail_at = frozenset(int(c) for c in calls)
        counter = {"n": 0}

        def chaotic(*args, **kwargs):
            k = counter["n"]
            counter["n"] += 1
            if k in fail_at:
                self.stats[kind] = self.stats.get(kind, 0) + 1
                if kind == "shard_loss":
                    raise ShardLossError(1, f"injected at call {k}")
                raise TransientError(f"injected {kind} at call {k}")
            return fn(*args, **kwargs)

        return chaotic

    # ------------------------------------------------------ reporting
    def describe(self) -> str:
        return json.dumps({
            "seed": self.plan.seed,
            "events": [dataclasses.asdict(e) for e in self.plan.events],
            "fired": sorted(self._fired),
            "stats": self.stats,
        }, indent=2)


__all__ = [
    "KINDS", "TORN_STYLES",
    "ChaosInjector", "FaultEvent", "FaultPlan", "InjectedFault",
    "ShardLossError", "TransientError", "VirtualClock",
]
