"""Fault-tolerant step runner with straggler mitigation.

The runner wraps the train loop with:

  * checkpoint/restart — periodic atomic saves; any step-level exception
    triggers restore-from-latest and replay (data cursor included);
  * bounded retries with backoff (a flapping node shouldn't live-lock
    the job);
  * straggler mitigation — a per-step deadline (EWMA of recent step
    times x `straggler_factor`) that calls `on_straggler`;
  * an `on_failure` hook for elastic re-meshing.

The reference's runner, line for line, over the port's
`CheckpointManager`.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Dict, Optional

from repro_torch.checkpoint.manager import CheckpointManager


@dataclasses.dataclass
class FaultConfig:
    ckpt_every: int = 100
    max_retries: int = 3
    retry_backoff_s: float = 1.0
    straggler_factor: float = 3.0
    ewma_alpha: float = 0.1


class StepTimer:
    """EWMA step timer exposing the straggler deadline."""

    def __init__(self, alpha: float, factor: float,
                 clock: Callable[[], float] = time.monotonic):
        self.alpha = alpha
        self.factor = factor
        self.clock = clock
        self.ewma: Optional[float] = None

    def observe(self, dt: float):
        self.ewma = (dt if self.ewma is None
                     else (1 - self.alpha) * self.ewma + self.alpha * dt)

    def deadline(self) -> Optional[float]:
        return None if self.ewma is None else self.ewma * self.factor

    def is_straggler(self, dt: float) -> bool:
        d = self.deadline()
        return d is not None and dt > d


class FaultTolerantRunner:
    def __init__(self, step_fn: Callable, ckpt: CheckpointManager,
                 cfg: FaultConfig = FaultConfig(),
                 on_failure: Optional[Callable[[Exception], None]] = None,
                 on_straggler: Optional[Callable[[int, float], None]] = None,
                 clock: Callable[[], float] = time.monotonic,
                 sleep: Callable[[float], None] = time.sleep):
        self.step_fn = step_fn
        self.ckpt = ckpt
        self.cfg = cfg
        self.on_failure = on_failure
        self.on_straggler = on_straggler
        self.clock = clock
        self.sleep = sleep
        self.timer = StepTimer(cfg.ewma_alpha, cfg.straggler_factor, clock)
        self.stats: Dict[str, float] = {"failures": 0, "restores": 0,
                                        "stragglers": 0, "saves": 0,
                                        "lost_steps": 0, "mttr_s": 0.0}

    def run(self, state: Dict[str, Any], data_iter, num_steps: int,
            start_step: int = 0):
        """state: {"params": ..., "opt": ...}; data_iter must support
        .cursor() and .seek(cursor) for exact replay."""
        step = start_step
        retries = 0
        while step < num_steps:
            cursor0 = data_iter.cursor()
            try:
                t0 = self.clock()
                batch = next(data_iter)
                state["params"], state["opt"], metrics = self.step_fn(
                    state["params"], state["opt"], batch)
                dt = self.clock() - t0
                if self.timer.is_straggler(dt):
                    self.stats["stragglers"] += 1
                    if self.on_straggler:
                        self.on_straggler(step, dt)
                self.timer.observe(dt)
                step += 1
                retries = 0
                if step % self.cfg.ckpt_every == 0:
                    self.ckpt.save(step, state,
                                   metadata={"cursor": data_iter.cursor(),
                                             "step": step})
                    self.stats["saves"] += 1
            except KeyboardInterrupt:
                raise
            except Exception as e:  # noqa: BLE001 — that's the point
                t_fail = self.clock()
                self.stats["failures"] += 1
                retries += 1
                if retries > self.cfg.max_retries:
                    raise RuntimeError(
                        f"step {step}: exceeded {self.cfg.max_retries} "
                        f"retries") from e
                if self.on_failure:
                    self.on_failure(e)
                self.sleep(self.cfg.retry_backoff_s * retries)
                latest = self.ckpt.latest_step()
                if latest is not None:
                    failed_at = step
                    state, meta, step = self._restore(state)
                    data_iter.seek(meta.get("cursor", 0))
                    self.stats["restores"] += 1
                    self.stats["lost_steps"] += max(0, failed_at - step)
                else:
                    # no checkpoint yet: rewind the consumed batch so
                    # the retry replays exactly
                    data_iter.seek(cursor0)
                self.stats["mttr_s"] += self.clock() - t_fail
        return state, step

    def _restore(self, state_like):
        state, meta, step = self.ckpt.restore(state_like)
        return state, meta, meta.get("step", step)
