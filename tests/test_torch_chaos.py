"""The port's deterministic chaos injection (`repro_torch.distributed.
chaos`, DESIGN.md C13) against the reference: `tests/test_chaos.py` case
for case (seeded plans, the fire-exactly-once contract, virtual-clock
stragglers, the three torn checkpoint styles against the port's
`CheckpointManager`, wrapped callables), plans equal to the reference's
event for event, and `tests/test_elastic_ring.py::
test_chaos_schedule_against_8_shard_ring` on the port's one-controller
ring (8 shards co-located on the CPU)."""
import _torch_cpu  # noqa: F401  (this worker's share of the cores)
import dataclasses
import json
import tempfile

import numpy as np
import pytest

from repro.distributed import chaos as j_chaos
from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.data.pipeline import SyntheticTokenStream
from repro_torch.distributed.chaos import (KINDS, TORN_STYLES, ChaosInjector,
                                           FaultEvent, FaultPlan,
                                           ShardLossError, TransientError,
                                           VirtualClock)
from repro_torch.distributed.fault import FaultConfig, FaultTolerantRunner


# ------------------------------------------------------------------ plan
def test_fault_plan_sample_deterministic():
    a = FaultPlan.sample(11, 100)
    b = FaultPlan.sample(11, 100)
    assert a == b
    c = FaultPlan.sample(12, 100)
    assert a != c
    assert sorted(e.kind for e in a.events) == sorted(
        ["shard_loss", "transient", "straggler", "torn_ckpt"])
    steps = [e.step for e in a.events]
    assert len(set(steps)) == len(steps)        # distinct steps
    assert all(1 <= s < 100 for s in steps)


@pytest.mark.parametrize("seed,steps", [(0, 12), (3, 20), (11, 100),
                                        (12, 100), (7, 5), (2024, 1000)])
def test_fault_plan_equals_the_reference(seed, steps):
    """Event for event, and the injector's description equal to the
    reference's up to `fired` (nothing fired yet: equal outright)."""
    ours, ref = FaultPlan.sample(seed, steps), j_chaos.FaultPlan.sample(
        seed, steps)
    assert ours.seed == ref.seed
    assert [dataclasses.asdict(e) for e in ours.events] == [
        dataclasses.asdict(e) for e in ref.events]
    assert (ChaosInjector(ours).describe()
            == j_chaos.ChaosInjector(ref).describe())


def test_fault_plan_sample_kinds_subset_equals_the_reference():
    kw = dict(kinds=("torn_ckpt", "straggler"), straggler_delay_s=7.5,
              lost_shards=2)
    ours = FaultPlan.sample(5, 40, **kw)
    ref = j_chaos.FaultPlan.sample(5, 40, **kw)
    assert [dataclasses.asdict(e) for e in ours.events] == [
        dataclasses.asdict(e) for e in ref.events]
    assert (KINDS, TORN_STYLES) == (j_chaos.KINDS, j_chaos.TORN_STYLES)


def test_fault_event_validation():
    with pytest.raises(ValueError, match="kind"):
        FaultEvent(1, "meteor_strike")
    with pytest.raises(ValueError, match="torn style"):
        FaultEvent(1, "torn_ckpt", style="shredded")


# ---------------------------------------------------------- fire-once
def _replay(inj, calls):
    """Drive a wrapped counting step `calls` times, recording raises."""
    n = {"n": 0}

    def step():
        n["n"] += 1
        return n["n"]

    wrapped = inj.wrap_step(step)
    out, raised = [], []
    for _ in range(calls):
        try:
            out.append(wrapped())
        except ShardLossError as e:
            raised.append(("shard_loss", e.lost_shards))
        except TransientError:
            raised.append(("transient", None))
    return out, raised


def test_events_fire_exactly_once_across_replays():
    """Retries re-invoke the wrapped step; each event still fires once."""
    plan = FaultPlan((FaultEvent(2, "transient"),
                      FaultEvent(4, "shard_loss", lost_shards=3)))
    inj = ChaosInjector(plan)
    out, raised = _replay(inj, 10)
    assert raised == [("transient", None), ("shard_loss", 3)]
    assert inj.stats["transient"] == 1 and inj.stats["shard_loss"] == 1
    assert len(out) == 8                        # the other calls ran


def test_injector_bookkeeping_equals_the_reference():
    """The sampled plan replayed against a step in both packages: the
    same calls raise, and the stats and `fired` are equal."""
    plan = FaultPlan.sample(3, 20)
    ours = ChaosInjector(plan, clock=VirtualClock())
    ref = j_chaos.ChaosInjector(j_chaos.FaultPlan.sample(3, 20),
                                clock=j_chaos.VirtualClock())
    out, raised = _replay(ours, 20)

    n = {"n": 0}

    def step():
        n["n"] += 1
        return n["n"]

    wrapped, j_out, j_raised = ref.wrap_step(step), [], []
    for _ in range(20):
        try:
            j_out.append(wrapped())
        except j_chaos.ShardLossError as e:
            j_raised.append(("shard_loss", e.lost_shards))
        except j_chaos.TransientError:
            j_raised.append(("transient", None))
    assert (out, raised) == (j_out, j_raised)
    assert ours.stats == ref.stats and ours.clock() == ref.clock()
    assert json.loads(ours.describe()) == json.loads(ref.describe())


def test_shard_loss_error_payload():
    e = ShardLossError(lost_shards=2)
    assert e.lost_shards == 2 and "2 shard" in str(e)


# ----------------------------------------------------- virtual clock
def test_virtual_clock_straggler_detected():
    """A scheduled straggler stretches the step on the virtual clock
    far past the EWMA deadline; the runner's hook fires."""
    clock = VirtualClock()
    plan = FaultPlan((FaultEvent(6, "straggler", delay_s=50.0),))
    inj = ChaosInjector(plan, clock=clock, base_step_s=1.0)
    flagged = []

    def step(params, opt, batch):
        return params + 1, opt, {}

    mgr = CheckpointManager(tempfile.mkdtemp(prefix="chaos_test_"))
    r = FaultTolerantRunner(
        inj.wrap_step(step), mgr, FaultConfig(),
        on_straggler=lambda s, dt: flagged.append((s, dt)),
        clock=clock, sleep=clock.sleep)
    data = SyntheticTokenStream(10, 1, 4)
    state, last = r.run({"params": 0, "opt": 0}, data, num_steps=10)
    assert last == 10 and state["params"] == 10
    assert r.stats["stragglers"] == 1
    assert len(flagged) == 1
    (s, dt), = flagged
    assert s == 6 and dt > 50.0


# ------------------------------------------------------ torn writes
def _tree(v=0.0):
    return {"params": {"w": np.full((2, 2), v, np.float32)}}


@pytest.mark.parametrize("style", ["tmp", "manifest", "leaf"])
def test_torn_checkpoint_styles_leave_recoverable_state(tmp_path, style):
    """Every torn style leaves the newest complete checkpoint
    restorable — the save is sacrificed, never the history."""
    mgr = CheckpointManager(tmp_path, keep=5)
    plan = FaultPlan((FaultEvent(0, "torn_ckpt", style=style),))
    inj = ChaosInjector(plan)
    wrapped = inj.wrap_checkpoint(mgr)
    mgr.save(1, _tree(1.0), metadata={"cursor": 1})
    wrapped.save(2, _tree(2.0), metadata={"cursor": 2})   # torn
    assert inj.stats["torn_ckpt"] == 1
    if style == "leaf":
        with pytest.warns(RuntimeWarning, match="corrupt"):
            out, meta, step = mgr.restore(_tree())
    else:
        out, meta, step = mgr.restore(_tree())
    assert step == 1 and meta["cursor"] == 1
    np.testing.assert_array_equal(out["params"]["w"],
                                  np.full((2, 2), 1.0, np.float32))
    # the injector is transparent again after the event fired
    wrapped.save(3, _tree(3.0), metadata={"cursor": 3})
    mgr.wait()
    _, meta, step = mgr.restore(_tree())
    assert step == 3 and meta["cursor"] == 3


@pytest.mark.parametrize("style", ["tmp", "manifest", "leaf"])
def test_torn_checkpoint_leaves_the_references_files(tmp_path, style):
    """The same torn save in both packages leaves the same files, and
    the reference's manager reads the port's directory as it reads its
    own (the same newest complete step)."""
    from repro.checkpoint.manager import CheckpointManager as JManager
    trees = {}
    for who, mgr_cls, inj_cls, plan_cls, ev_cls in (
            ("port", CheckpointManager, ChaosInjector, FaultPlan,
             FaultEvent),
            ("ref", JManager, j_chaos.ChaosInjector, j_chaos.FaultPlan,
             j_chaos.FaultEvent)):
        d = tmp_path / who
        mgr = mgr_cls(d, keep=5)
        inj = inj_cls(plan_cls((ev_cls(0, "torn_ckpt", style=style),)))
        mgr.save(1, _tree(1.0), metadata={"cursor": 1})
        inj.wrap_checkpoint(mgr).save(2, _tree(2.0), metadata={"cursor": 2})
        trees[who] = sorted(str(p.relative_to(d)) for p in d.rglob("*"))
    assert trees["port"] == trees["ref"]
    assert (JManager(tmp_path / "port").latest_step()
            == CheckpointManager(tmp_path / "ref").latest_step())


def test_torn_checkpoint_passthrough_methods(tmp_path):
    mgr = CheckpointManager(tmp_path)
    inj = ChaosInjector(FaultPlan())
    wrapped = inj.wrap_checkpoint(mgr)
    wrapped.save(1, _tree(1.0))
    assert wrapped.latest_step() == 1           # __getattr__ passthrough
    assert wrapped.all_steps() == [1]


# ------------------------------------------------- wrapped callables
def test_wrap_callable_fails_at_scheduled_calls():
    inj = ChaosInjector(FaultPlan())
    fn = inj.wrap_callable(lambda v: v * 2, calls=(1, 3))
    out = []
    for k in range(5):
        try:
            out.append(fn(k))
        except TransientError:
            out.append("err")
    assert out == [0, "err", 4, "err", 8]
    assert inj.stats["transient"] == 2


def test_wrap_callable_shard_loss_kind():
    inj = ChaosInjector(FaultPlan())
    fn = inj.wrap_callable(lambda: 1, kind="shard_loss", calls=(0,))
    with pytest.raises(ShardLossError):
        fn()
    assert fn() == 1 and inj.stats["shard_loss"] == 1


# ------------------------------------ the acceptance scenario, 8 shards
def _build(backend, steps, **kw):
    from repro_torch.launch.train import build_gnn
    return build_gnn(model="gcn", dataset="pubmed", backend=backend,
                     steps=steps, hidden=8, batch=64, max_vertices=300,
                     max_edges=2000, device="cpu", **kw)


def test_chaos_schedule_against_8_shard_ring(tmp_path):
    """All four fault kinds against a ring-8 run on the port's
    one-controller ring: it completes, re-meshes to 6 survivors and
    lands where the fault-free segment run does (the reference test's
    plan and assertions)."""
    steps = 12
    step, state, data, _, _ = _build("segment", steps)
    ps, opt, seg = state["params"], state["opt"], []
    for _ in range(steps):
        ps, opt, m = step(ps, opt, next(data))
        seg.append(float(m["loss"]))

    step, state, data, gd, aux = _build("ring", steps, ring_shards=8)
    trainer = aux["trainer"]
    assert gd.backend == "ring" and gd.meta["shards"] == 8
    losses = []

    def logged(ps, opt, batch):
        ps, opt, m = step(ps, opt, batch)
        losses.append(float(m["loss"]))
        return ps, opt, m

    plan = FaultPlan((
        FaultEvent(3, "transient"),
        FaultEvent(5, "torn_ckpt", style="leaf"),
        FaultEvent(7, "shard_loss", lost_shards=2),
        FaultEvent(10, "straggler", delay_s=50.0),
    ), seed=0)
    clock = VirtualClock()
    inj = ChaosInjector(plan, clock=clock, base_step_s=1.0)
    mgr = CheckpointManager(tmp_path, keep=3)
    runner = FaultTolerantRunner(
        inj.wrap_step(logged), inj.wrap_checkpoint(mgr),
        FaultConfig(ckpt_every=2, retry_backoff_s=0.5),
        on_failure=trainer.on_failure, on_straggler=trainer.on_straggler,
        clock=clock, sleep=clock.sleep)
    with pytest.warns(RuntimeWarning, match="corrupt"):
        state, last = runner.run(state, data, num_steps=steps)
    mgr.wait()

    assert inj.stats == {"shard_loss": 1, "transient": 1,
                         "straggler": 1, "torn_ckpt": 1}
    assert last == steps
    assert int(state["opt"]["count"]) == steps
    assert trainer.stats["remesh_count"] == 1
    assert trainer.plan.backend == "ring"
    assert trainer.plan.meta["shards"] == 6
    assert runner.stats["failures"] == 2        # transient + shard loss
    assert runner.stats["restores"] >= 1
    assert runner.stats["lost_steps"] >= 1
    assert runner.stats["mttr_s"] > 0
    assert runner.stats["stragglers"] == 1
    assert all(np.isfinite(losses))
    assert losses[-1] < losses[0]
    np.testing.assert_allclose(losses[-1], seg[-1], rtol=5e-3, atol=1e-4)
