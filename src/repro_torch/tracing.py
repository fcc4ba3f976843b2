"""Named spans and counters inside the port, on the profiler's clock.

    from repro_torch import tracing

    with torch.profiler.profile(activities=[CPU, CUDA]) as prof:
        apply_stack(layers, plan, x)          # or a train step
    tracing.report()   # {"engn.aggregate": {"calls", "host_s", "device_s"}}

An operator sees the spans by running any `torch.profiler` around a
call: each span is then a `record_function` range, so it lands in the
exported Chrome trace as a `user_annotation` on the device trace's
clock, nested under its parent, and its host seconds, its calls and
(where CUDA is initialised) the device seconds between a pair of CUDA
events on the current stream go into an in-memory table that
`report()` returns.  `reset()` clears the table.

- `span(name)`: the hot path's span.  With no profiler recording it is
  one flag check and returns a shared no-op context: no
  `record_function`, no clock read, no CUDA event.
- `stage(name)`: set-up only (a plan, a relabel, an upload), never on a
  per-iteration path.  It always adds its host seconds to the table and
  is also a span when a profiler records.
- `count(name, n)`: adds `n` to the calls of `name`.
- `device_counter(name, device)`: one int64 on the device that a kernel
  adds `name`'s counts into, made (zero-filled) at the first call and
  kept, so that later calls cost no device operation; what it gained
  since the last `report()` joins the calls of `name` there.
- `recording()`: whether a profiler records, for a count that is taken
  only then.

No span synchronises or reads back, on or off; `report()` synchronises
once to resolve the events recorded since the last report.

The spans and the metrics that read them (`portbench/metrics/`):

| name | where | metric |
|---|---|---|
| `engn.extract`, `engn.aggregate`, `engn.update` | `EnGNLayer.forward`'s blocked / segment route, `_staged_typed`'s blocked route, `_staged_gated`'s packed blocked route (`_gated_packed`: extract is the two gate projections, aggregate the gated kernels' forward) | `extract_ms.infer`, `aggregate_ms.infer`, `update_ms.infer` |
| `engn.aggregate_bwd` | `kernels/rer_gather/ops.py::_PackedGroups.backward`: the packed aggregate's backward over a plan's bucket groups (the sum's B2 transposed; the max's winner words, resolve pass and tie walk); `kernels/rer_gather_gated/ops.py::_GatedGroups.backward`: the gated aggregate's source walk (dx, dpc) and destination walk (dph); both inside `step.backward` | `agg_bwd_ms.train` |
| `step.forward`, `step.backward`, `step.optimizer` | `training/train_lib.py` | `fwd_ms.train`, `bwd_ms.train`, `opt_ms.train` |
| `graph.relabel`, `graph.normalise`, `plan.fold` | `graphs/degree.py`, `COOGraph.gcn_normalized`, R-GCN's relation norm in `prepare_graph` | `plan_graph_s` |
| `plan.distinct` | a max plan's distinct edges (`core/engn.py::max_plan_edges`) in `prepare_graph`, `prepare_tiled`, `prepare_ring` | none (inside `prepare_s`) |
| `plan.distinct_dropped` (counter) | the repeated edges that stage dropped | none yet |
| `plan.tiles`, `plan.pack` | the tile store and its packing in `prepare_graph` | `plan_tiles_s` |
| `plan.format`, `plan.groups` | the tile-format choice, the bucket groups or flat entries | `plan_groups_s` |
| `plan.upload` | a plan's arrays going to a card | `plan_upload_s` |
| `build.compiled` (counter) | `kernels/_build.py::build_all`: libraries nvcc built | `kernels_built` |
| `typed.pair_rows` (counter) | `EnGNLayer._staged_typed`'s blocked route over flat entries: the (src, relation) pair rows projected, per layer call | none yet |
| `typed.payload_rows` (counter) | the same route over dense typed tiles: the N x R rows of the (N, R*H) payload, per layer call | none yet |
| `max_bwd.rows` (counter, only while a profiler records) | `kernels/rer_gather_bwd/ops.py::packed_max_backward`: the destination rows (q*T) a packed max backward covers, per call | `max_walk_share.train` |
| `max_bwd.walk_rows` (counter, only while a profiler records; on the card a `device_counter` that the resolve pass adds into, read at `report()`) | the same call: the rows the walk visits, those its resolve pass flagged (every row where no entry has weight 1 and there is no resolve pass) | `max_walk_share.train` |
| `sum_t.entries` (counter, only while a profiler records) | `kernels/rer_gather_bwd/ops.py::packed_groups_t`: the real entries a packed sum backward (B2^T) walks, per call, from its source table | none yet |
| `gated.gate_evals` (counter, only while a profiler records) | `kernels/rer_gather_gated/ops.py`: the (entry, feature) gate evaluations of each gated walk, the forward's, the source walk's and the destination walk's, real entries x F from the plan's table | `gate_evals.train` |
| `sum_t.merged_rows` (counter, only while a profiler records; on the card a `device_counter` that B2^T's split pieces add into, read at `report()`) | the same call: the dX rows added by a split source interval's pieces (a piece's columns with an entry) rather than stored once; over `sum_t.entries`, the share of a per-entry scatter's adds that remains | none yet |
"""
from __future__ import annotations

import contextlib
import threading
from time import perf_counter
from typing import Dict, List, Optional, Tuple

import torch
from torch.profiler import record_function

_recording = torch._C._autograd._profiler_enabled    # is a profiler on?

_NULL = contextlib.nullcontext()
_LOCK = threading.Lock()


class _Entry:
    __slots__ = ("calls", "host_s", "device_s", "pending")

    def __init__(self):
        self.calls = 0
        self.host_s = 0.0
        self.device_s: Optional[float] = None
        self.pending: List[Tuple[torch.cuda.Event, torch.cuda.Event]] = []


_TABLE: Dict[str, _Entry] = {}
# device counters: (name, device) -> [the counter, its value at the last
# report]
_COUNTERS: Dict[Tuple[str, torch.device], List] = {}


def _entry(name: str) -> _Entry:
    e = _TABLE.get(name)
    if e is None:
        e = _TABLE[name] = _Entry()
    return e


class _Span:
    """A timed range: a `record_function` and a pair of CUDA events when
    `traced`, the host clock always."""
    __slots__ = ("name", "traced", "rf", "stream", "start", "t0")

    def __init__(self, name: str, traced: bool):
        self.name = name
        self.traced = traced

    def __enter__(self):
        self.start = None
        if self.traced:
            self.rf = record_function(self.name)
            self.rf.__enter__()
            if torch.cuda.is_initialized():
                self.stream = torch.cuda.current_stream()
                self.start = torch.cuda.Event(enable_timing=True)
                self.start.record(self.stream)
        self.t0 = perf_counter()
        return self

    def __exit__(self, *exc):
        host_s = perf_counter() - self.t0
        end = None
        if self.start is not None:
            end = torch.cuda.Event(enable_timing=True)
            end.record(self.stream)
        if self.traced:
            self.rf.__exit__(*exc)
        with _LOCK:
            e = _entry(self.name)
            e.calls += 1
            e.host_s += host_s
            if end is not None:
                e.pending.append((self.start, end))
        return False


def span(name: str):
    """A span on a hot path: the shared no-op context unless a profiler
    is recording."""
    if not _recording():
        return _NULL
    return _Span(name, True)


def stage(name: str) -> _Span:
    """A set-up stage: its host seconds always go into the table; it is
    also a span while a profiler records."""
    return _Span(name, _recording())


def recording() -> bool:
    """Whether a profiler is recording."""
    return _recording()


def count(name: str, n: int = 1) -> None:
    """Add `n` to the calls of `name` (a call with 0 records the name)."""
    with _LOCK:
        _entry(name).calls += int(n)


def device_counter(name: str, device: torch.device) -> torch.Tensor:
    """The int64 counter of `name` on `device`, for a kernel to add into;
    zero-filled when first asked for, then kept."""
    key = (name, torch.device(device))
    with _LOCK:
        c = _COUNTERS.get(key)
        if c is None:
            c = _COUNTERS[key] = [torch.zeros(1, dtype=torch.int64,
                                              device=device), 0]
        return c[0]


def report() -> Dict[str, Dict]:
    """{name: {"calls", "host_s", "device_s"}}; `device_s` is None where
    no event was recorded (no profiler, or no CUDA)."""
    with _LOCK:
        if any(e.pending for e in _TABLE.values()):
            torch.cuda.synchronize()
            for e in _TABLE.values():
                if e.pending:
                    e.device_s = (e.device_s or 0.0) + 1e-3 * sum(
                        a.elapsed_time(b) for a, b in e.pending)
                    e.pending = []
        for (name, _), c in _COUNTERS.items():
            v = int(c[0].item())
            if v != c[1]:
                _entry(name).calls += v - c[1]
                c[1] = v
        return {k: {"calls": e.calls, "host_s": e.host_s,
                    "device_s": e.device_s} for k, e in _TABLE.items()}


def reset() -> None:
    with _LOCK:
        _TABLE.clear()
        _COUNTERS.clear()


__all__ = ["span", "stage", "count", "device_counter", "recording",
           "report", "reset"]
