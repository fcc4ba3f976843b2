"""`PreparedPlan` — the typed result of `prepare_graph`.

The carrier dict differs per backend by design (each backend carries its
own device tensors); the plan answers the questions every caller asks as
typed attributes: which backend it landed on, which tile format, which
streaming regime, how many bytes it claims, and what the autotuner
decided.
`plan_carrier` unwraps either a plan or a raw carrier dict.
"""
from __future__ import annotations

import dataclasses
import types
from typing import Any, Dict, Optional

import torch


@dataclasses.dataclass(eq=False)
class PreparedPlan:
    """backend:         the backend the plan targets — after any budget
                     spill, so "tiled" where the config asked for
                     "blocked" and it did not fit.
    tile_format:     "dense" | "packed" for the tile backends, None for
                     segment.
    streaming_mode:  the tiled backend's landed regime ("chunk_queue" |
                     "callback"), None for device-resident backends.
    footprint_bytes: device bytes the plan claims for resident backends
                     (per shard for the ring);
                     host store bytes + resident feature bytes for the
                     streamed tiled backend (0 when the backend records
                     no estimate).
    autotune:        the `TileFormatChoice` when the format was chosen
                     by the autotuner, else None.
    carrier:         the backend-specific tensor dict."""

    backend: str
    n: int
    carrier: Dict[str, Any]
    tile_format: Optional[str] = None
    streaming_mode: Optional[str] = None
    footprint_bytes: int = 0
    autotune: Optional[Any] = None

    def as_dict(self) -> Dict[str, Any]:
        return self.carrier

    @property
    def meta(self) -> Dict[str, Any]:
        """`blocks_meta`, `tiled_meta` or `ring_meta`, or {} (segment
        carries none)."""
        return (self.carrier.get("blocks_meta")
                or self.carrier.get("tiled_meta")
                or self.carrier.get("ring_meta") or {})

    @property
    def device(self):
        """The device the carrier's tensors live on."""
        return self.carrier.get("device")

    def held_bytes(self) -> int:
        """Bytes of every tensor reachable from the carrier, each storage
        once: through dicts, lists, tuples and sets and the attributes
        (`__dict__`) of any other object, so the tiles or groups, their
        index arrays, the kernels' tables (a `PlanGroups`' work table
        included) and whatever an object in the carrier caches all count.
        A backward adds nothing to a plan, so this is the same before and
        after training.  Host arrays (numpy, the streamed plan's store)
        are not tensors and do not count."""
        seen, stores, total, todo = set(), set(), 0, [self.carrier]
        while todo:
            obj = todo.pop()
            if id(obj) in seen or isinstance(obj, (type, types.ModuleType)):
                continue
            seen.add(id(obj))
            if isinstance(obj, torch.Tensor):
                st = obj.untyped_storage()
                if st.data_ptr() not in stores:
                    stores.add(st.data_ptr())
                    total += st.nbytes()
                continue
            if isinstance(obj, dict):
                todo.extend(obj.values())
            elif isinstance(obj, (list, tuple, set, frozenset)):
                todo.extend(obj)
            todo.extend(getattr(obj, "__dict__", {}).values())
        return total

    def __repr__(self) -> str:
        return (f"PreparedPlan(backend={self.backend!r}, n={self.n}, "
                f"tile_format={self.tile_format!r}, "
                f"streaming_mode={self.streaming_mode!r}, "
                f"footprint_bytes={self.footprint_bytes}, "
                f"keys={sorted(self.carrier)})")


def plan_carrier(graph: Any) -> Dict[str, Any]:
    """The raw carrier dict of a plan-or-dict."""
    return graph.carrier if isinstance(graph, PreparedPlan) else graph


def wrap_plan(carrier: Dict[str, Any]) -> PreparedPlan:
    """Build the typed plan over a carrier dict."""
    if isinstance(carrier, PreparedPlan):
        return carrier
    backend = carrier.get("backend", "segment")
    meta = (carrier.get("blocks_meta") or carrier.get("tiled_meta")
            or carrier.get("ring_meta") or {})
    footprint = int(meta.get("device_bytes") or 0)
    if not footprint and backend in ("blocked", "fused"):
        # dense block carriers price their uploaded operands directly
        footprint = sum(int(getattr(v, "nbytes", 0))
                        for v in carrier.values())
    mode = None
    if backend == "tiled":
        footprint = int(meta.get("host_bytes", 0)
                        + meta.get("resident_feature_bytes", 0))
        mode = meta.get("streaming_mode")
        if mode == "auto":        # report the landed regime, not the ask
            mode = "chunk_queue" if meta.get("queue_plan") else "callback"
    return PreparedPlan(
        backend=backend,
        n=int(carrier.get("n", 0)),
        carrier=carrier,
        tile_format=meta.get("tile_format"),
        streaming_mode=mode,
        footprint_bytes=footprint,
        autotune=meta.get("format_choice"),
    )
