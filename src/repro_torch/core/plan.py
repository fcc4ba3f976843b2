"""`PreparedPlan` — the typed result of `prepare_graph`.

The carrier dict differs per backend by design (each backend carries its
own device tensors); the plan answers the questions every caller asks as
typed attributes: which backend it landed on, which tile format, how
many device bytes it claims, and what the autotuner decided.
`plan_carrier` unwraps either a plan or a raw carrier dict.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional


@dataclasses.dataclass(eq=False)
class PreparedPlan:
    """backend:         the backend the plan targets.
    tile_format:     "dense" | "packed" for the tile backends, None for
                     segment.
    streaming_mode:  always None here (the streamed backend is not
                     ported yet); kept for the reference's shape.
    footprint_bytes: device bytes the plan claims (0 when the backend
                     records no estimate).
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
        return self.carrier.get("blocks_meta") or {}

    @property
    def device(self):
        """The device the carrier's tensors live on."""
        return self.carrier.get("device")

    def __repr__(self) -> str:
        return (f"PreparedPlan(backend={self.backend!r}, n={self.n}, "
                f"tile_format={self.tile_format!r}, "
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
    meta = carrier.get("blocks_meta") or {}
    footprint = int(meta.get("device_bytes") or 0)
    if not footprint and backend in ("blocked", "fused"):
        # dense block carriers price their uploaded operands directly
        footprint = sum(int(getattr(v, "nbytes", 0))
                        for v in carrier.values())
    return PreparedPlan(
        backend=backend,
        n=int(carrier.get("n", 0)),
        carrier=carrier,
        tile_format=meta.get("tile_format"),
        streaming_mode=None,
        footprint_bytes=footprint,
        autotune=meta.get("format_choice"),
    )
