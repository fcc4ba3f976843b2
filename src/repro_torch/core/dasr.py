"""Dimension-aware stage re-ordering (paper S5.2, Observation 1).

For sum aggregation sigma(A X W) may be evaluated as sigma(A (X W))
["FAU"] or sigma((A X) W) ["AFU"].  Extraction costs N*F*H either way;
the aggregation costs E*H (FAU) vs E*F (AFU).  DASR picks FAU iff H <= F.
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class DasrDecision:
    order: str            # "fau" | "afu"
    fau_ops: float        # total MACs+adds if FAU
    afu_ops: float        # total MACs+adds if AFU
    extraction_ops: float


def dasr_decide(num_vertices: int, num_edges: int, f: int, h: int) -> DasrDecision:
    extraction = float(num_vertices) * f * h      # order-invariant
    fau = extraction + float(num_edges) * h
    afu = extraction + float(num_edges) * f
    return DasrDecision("fau" if h <= f else "afu", fau, afu, extraction)


def predicted_speedup(num_vertices: int, num_edges: int, f: int, h: int,
                      baseline: str) -> float:
    """Napkin-math speedup of DASR over a fixed strategy (Fig. 14 model)."""
    d = dasr_decide(num_vertices, num_edges, f, h)
    best = min(d.fau_ops, d.afu_ops)
    fixed = d.fau_ops if baseline == "fau" else d.afu_ops
    return fixed / best
