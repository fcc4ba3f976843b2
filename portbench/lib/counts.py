"""The least work a cell's inputs need, counted by the benchmark from its
own edge list, and the card's peaks.

A share of a roofline or of a peak is this least work over a measured
time, so it can never pass 100% and a later PR that replaces a kernel is
read against the same work.

Where a model's arithmetic lives: a reference module
(`reference/<model>.py`) may define its own `model_flops` and
`aggregate_bytes`, with the arguments of those below, and `least_work`
hands them to the readers; a module that defines neither is counted by
the DASR arithmetic here (GCN's and R-GCN's are).  Either way the count
stays a least count: never above the work the model needs, or a share
could pass 100%.

DASR arithmetic (EnGN S5.2, Observation 1; a copy of
`repro_torch/core/dasr.py`): for a sum aggregate, sigma(A X W) costs the
extraction either way and the aggregate at width H when extraction
comes first ("fau") or at width F when it comes last ("afu").  Here the
count is in FLOPs (a multiply and an add each) and takes, for each layer,
the cheaper order of the work that layer needs:

- "fau": the projection of every source row that sends (`src_rows`:
  the vertices for GCN, the distinct (src, relation) pairs for R-GCN),
  2 * src_rows * F * H, then the aggregate, 2 * entries * H;
- "afu": the aggregate at width F, 2 * entries * F, then the projection
  of every destination row that receives (`dst_rows`), 2 * dst_rows * F
  * H;
- a self term (R-GCN's W_0 h), 2 * N * F * H, where the model has one.

A training step adds, per layer: the weight gradient (the projection's
cost again, and the self term's), the aggregate's transpose where the
order needs it for that gradient ("fau": A^T G before X^T), and the
input gradient only where the layer's input is trained (every layer but
the first).  The optimizer's elementwise work and the loss are not
counted.

`entries` are the merged (src, dst[, relation]) entries: multi-edges
count once, as the packed carriers hold them.
"""
from __future__ import annotations

import json
from pathlib import Path
from types import ModuleType
from typing import Callable, Dict, Optional, Sequence, Tuple

ENTRY_BYTES = 12        # one merged entry: int32 src, int32 dst, f32 weight
FLOAT_BYTES = 4


def dasr_decide(num_vertices: int, num_edges: int, f: int, h: int):
    """("fau" | "afu", fau ops, afu ops), MACs as `core/dasr.py` counts
    them: extraction N*F*H either way, the aggregate E*H or E*F."""
    extraction = float(num_vertices) * f * h
    fau = extraction + float(num_edges) * h
    afu = extraction + float(num_edges) * f
    return ("fau" if h <= f else "afu"), fau, afu


def layer_flops(*, n: int, f: int, h: int, entries: int, src_rows: int,
                dst_rows: int, self_term: bool, train: bool,
                input_trained: bool) -> Tuple[float, str, int]:
    """(least FLOPs of one layer, the order that gives it, the width its
    aggregate runs at)."""
    fau = 2.0 * src_rows * f * h + 2.0 * entries * h
    afu = 2.0 * entries * f + 2.0 * dst_rows * f * h
    if train:
        fau += 2.0 * src_rows * f * h + 2.0 * entries * h
        afu += 2.0 * dst_rows * f * h
        if input_trained:
            fau += 2.0 * src_rows * f * h
            afu += 2.0 * dst_rows * f * h + 2.0 * entries * f
    extra = 0.0
    if self_term:
        passes = 1 + int(train) + int(train and input_trained)
        extra = 2.0 * n * f * h * passes
    if fau <= afu:
        return fau + extra, "fau", h
    return afu + extra, "afu", f


def model_flops(dims: Sequence[int], work: Dict[str, int],
                train: bool) -> float:
    """Least FLOPs of one forward (train=False) or one training step of a
    stack with widths `dims` over a graph whose work counts are `work`
    (`n`, `entries`, `src_rows`, `dst_rows`, `self_term`)."""
    total = 0.0
    for i in range(len(dims) - 1):
        fl, _, _ = layer_flops(
            n=work["n"], f=dims[i], h=dims[i + 1], entries=work["entries"],
            src_rows=work["src_rows"], dst_rows=work["dst_rows"],
            self_term=bool(work["self_term"]), train=train,
            input_trained=i > 0)
        total += fl
    return total


def aggregate_bytes(dims: Sequence[int], work: Dict[str, int],
                    train: bool) -> float:
    """Least bytes the aggregates of one forward (or training step) move:
    each merged entry once (12 B), each input row of the aggregated width
    once and each output row once; a step adds the transpose pass where
    the cheaper order has one (the cotangent rows in, the gradient rows
    out, the entries again)."""
    n, e = work["n"], work["entries"]
    total = 0.0
    for i in range(len(dims) - 1):
        _, order, width = layer_flops(
            n=n, f=dims[i], h=dims[i + 1], entries=e,
            src_rows=work["src_rows"], dst_rows=work["dst_rows"],
            self_term=bool(work["self_term"]), train=train,
            input_trained=i > 0)
        one = ENTRY_BYTES * e + 2 * FLOAT_BYTES * n * width
        total += one
        if train and (order == "fau" or i > 0):
            total += one
    return float(total)


Count = Callable[[Sequence[int], Dict[str, int], bool], float]


def least_work(reference: ModuleType) -> Tuple[Count, Count]:
    """(least FLOPs, least aggregate bytes) of one forward or step, as
    functions of (dims, work, train): the reference module's own where it
    defines them, the DASR arithmetic of `model_flops` and
    `aggregate_bytes` where it does not."""
    return (getattr(reference, "model_flops", model_flops),
            getattr(reference, "aggregate_bytes", aggregate_bytes))


def load_peaks(kind: str, path: Optional[Path] = None) -> Optional[Dict]:
    """The peak table's entry for a device name, or None where the table
    has none (a CPU run has none)."""
    path = path or Path(__file__).resolve().parents[1] / "peaks.json"
    with open(path) as fh:
        table = json.load(fh)
    for dev in table["devices"]:
        if dev["match"] in kind:
            return dev
    return None

