"""Deterministic, resumable GNN mini-batches.

Batch k is a pure function of (seed, k), drawn by numpy's
`default_rng((seed, k))` exactly as the reference draws it, so a
fault-tolerant replay (`distributed/fault.py`) reproduces the stream and
both packages see the same batches.  The token stream of the LM side
stack comes with ROADMAP A12.
"""
from __future__ import annotations

from typing import Dict

import numpy as np


class GraphNodeStream:
    """GNN mini-batches over a fixed graph: batches of labelled vertices
    for semi-supervised node classification (the paper's workload)."""

    def __init__(self, num_vertices: int, num_labels: int, batch: int,
                 seed: int = 0, start_batch: int = 0):
        self.n = num_vertices
        self.labels = num_labels
        self.batch = batch
        self.seed = seed
        self.k = start_batch

    def cursor(self) -> int:
        return self.k

    def seek(self, cursor: int):
        self.k = int(cursor)

    def __iter__(self):
        return self

    def __next__(self) -> Dict[str, np.ndarray]:
        rng = np.random.default_rng((self.seed, self.k))
        idx = rng.integers(0, self.n, (self.batch,)).astype(np.int32)
        y = rng.integers(0, self.labels, (self.batch,)).astype(np.int32)
        self.k += 1
        return {"nodes": idx, "labels": y}
