"""Deterministic, resumable data pipelines: LM token batches and GNN
mini-batches.

Both streams are cursor-addressable: batch k is a pure function of
(seed, k), drawn by numpy's `default_rng` exactly as the reference draws
it, so a fault-tolerant replay (`distributed/fault.py`) and an elastic
restart (`checkpoint/elastic.py`) reproduce the stream, and both
packages see the same batches, integer for integer.
"""
from __future__ import annotations

from typing import Dict

import numpy as np


class SyntheticTokenStream:
    """Language-model batches: (tokens, labels) with next-token labels,
    int32 numpy arrays (B, S)."""

    def __init__(self, vocab_size: int, batch: int, seq: int, seed: int = 0,
                 start_batch: int = 0, shard: int = 0, num_shards: int = 1):
        self.vocab = vocab_size
        self.batch = batch
        self.seq = seq
        self.seed = seed
        self.k = start_batch
        self.shard = shard
        self.num_shards = num_shards

    def cursor(self) -> int:
        return self.k

    def seek(self, cursor: int):
        self.k = int(cursor)

    def __iter__(self):
        return self

    def __next__(self) -> Dict[str, np.ndarray]:
        rng = np.random.default_rng(
            (self.seed, self.k, self.shard))
        toks = rng.integers(0, self.vocab, (self.batch, self.seq + 1),
                            dtype=np.int64).astype(np.int32)
        self.k += 1
        return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}


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
