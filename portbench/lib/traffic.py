"""Request traffic kept for a later serving cell, and the labelled sets
of the training cells.

`zipf_traffic` is a copy of `repro_torch/graphs/generate.py::
zipf_traffic`: rank vertices by degree, draw ranks ~ Zipf(a), so the
hubs are the hottest request targets (EnGN S3.2).  No cell uses it yet.
"""
from __future__ import annotations

from typing import List

import numpy as np
import torch


def zipf_traffic(degrees: np.ndarray, a: float = 1.1, seed: int = 0):
    """Returns sample(size) -> (size,) int32 vertex ids."""
    order = np.argsort(-np.asarray(degrees), kind="stable").astype(np.int32)
    rng = np.random.default_rng(seed)

    def sample(size: int) -> np.ndarray:
        ranks = np.minimum(rng.zipf(a, size) - 1, order.size - 1)
        return order[ranks]

    return sample


def labelled_sets(num_vertices: int, size: int, count: int,
                  gen: torch.Generator, device: torch.device
                  ) -> List[torch.Tensor]:
    """`count` sets of `size` distinct vertices each (int64, sorted), one
    seeded permutation each: every set the same size, every one other
    rows."""
    if not 0 < size <= num_vertices:
        raise ValueError(f"a labelled set of {size} from {num_vertices} "
                         f"vertices")
    return [torch.sort(torch.randperm(num_vertices, generator=gen,
                                      device=device)[:size]).values
            for _ in range(count)]
