"""Degree-aware vertex relabelling (the software form of the paper's
DAVC): vertices relabelled in descending degree order put the hubs in
the leading intervals, which densifies the hot tiles."""
from __future__ import annotations

import numpy as np

from repro_torch.graphs.format import COOGraph


def degree_sort_permutation(g: COOGraph) -> np.ndarray:
    """perm[new_id] = old_id, descending total degree (stable)."""
    deg = g.degrees()
    return np.argsort(-deg, kind="stable").astype(np.int32)


def apply_vertex_permutation(g: COOGraph, perm: np.ndarray) -> COOGraph:
    """Relabel vertices: new graph where vertex i is old vertex perm[i]."""
    inv = np.empty_like(perm)
    inv[perm] = np.arange(perm.shape[0], dtype=np.int32)
    return COOGraph(g.num_vertices, inv[g.src], inv[g.dst],
                    g.val, g.rel, g.num_relations)


def permute_features(x: np.ndarray, perm: np.ndarray) -> np.ndarray:
    """Reorder a (N, F) feature matrix to match apply_vertex_permutation."""
    return x[perm]


def unpermute_features(y: np.ndarray, perm: np.ndarray) -> np.ndarray:
    out = np.empty_like(y)
    out[perm] = y
    return out
