"""Degree-aware vertex relabelling (the software form of the paper's
DAVC): vertices relabelled in descending degree order put the hubs in
the leading intervals, which densifies the hot tiles."""
from __future__ import annotations

import numpy as np

from repro_torch.graphs.format import COOGraph
from repro_torch.tracing import stage


def degree_sort_permutation(g: COOGraph) -> np.ndarray:
    """perm[new_id] = old_id, descending total degree (stable)."""
    with stage("graph.relabel"):
        deg = g.degrees()
        return np.argsort(-deg, kind="stable").astype(np.int32)


def apply_vertex_permutation(g: COOGraph, perm: np.ndarray) -> COOGraph:
    """Relabel vertices: new graph where vertex i is old vertex perm[i]."""
    with stage("graph.relabel"):
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


def hub_edge_coverage(g: COOGraph, top_frac: float = 0.2) -> float:
    """Share of edges touching the top `top_frac` highest-degree vertices
    (the paper reports 50-85% for the top 20%, S3.2): the skew DAVC
    exploits."""
    deg = g.degrees()
    k = max(1, int(g.num_vertices * top_frac))
    hubs = set(np.argsort(-deg)[:k].tolist())
    hub_mask = np.zeros(g.num_vertices, bool)
    hub_mask[list(hubs)] = True
    touched = hub_mask[g.src] | hub_mask[g.dst]
    return float(touched.mean())
