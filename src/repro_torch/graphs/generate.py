"""Synthetic graph generation: deterministic R-MAT stand-ins whose
(vertices, edges, feature dim, labels) match the paper's Table 5.  The
same seed gives the same graph as `repro.graphs.generate`, bit for bit.
"""
from __future__ import annotations

import numpy as np

from repro_torch.graphs.format import COOGraph

# Table 5 of the paper: name -> (#vertices, #edges, feature dim, #labels)
DATASET_STATS = {
    "cora":      (2708,    10556,    1433, 7),
    "pubmed":    (19717,   88651,    500,  3),
    "nell":      (65755,   251550,   5415, 210),
    "corafull":  (19793,   126842,   8710, 67),
    "reddit":    (232965,  114_600_000, 602, 41),
    "enwiki":    (3_600_000, 276_000_000, 300, 12),
    "amazon":    (8_600_000, 231_600_000, 96, 22),
    "synthA":    (4_190_000, 67_100_000, 100, 16),
    "synthB":    (8_380_000, 134_200_000, 100, 16),
    "synthC":    (12_410_000, 205_300_000, 64, 16),
    "synthD":    (16_760_000, 268_400_000, 50, 16),
    "aifb":      (8285,    29043,    91,  4),
    "mutag":     (23644,   192098,   47,  2),
    "bgs":       (333845,  2166243,  207, 2),
    "am":        (1666764, 13643406, 267, 11),
}


def dataset_stats(name: str):
    return DATASET_STATS[name]


def rmat_graph(num_vertices: int, num_edges: int, seed: int = 0,
               a: float = 0.57, b: float = 0.19, c: float = 0.19,
               num_relations: int = 1) -> COOGraph:
    """R-MAT [Chakrabarti et al.] generator — power-law, deterministic.
    Each of log2(N) levels picks a quadrant per edge."""
    rng = np.random.default_rng(seed)
    n = 1
    levels = 0
    while n < num_vertices:
        n *= 2
        levels += 1
    src = np.zeros(num_edges, np.int64)
    dst = np.zeros(num_edges, np.int64)
    probs = np.array([a, b, c, 1.0 - a - b - c])
    cdf = np.cumsum(probs)
    for _ in range(levels):
        r = rng.random(num_edges)
        quad = np.searchsorted(cdf, r)
        src = src * 2 + (quad >= 2)       # quadrant c/d -> lower half rows
        dst = dst * 2 + (quad % 2)        # quadrant b/d -> right half cols
    src = src % num_vertices
    dst = dst % num_vertices
    rel = None
    if num_relations > 1:
        rel = rng.integers(0, num_relations, num_edges).astype(np.int32)
    return COOGraph(num_vertices, src.astype(np.int32), dst.astype(np.int32),
                    None, rel, num_relations)


def make_dataset(name: str, seed: int = 0, max_vertices: int | None = None,
                 max_edges: int | None = None, feature_dim: int | None = None):
    """Build the R-MAT stand-in for a Table-5 dataset, optionally scaled
    down.  Returns (graph, F, labels)."""
    v, e, f, labels = DATASET_STATS[name]
    if max_vertices is not None and v > max_vertices:
        scale = max_vertices / v
        v = max_vertices
        e = max(int(e * scale), v)
    if max_edges is not None and e > max_edges:
        e = max_edges
    if feature_dim is not None:
        f = feature_dim
    rels = 1
    if name in ("aifb", "mutag", "bgs", "am"):
        rels = {"aifb": 45, "mutag": 23, "bgs": 103, "am": 133}[name]
    g = rmat_graph(v, e, seed=seed, num_relations=rels)
    return g, f, labels


def random_features(num_vertices: int, dim: int, seed: int = 0) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return rng.standard_normal((num_vertices, dim)).astype(np.float32) * 0.1
