"""Degree-aware vertex cache simulator (paper S4.2 / Fig. 16).

On the ASIC, DAVC is a cache between the result banks and the PE register
files whose entries can be reserved for high-degree vertices (chosen by
offline analysis, never replaced).  The port, as the reference, gets that
effect by relabelling vertices in degree order (`graphs/degree.py`) and
keeps this simulator for the hit-rate study of Fig. 16.

`simulate_davc` is vectorised: pinned accesses are a mask lookup, and the
LRU part uses the stack-distance equivalence (an access to v hits an LRU
of capacity C iff fewer than C distinct vertices were referenced since
the previous access to v), with the reuse distances from a bottom-up
merge sort in numpy vector ops.  `simulate_davc_reference` is the literal
OrderedDict LRU, the oracle of the equivalence test.  Host numpy only:
the same inputs give the reference's hit rates exactly.
"""
from __future__ import annotations

from collections import OrderedDict

import numpy as np

from repro_torch.graphs.format import COOGraph


def _count_preceding_leq(a: np.ndarray) -> np.ndarray:
    """For each position i, #{j < i : a[j] <= a[i]} — vectorised
    bottom-up merge sort.  At every level the right half of each block
    counts its predecessors in the sorted left half with one global
    `searchsorted` (blocks are disambiguated by per-block offsets)."""
    n = int(a.size)
    if n == 0:
        return np.zeros(0, np.int64)
    m = 1 << max(n - 1, 0).bit_length()
    lo = int(a.min())
    big = int(a.max()) - lo + 2              # sentinel above every value
    vals = np.full(m, big, np.int64)
    vals[:n] = a.astype(np.int64) - lo       # values now in [0, big)
    idx = np.arange(m, dtype=np.int64)
    counts = np.zeros(m, np.int64)
    off_step = big + 1
    width = 1
    while width < m:
        nb = m // (2 * width)
        v = vals.reshape(nb, 2 * width)
        ix = idx.reshape(nb, 2 * width)
        offs = np.arange(nb, dtype=np.int64) * off_step
        flat_left = (v[:, :width] + offs[:, None]).ravel()
        queries = (v[:, width:] + offs[:, None]).ravel()
        pos = np.searchsorted(flat_left, queries, side="right")
        within = pos - np.repeat(np.arange(nb, dtype=np.int64) * width,
                                 width)
        counts[ix[:, width:].ravel()] += within
        order = np.argsort(v, axis=1, kind="stable")
        vals = np.take_along_axis(v, order, axis=1).ravel()
        idx = np.take_along_axis(ix, order, axis=1).ravel()
        width *= 2
    return counts[:n]


def _lru_hits(stream: np.ndarray, capacity: int) -> int:
    """Exact LRU hit count over a reference stream via stack distances."""
    if capacity <= 0 or stream.size == 0:
        return 0
    s = stream.astype(np.int64)
    # prev[t] = previous position of the same value, or -1
    order = np.argsort(s, kind="stable")
    ss = s[order]
    same = ss[1:] == ss[:-1]
    prev = np.full(s.size, -1, np.int64)
    prev[order[1:][same]] = order[:-1][same]
    # distinct values since the previous access:
    #   D(t) = #{u < t : prev[u] <= prev[t]} - (prev[t] + 1)
    # (every u <= prev[t] qualifies trivially since prev[u] < u)
    cnt = _count_preceding_leq(prev)
    d = cnt - (prev + 1)
    return int(((prev >= 0) & (d < capacity)).sum())


def simulate_davc(g: COOGraph, cache_lines: int, reserved_frac: float,
                  line_bytes: int = 64, feature_bytes: int = 4 * 64) -> float:
    """Run the aggregate-stage access stream (destination vertex per edge,
    in edge order) through an LRU cache with `reserved_frac` of the lines
    pinned to the highest-degree vertices.  Returns the hit rate."""
    n_res = int(cache_lines * reserved_frac)
    n_lru = cache_lines - n_res
    total = g.num_edges
    if total == 0:
        return 0.0
    pinned = np.zeros(g.num_vertices, bool)
    if n_res > 0:
        deg = g.in_degrees()
        pinned[np.argsort(-deg)[:n_res]] = True
    hit_mask = pinned[g.dst]
    hits = int(hit_mask.sum())
    hits += _lru_hits(g.dst[~hit_mask], n_lru)
    return hits / total


def simulate_davc_reference(g: COOGraph, cache_lines: int,
                            reserved_frac: float) -> float:
    """The literal pointer-chasing LRU (the pre-vectorisation
    implementation) — kept as the oracle for the equivalence test."""
    n_res = int(cache_lines * reserved_frac)
    n_lru = cache_lines - n_res
    deg = g.in_degrees()
    pinned = set(np.argsort(-deg)[:n_res].tolist()) if n_res > 0 else set()
    lru: OrderedDict[int, None] = OrderedDict()
    hits = 0
    total = g.num_edges
    for v in g.dst.tolist():
        if v in pinned:
            hits += 1
            continue
        if v in lru:
            hits += 1
            lru.move_to_end(v)
            continue
        if n_lru > 0:
            lru[v] = None
            if len(lru) > n_lru:
                lru.popitem(last=False)
    return hits / max(total, 1)
