"""Degree-aware result cache — the serving-level DAVC (paper S4.2).

The ASIC's DAVC pins cache lines for high-degree vertices because hub
vertices dominate edge traffic (S3.2: top-20% of vertices touch 50-85% of
edges).  The same skew shows up in serving traffic: popular entities are
requested over and over, and their L-hop neighbourhoods are the most
expensive to recompute (hubs have the largest frontiers).  So the serving
cache keeps the ASIC's two-tier structure:

  * a *reserved* region holding the final-layer embeddings of the top-K
    highest-degree vertices — written once, never evicted (the paper's
    "reserved lines determined by offline static analysis");
  * an LRU region for everything else.

`core/davc.py` simulates the hardware cache on the aggregate-stage access
stream; this module is the deployable analogue over request streams.
Host numpy, copied from `repro.serving.cache`: one sequence of calls
leaves both with the same rows, pins and counters.
Entries are whole embedding rows, so a hit skips the entire L-hop
extract + multi-layer forward for that vertex.
"""
from __future__ import annotations

from collections import OrderedDict
from typing import Dict, Optional, Tuple

import numpy as np


class DegreeAwareCache:
    """Two-tier (pinned hubs + LRU) embedding cache.

    capacity:       total number of vertex entries.
    degrees:        (N,) vertex degrees; picks the pinned set.
    reserved_frac:  fraction of `capacity` reserved for the highest-degree
                    vertices (0.0 = plain LRU, 1.0 = pinned-only).
    """

    def __init__(self, capacity: int, degrees: Optional[np.ndarray] = None,
                 reserved_frac: float = 0.5):
        if capacity <= 0:
            raise ValueError("capacity must be positive")
        self._n_res = int(capacity * reserved_frac)
        n_res = self._n_res if degrees is not None else 0
        self.capacity = capacity
        self.lru_capacity = capacity - n_res
        order = (np.argsort(-np.asarray(degrees), kind="stable")
                 if degrees is not None else np.zeros(0, np.int64))
        self.pinned_ids = frozenset(int(v) for v in order[:n_res])
        self._pinned: Dict[int, np.ndarray] = {}
        self._lru: "OrderedDict[int, np.ndarray]" = OrderedDict()
        self.stats = {"hits": 0, "misses": 0, "evictions": 0,
                      "pinned_hits": 0, "invalidations": 0, "repins": 0}
        self._dim: Optional[int] = None

    def __len__(self) -> int:
        return len(self._pinned) + len(self._lru)

    # -- read -------------------------------------------------------------
    def lookup(self, ids: np.ndarray) -> Tuple[np.ndarray, Optional[np.ndarray]]:
        """Batch probe: returns (hit_mask (B,), out (B, dim) with hit rows
        filled).  `out` is None while the cache is empty (dim unknown)."""
        ids = np.asarray(ids)
        mask = np.zeros(ids.shape[0], bool)
        if self._dim is None:
            self.stats["misses"] += int(ids.shape[0])
            return mask, None
        out = np.zeros((ids.shape[0], self._dim), np.float32)
        for i, v in enumerate(ids.tolist()):
            row = self._pinned.get(v)
            if row is not None:
                self.stats["pinned_hits"] += 1
            elif v in self._lru:
                row = self._lru[v]
                self._lru.move_to_end(v)
            if row is None:
                self.stats["misses"] += 1
                continue
            mask[i] = True
            out[i] = row
            self.stats["hits"] += 1
        return mask, out

    # -- write ------------------------------------------------------------
    def insert(self, ids: np.ndarray, values: np.ndarray):
        """Store embedding rows; pinned vertices go to the reserved region
        (never evicted), the rest to the LRU (evicting oldest)."""
        values = np.asarray(values)
        self._dim = int(values.shape[1])
        for v, row in zip(np.asarray(ids).tolist(), values):
            if v in self.pinned_ids:
                self._pinned[v] = np.array(row, np.float32)
                continue
            if self.lru_capacity <= 0:
                continue
            if v in self._lru:
                self._lru.move_to_end(v)
            self._lru[v] = np.array(row, np.float32)
            if len(self._lru) > self.lru_capacity:
                self._lru.popitem(last=False)
                self.stats["evictions"] += 1

    # -- admin ------------------------------------------------------------
    def hit_rate(self) -> float:
        total = self.stats["hits"] + self.stats["misses"]
        return self.stats["hits"] / total if total else 0.0

    def reset_stats(self):
        for k in self.stats:
            self.stats[k] = 0

    def clear(self):
        """Drop all entries (e.g. after a model/parameter update makes
        cached embeddings stale); stats are kept."""
        self._pinned.clear()
        self._lru.clear()
        self._dim = None

    # -- dynamic-graph maintenance -------------------------------------
    def invalidate(self, ids) -> int:
        """Evict the given vertices' rows from *both* tiers (a graph
        update changed their L-hop in-neighbourhood, so the cached
        embeddings are stale).  Pinned rows are dropped but the ids
        stay pinned — the next insert re-fills the reserved line.
        Returns the number of rows actually evicted."""
        dropped = 0
        for v in np.asarray(ids, np.int64).tolist():
            if self._pinned.pop(v, None) is not None:
                dropped += 1
            if self._lru.pop(v, None) is not None:
                dropped += 1
        self.stats["invalidations"] += dropped
        return dropped

    def pin_drift(self, degrees: np.ndarray) -> float:
        """Fraction of the current pinned set that would NOT be pinned
        under the given degree profile — how far the hub set has
        drifted since the pins were chosen (0.0 = unchanged)."""
        if not self.pinned_ids:
            return 0.0
        order = np.argsort(-np.asarray(degrees), kind="stable")
        fresh = set(int(v) for v in order[:len(self.pinned_ids)])
        stale = len(self.pinned_ids - fresh)
        return stale / len(self.pinned_ids)

    def repin(self, degrees: np.ndarray) -> int:
        """Recompute the reserved hub set from a fresh degree profile
        (the degree-tracked analogue of the paper's offline static
        analysis).  Rows cached under pins that lost their status move
        to the LRU tier; newly pinned ids keep any LRU row they already
        have.  Returns the number of pin slots that changed hands."""
        order = np.argsort(-np.asarray(degrees), kind="stable")
        n_res = min(self._n_res, order.shape[0])
        fresh = frozenset(int(v) for v in order[:n_res])
        changed = len(self.pinned_ids ^ fresh)
        # demote rows whose vertex lost pinned status
        for v in list(self._pinned):
            if v not in fresh:
                row = self._pinned.pop(v)
                if self.lru_capacity > 0:
                    self._lru[v] = row
                    self._lru.move_to_end(v)
                    if len(self._lru) > self.lru_capacity:
                        self._lru.popitem(last=False)
                        self.stats["evictions"] += 1
        # promote LRU rows that became pinned
        for v in fresh:
            if v in self._lru:
                self._pinned[v] = self._lru.pop(v)
        self.pinned_ids = fresh
        self.lru_capacity = self.capacity - n_res
        self.stats["repins"] += 1
        return changed
