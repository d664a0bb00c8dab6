"""Vectorized backing keystore for the OCF (the paper's memtable analogue).

A copy of ``repro.core.keystore`` (numpy only), kept here so the port never
imports the JAX package.  A sorted-array multiset of uint64 keys with
**batch** add/remove: all operations are O(B log B + U) numpy vector ops
for a batch of B keys over U resident uniques.

Semantics match a dict of counts exactly, including per-occurrence delete
verification: deleting a key that appears m times in the store and d times
in one batch succeeds for the first min(m, d) occurrences *in batch order*.
"""
from __future__ import annotations

import numpy as np


class VectorKeystore:
    """Sorted parallel arrays: ``keys`` (uint64, unique) and ``counts``."""

    def __init__(self):
        self._keys = np.empty(0, np.uint64)
        self._counts = np.empty(0, np.int64)
        self._total = 0

    # ------------------------------------------------------------ views --

    @property
    def total(self) -> int:
        """Live key count, multiplicities included (== len of the OCF)."""
        return self._total

    @property
    def unique(self) -> int:
        return self._keys.size

    def multiplicity(self, key: int) -> int:
        if not self._keys.size:
            return 0
        pos = int(np.searchsorted(self._keys, np.uint64(key)))
        if pos < self._keys.size and self._keys[pos] == np.uint64(key):
            return int(self._counts[pos])
        return 0

    def contains(self, key: int) -> bool:
        return self.multiplicity(key) > 0

    def contains_batch(self, keys) -> np.ndarray:
        """Residency mask bool[B] for a query batch — one searchsorted over
        the sorted uniques instead of B scalar probes (the metrics module's
        ground-truth pass was the last per-key Python loop in the repo)."""
        keys = np.asarray(keys, dtype=np.uint64)
        if keys.size == 0 or not self._keys.size:
            return np.zeros(keys.size, bool)
        _, hit = self._locate(keys)
        return hit

    def materialize(self) -> np.ndarray:
        """All keys with multiplicity, as uint64[total] (rebuild input)."""
        return np.repeat(self._keys, self._counts)

    def clear(self) -> None:
        self._keys = np.empty(0, np.uint64)
        self._counts = np.empty(0, np.int64)
        self._total = 0

    # ------------------------------------------------------------- edit --

    def _locate(self, uk: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
        """(pos, hit): insertion index per unique key, and residency mask."""
        pos = np.searchsorted(self._keys, uk)
        hit = np.zeros(uk.size, bool)
        if self._keys.size:
            inb = pos < self._keys.size
            hit[inb] = self._keys[pos[inb]] == uk[inb]
        return pos, hit

    def add(self, keys) -> None:
        keys = np.asarray(keys, dtype=np.uint64)
        if keys.size == 0:
            return
        uk, cnt = np.unique(keys, return_counts=True)
        pos, hit = self._locate(uk)
        self._counts[pos[hit]] += cnt[hit]       # pos unique per uk: no races
        if (~hit).any():
            self._keys = np.insert(self._keys, pos[~hit], uk[~hit])
            self._counts = np.insert(self._counts, pos[~hit], cnt[~hit])
        self._total += int(keys.size)

    def remove(self, keys) -> np.ndarray:
        """Remove a batch; returns present bool[B] (per-occurrence verified).

        Occurrence k of a key (in batch order) is present iff k < resident
        multiplicity — identical to looping a dict decrement per key.
        """
        keys = np.asarray(keys, dtype=np.uint64)
        if keys.size == 0:
            return np.zeros(0, bool)
        uk, inv, cnt = np.unique(keys, return_inverse=True, return_counts=True)
        pos, hit = self._locate(uk)
        avail = np.zeros(uk.size, np.int64)
        avail[hit] = self._counts[pos[hit]]
        # occurrence rank in batch order: stable sort groups equal keys while
        # preserving arrival order, so rank = index within the equal-run
        order = np.argsort(keys, kind="stable")
        sk = keys[order]
        idx = np.arange(keys.size)
        new_run = np.ones(keys.size, bool)
        new_run[1:] = sk[1:] != sk[:-1]
        run_start = np.maximum.accumulate(np.where(new_run, idx, 0))
        rank = np.empty(keys.size, np.int64)
        rank[order] = idx - run_start
        present = rank < avail[inv]
        removed = np.minimum(cnt, avail)
        if removed.any():
            self._counts[pos[hit]] -= removed[hit]
            keep = self._counts > 0
            if not keep.all():
                self._keys = self._keys[keep]
                self._counts = self._counts[keep]
            self._total -= int(removed.sum())
        return present
