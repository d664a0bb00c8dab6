"""Reputation-weighted admission for false-positive feedback.

The selector family repairs a colliding slot with success probability
1 - 2^-fp_bits per bump — but two populations escape it:

  * **persistent offenders** — keys whose reports keep landing (stash-
    resident collisions have no selector to bump; a slot that has cycled
    all four family members can re-collide).  Counting reports per key and
    promoting repeat offenders into a tiny EXACT side table turns them
    into guaranteed negatives forever — O(promoted) host memory for the
    heavy tail of the false-positive distribution.
  * **cold floods** — an adversary spraying *novel* "false positive"
    reports (each key reported once, never seen again).  Every report
    costs a sequential device adaptation pass, and a flood of fabricated
    ones could thrash selectors on slots that mostly answer honest
    queries.  Reports are therefore admission-controlled with the SAME
    hysteresis controller the streaming scheduler uses
    (``streaming.admission.AdmissionController`` — the filter's own
    congestion signal): while tripped, only keys with prior reputation
    (seen before) reach the device; cold first-time reports are counted
    host-side and deferred, so a flood degrades to a cheap hash-map
    increment.

A copy of ``repro.adaptive.reputation`` (host numpy code) over the port's
adaptive filter.

``AdaptiveMembership`` composes the three tiers — adaptive filter,
reputation counts, exact side table — into one lookup/insert/report facade
(the shape ``examples/adaptive_abuse_detection.py`` drives).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from repro_torch.adaptive.filter import AdaptiveConfig, AdaptiveFilter
from repro_torch.streaming.admission import (AdmissionConfig,
                                             AdmissionController)


@dataclasses.dataclass(frozen=True)
class ReputationConfig:
    promote_after: int = 2    # reports on the same key before promotion
    side_table_max: int = 4096  # exact-negative capacity (host memory)


class ReputationManager:
    """Per-key false-positive report counts + the exact-negative side table.

    The side table is a promoted set of uint64 keys known (by caller-
    verified ground truth) to be non-members that the probabilistic tiers
    keep answering True for.  Membership checks are vectorized via
    ``np.isin`` against a sorted array snapshot, rebuilt lazily on
    promotion — promotions are rare control-plane events, lookups are the
    hot path.
    """

    def __init__(self, config: ReputationConfig | None = None):
        self.config = config or ReputationConfig()
        self.counts: dict[int, int] = {}
        self._promoted: set[int] = set()
        self._sorted: np.ndarray = np.empty((0,), dtype=np.uint64)
        self._dirty = False

    @property
    def promoted(self) -> int:
        return len(self._promoted)

    def seen(self, keys) -> np.ndarray:
        """Which keys have ANY prior reputation (>= 1 past report)?"""
        return np.array([int(k) in self.counts or int(k) in self._promoted
                         for k in np.asarray(keys, dtype=np.uint64)],
                        dtype=bool)

    def observe(self, keys) -> np.ndarray:
        """Count one report per key -> promoted-now bool[N].

        A key reaching ``promote_after`` total reports moves from the
        count map to the exact side table (and stops being counted).
        Promotion saturates at ``side_table_max`` — beyond it the heavy
        tail keeps adapting probabilistically instead of growing host
        memory without bound.
        """
        out = np.zeros(len(np.asarray(keys)), dtype=bool)
        for j, k in enumerate(np.asarray(keys, dtype=np.uint64)):
            k = int(k)
            if k in self._promoted:
                continue
            c = self.counts.get(k, 0) + 1
            if (c >= self.config.promote_after
                    and len(self._promoted) < self.config.side_table_max):
                self._promoted.add(k)
                self.counts.pop(k, None)
                self._dirty = True
                out[j] = True
            else:
                self.counts[k] = c
        return out

    def denied(self, keys) -> np.ndarray:
        """Exact side-table membership -> bool[N] (True == known negative)."""
        if self._dirty:
            self._sorted = np.fromiter(self._promoted, dtype=np.uint64,
                                       count=len(self._promoted))
            self._sorted.sort()
            self._dirty = False
        if self._sorted.size == 0:
            return np.zeros(len(np.asarray(keys)), dtype=bool)
        return np.isin(np.asarray(keys, dtype=np.uint64), self._sorted)


class AdaptiveMembership:
    """Three-tier learned membership: adaptive filter -> side table.

    ``lookup`` answers filter-hit AND NOT known-negative; ``report`` feeds
    verified false positives through the reputation-weighted admission
    path.  Guarantees: zero false negatives (both subtractive tiers only
    remove caller-verified non-members), and every *confirmed* report
    eventually stops hitting — immediately when a selector bump lands,
    after ``promote_after`` reports via the exact tier otherwise.
    """

    def __init__(self, config: AdaptiveConfig,
                 reputation: ReputationConfig | None = None,
                 admission: AdmissionConfig | None = None,
                 filt: Optional[AdaptiveFilter] = None):
        self.filt = filt or AdaptiveFilter(config)
        self.reputation = ReputationManager(reputation)
        # The controller reads THIS filter's congestion via fills().
        self.admission = AdmissionController(
            filt=self.filt, config=admission or AdmissionConfig())
        self.deferred_reports = 0

    def insert(self, keys) -> np.ndarray:
        return self.filt.insert(keys)

    def delete(self, keys) -> np.ndarray:
        return self.filt.delete(keys)

    def lookup(self, keys) -> np.ndarray:
        hit = self.filt.lookup(keys)
        denied = self.reputation.denied(keys)
        return hit & ~denied

    def report(self, keys) -> np.ndarray:
        """Verified-false-positive feedback -> device-adapted bool[N].

        Hysteresis gate: while the filter's congestion signal is tripped,
        only keys with prior reputation reach the device adaptation pass;
        cold first-time reports are deferred (counted, so a repeat DOES
        carry reputation next time).  All admitted reports also feed the
        reputation counts, promoting repeat offenders to the exact tier.
        """
        keys = np.asarray(keys, dtype=np.uint64)
        if keys.size == 0:
            return np.zeros((0,), dtype=bool)
        if self.admission.peek():
            device = np.ones(keys.shape, dtype=bool)
        else:
            device = self.reputation.seen(keys)
            self.deferred_reports += int((~device).sum())
        self.reputation.observe(keys)
        adapted = np.zeros(keys.shape, dtype=bool)
        if device.any():
            adapted[device], _ = self.filt.report_false_positives(
                keys[device])
        return adapted
