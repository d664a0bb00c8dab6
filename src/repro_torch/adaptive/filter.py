"""AdaptiveFilter — host control plane over the four-plane adaptive state.

Counterpart of ``repro.adaptive.filter``.  This wrapper speaks uint64 key
batches and owns the state and the overflow stash; the data plane is
``FilterOps``'s ``*_adaptive`` methods.  ``report_false_positives`` is the
feedback edge: a confirmed false positive (the caller checked ground
truth) repairs every colliding slot by bumping its 2-bit selector and
rewriting the stored fingerprint from the mirrored resident key.  Entries
never move, so a repair never makes a false negative.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from repro_torch.adaptive.state import AdaptiveState, make_adaptive_state
from repro_torch.core.filter_ops import Backend, FilterOps
from repro_torch.core.hashing import resolve_device
from repro_torch.kernels.stash import (DEFAULT_STASH_SLOTS, make_stash,
                                       stash_occupancy)


def split_keys(keys, device="cuda") -> tuple[torch.Tensor, torch.Tensor]:
    """uint64 key batch -> (hi, lo) int32 tensors (uint32 bit patterns) on
    ``device``, in one host-to-device copy."""
    k = np.asarray(keys, dtype=np.uint64)
    pair = np.stack([(k >> np.uint64(32)).astype(np.uint32),
                     (k & np.uint64(0xFFFFFFFF)).astype(np.uint32)])
    t = torch.from_numpy(pair.view(np.int32)).to(resolve_device(device))
    return t[0], t[1]


@dataclasses.dataclass(frozen=True)
class AdaptiveConfig:
    """Sizing and dispatch knobs for one adaptive filter."""

    n_buckets: int
    bucket_size: int = 4
    fp_bits: int = 16
    stash_slots: int = DEFAULT_STASH_SLOTS
    backend: Backend = "auto"
    donate: bool = True
    device: str = "cuda"

    def __post_init__(self):
        if self.n_buckets <= 0 or self.bucket_size not in (1, 2, 4, 8, 16):
            raise ValueError("n_buckets > 0 and bucket_size in "
                             "(1, 2, 4, 8, 16) required")

    def make_filter_ops(self) -> FilterOps:
        return FilterOps(fp_bits=self.fp_bits, backend=self.backend,
                         donate=self.donate)


class AdaptiveFilter:
    """Uint64-key facade over the adaptive data plane.

    Has ``fills()``, so ``streaming.admission.AdmissionController`` can
    gate report floods on this filter's congestion signal.
    """

    def __init__(self, config: AdaptiveConfig,
                 ops: Optional[FilterOps] = None):
        self.config = config
        self.device = resolve_device(config.device)
        self.ops = ops or config.make_filter_ops()
        self.state: AdaptiveState = make_adaptive_state(
            config.n_buckets, config.bucket_size, device=self.device)
        self.stash = make_stash(config.stash_slots, device=self.device)
        self.reports = 0
        self.adapted = 0

    # -- occupancy ------------------------------------------------------

    @property
    def capacity(self) -> int:
        return self.config.n_buckets * self.config.bucket_size

    def fills(self) -> tuple[float, float]:
        """(table fill, stash fill) — one host transfer each."""
        fill = float(self.state.count) / self.capacity
        stash_fill = (float(stash_occupancy(self.stash))
                      / self.config.stash_slots)
        return fill, stash_fill

    # -- data-plane verbs ----------------------------------------------

    def insert(self, keys) -> np.ndarray:
        hi, lo = split_keys(keys, self.device)
        self.state, self.stash, ok = self.ops.insert_adaptive(
            self.state, hi, lo, stash=self.stash)
        return ok.cpu().numpy()

    def lookup(self, keys) -> np.ndarray:
        hi, lo = split_keys(keys, self.device)
        return self.ops.lookup_adaptive(self.state, hi, lo,
                                        stash=self.stash).cpu().numpy()

    def delete(self, keys) -> np.ndarray:
        hi, lo = split_keys(keys, self.device)
        self.state, self.stash, ok = self.ops.delete_adaptive(
            self.state, hi, lo, stash=self.stash)
        return ok.cpu().numpy()

    def report_false_positives(self, keys) -> tuple[np.ndarray, np.ndarray]:
        """Feed confirmed false positives back -> (adapted[N], resident[N]).

        A report whose key IS a member is refused slot by slot
        (``resident``), never repaired into a false negative.  A reported
        key that matches only the stash adapts nothing (the stash has no
        selector); the reputation tier promotes those.
        """
        hi, lo = split_keys(keys, self.device)
        self.state, adapted, resident = self.ops.report_false_positive(
            self.state, hi, lo)
        adapted = adapted.cpu().numpy()
        self.reports += int(adapted.shape[0])
        self.adapted += int(adapted.sum())
        return adapted, resident.cpu().numpy()
