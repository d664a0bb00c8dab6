"""Streaming membership subsystem: TTL-aged generations + overflow stash.

Public surface (counterpart of ``repro.streaming``):

  * ``GenerationalFilter`` / ``GenerationConfig`` / ``GenStats``: K
    rotating filter generations over a preallocated buffer pool, lazy TTL
    expiry, stash-backed inserts, lookups through the fused ``probe_multi``
    kernel (``generations.py``);
  * ``OverflowStash``: the host-facing stash wrapper (``stash.py``; device
    math in ``repro_torch.kernels.stash``);
  * ``AdmissionController`` / ``AdmissionConfig`` / ``congestion_signal``:
    stash + fill backpressure (``admission.py``).
"""
from repro_torch.streaming.admission import (AdmissionConfig,
                                             AdmissionController,
                                             congestion_signal)
from repro_torch.streaming.generations import (GenerationalFilter,
                                               GenerationConfig, GenStats)
from repro_torch.streaming.stash import OverflowStash

__all__ = ["AdmissionConfig", "AdmissionController", "congestion_signal",
           "GenerationConfig", "GenerationalFilter", "GenStats",
           "OverflowStash"]
