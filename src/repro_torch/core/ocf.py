"""OCF — the Optimized Cuckoo Filter (paper §II), on PyTorch.

Counterpart of ``repro.core.ocf``: the same host-side control plane over
the ``FilterOps`` data plane, with the same decisions.

  * data plane: every lookup/insert/delete/rebuild goes through
    ``repro_torch.core.filter_ops.FilterOps`` — the hand-written CUDA
    kernels (probe, insert with bounded eviction rounds, first-match-slot
    delete) on ``device="cuda"``, their plain PyTorch versions on
    ``device="cpu"``.  The table is a **dynamic active capacity inside a
    preallocated pow2 buffer**; device calls are fixed-``CHUNK`` batches
    with validity masks.
  * control plane: PRE or EOF resize policy; on a resize decision (or an
    insert failure = filter full) the table is **rebuilt from the backing
    keystore** at the new capacity.  The keystore also makes deletes safe:
    only keys it contains reach the filter (the paper's fix for
    blind-delete corruption).
"""
from __future__ import annotations

import dataclasses
from typing import Literal, Optional

import numpy as np
import torch

from repro_torch.core.chunking import (collect_chunk_results, key_chunks,
                                       pow2_at_least)
from repro_torch.core.filter import make_state
from repro_torch.core.filter_ops import (Backend, FilterOps,
                                         evict_rounds_for_load)
from repro_torch.core.hashing import resolve_device
from repro_torch.core.keystore import VectorKeystore
from repro_torch.core.policy import EofPolicy, PrePolicy, ResizeDecision
from repro_torch.core.scheduling import dedupe_keys
from repro_torch.kernels.stash import make_stash, stash_occupancy

SNAP_BUCKETS = 256


@dataclasses.dataclass
class OcfConfig:
    """Paper §II-B parameters (+ the data-plane backend switch)."""

    capacity: int = 1 << 16          # item slots; paper: 2× expected items
    bucket_size: int = 4             # paper-recommended
    fp_bits: int = 16
    mode: Literal["PRE", "EOF"] = "EOF"
    backend: Backend = "auto"        # filter data plane: cuda | auto
    # Insert kernel's eviction budget.  None (default) derives it
    # from the configured operating load: evict_rounds_for_load(o_max) —
    # 32 at the default o_max=0.85, 64 at 0.9.
    evict_rounds: Optional[int] = None
    # Overflow-stash slots (0 = no stash, the classic grow-on-failure OCF).
    # With a stash, eviction-storm inserts park in the stash instead of
    # triggering an emergency grow+rebuild; the stash is re-derived empty on
    # every rebuild, which also reclaims entries whose key was deleted.
    stash_slots: int = 0
    # Conflict-aware wave scheduling of insert batches (core/scheduling.py)
    # — fewer intra-batch rank races and eviction rounds; membership
    # semantics unchanged.
    schedule: bool = True
    # Host-side lookup dedup (probe one lane per distinct key in a batch).
    # Off by default — an all-unique batch pays the np.unique sort for
    # nothing; dedup-heavy consumers opt in.
    dedupe_lookups: bool = False
    # The OCF owns its pow2 buffer and never reuses a pre-op table, so
    # mutating ops update it in place instead of copying it every batch.
    donate: bool = True
    # Where the filter lives.  "cuda" (default) needs a card and raises
    # without one; "cpu" runs the kernels' plain PyTorch versions.
    device: str = "cuda"
    o_max: float = 0.85              # Max Occupancy
    o_min: float = 0.25              # Min Occupancy
    k_min: float = 0.35              # K markers (EOF)
    k_max: float = 0.75
    gain: float = 1.0 / 16.0         # Estimation Gain g (EOF)
    c_min: int = 1024
    c_max: int = 1 << 30

    def make_policy(self):
        if self.mode == "PRE":
            return PrePolicy(o_max=self.o_max, o_min=self.o_min,
                             c_min=self.c_min, c_max=self.c_max)
        return EofPolicy(o_max=self.o_max, o_min=self.o_min, k_min=self.k_min,
                         k_max=self.k_max, gain=self.gain, c_min=self.c_min,
                         c_max=self.c_max)

    def make_filter_ops(self) -> FilterOps:
        rounds = (self.evict_rounds if self.evict_rounds is not None
                  else evict_rounds_for_load(self.o_max))
        return FilterOps(fp_bits=self.fp_bits,
                         backend=self.backend,
                         evict_rounds=rounds,
                         schedule=self.schedule,
                         donate=self.donate)


@dataclasses.dataclass
class OcfStats:
    inserts: int = 0
    deletes: int = 0
    lookups: int = 0
    resizes: int = 0
    grows: int = 0
    shrinks: int = 0
    rebuild_keys: int = 0
    failed_inserts: int = 0       # chain exhausted -> emergency grow
    stash_spills: int = 0         # chain exhausted -> parked in the stash
    blind_deletes_blocked: int = 0
    buffer_reallocs: int = 0      # pow2 buffer reallocations


class OCF:
    """Optimized Cuckoo Filter with a backing keystore (memtable analogue)."""

    def __init__(self, config: OcfConfig | None = None):
        self.config = config or OcfConfig()
        self.device = resolve_device(self.config.device)
        self.policy = self.config.make_policy()
        self.ops = self.config.make_filter_ops()
        self.keystore = VectorKeystore()
        active = self._snap_buckets(self.config.capacity)
        buf = pow2_at_least(active)
        self.state = make_state(active, self.config.bucket_size,
                                buffer_buckets=buf, device=self.device)
        self.stash = (make_stash(self.config.stash_slots, device=self.device)
                      if self.config.stash_slots else None)
        self.stats = OcfStats()
        self.capacity_history: list[int] = [self.capacity]

    # ------------------------------------------------------------ props --

    def _snap_buckets(self, capacity_slots: int) -> int:
        b = max(1, -(-capacity_slots // self.config.bucket_size))
        return -(-b // SNAP_BUCKETS) * SNAP_BUCKETS

    @property
    def capacity(self) -> int:
        return int(self.state.n_buckets) * self.config.bucket_size

    @property
    def buffer_capacity(self) -> int:
        return self.state.table.shape[0] * self.config.bucket_size

    @property
    def count(self) -> int:
        return int(self.state.count)

    @property
    def occupancy(self) -> float:
        return self.count / self.capacity

    def __len__(self) -> int:
        return self.keystore.total

    # ---------------------------------------------------------- chunking --

    def _chunks(self, keys, *, with_valid: bool = True):
        """Fixed-CHUNK batches on this filter's device (core/chunking.py)."""
        return key_chunks(keys, with_valid=with_valid, device=self.device)

    # ------------------------------------------------------------- ops ---

    def lookup(self, keys) -> np.ndarray:
        keys = np.asarray(keys, dtype=np.uint64)
        self.stats.lookups += keys.size
        # Dedup pre-pass (core/scheduling.py, opt-in): probes are
        # idempotent, so a batch with in-batch repeats only pays one device
        # lane per distinct key; answers broadcast back through the
        # inverse index.
        if self.config.dedupe_lookups:
            probe_keys, inverse = dedupe_keys(keys)
        else:
            probe_keys, inverse = keys, None
        hits, ns = [], []
        for hi, lo, _valid, n in self._chunks(probe_keys, with_valid=False):
            if self.stash is not None:
                hit = self.ops.lookup_with_stash(self.state, self.stash,
                                                 hi, lo)
            else:
                hit = self.ops.lookup(self.state, hi, lo)
            hits.append(hit)
            ns.append(n)
        out = collect_chunk_results(hits, ns)
        return out[inverse] if inverse is not None else out

    def insert(self, keys) -> np.ndarray:
        """Insert a batch; returns ok mask (all True unless c_max exhausted)."""
        keys = np.asarray(keys, dtype=np.uint64)
        self.stats.inserts += keys.size
        self._maybe_resize(extra=keys.size, ops=keys.size)
        self.keystore.add(keys)
        # Queue every chunk on device first; the ok masks are stacked on
        # device and pulled back in ONE host transfer after the whole batch.
        # The stash-spill stat follows the same discipline: occupancy stays
        # a device scalar until everything is queued.
        spilled_before = (stash_occupancy(self.stash)
                          if self.stash is not None else None)
        oks, ns = [], []
        for hi, lo, valid, n in self._chunks(keys):
            if self.stash is not None:
                state, stash, ok = self.ops.insert_spill(
                    self.state, self.stash, hi, lo, valid=valid)
                self.stash = stash
            else:
                state, ok = self.ops.insert(self.state, hi, lo, valid=valid)
            self.state = state
            oks.append(ok)
            ns.append(n)
        failed = int((~collect_chunk_results(oks, ns)).sum()) if oks else 0
        if self.stash is not None:
            self.stats.stash_spills += int(
                stash_occupancy(self.stash) - spilled_before)
        if failed:
            # Table AND (when configured) stash exhausted: emergency grow +
            # rebuild; the keystore already holds the whole batch, so the
            # rebuild IS the retry (never double-insert).
            self.stats.failed_inserts += failed
            self._resize(ResizeDecision(
                new_capacity=min(self.capacity * 2, self.config.c_max),
                reason="grow"))
        return np.ones(keys.size, dtype=bool)

    def delete(self, keys) -> np.ndarray:
        """Verified delete (paper §IV): only keystore-present keys reach the
        filter, so foreign fingerprints are never removed.  The presence
        check is one vectorized keystore op, not a per-key loop.

        With a stash configured, a key whose fingerprint sits in the stash
        (not the table) is removed from the keystore but its stash entry
        lingers as a false positive until the next rebuild re-derives the
        stash — the standard filter trade (false positives allowed, false
        negatives never)."""
        keys = np.asarray(keys, dtype=np.uint64)
        self.stats.deletes += keys.size
        present = self.keystore.remove(keys)
        self.stats.blind_deletes_blocked += int((~present).sum())
        victims = keys[present]
        if victims.size:
            for hi, lo, valid, _n in self._chunks(victims):
                state, _ok = self.ops.delete(self.state, hi, lo, valid=valid)
                self.state = state
        self._maybe_resize(ops=keys.size)
        return present

    def contains_key_exact(self, key: int) -> bool:
        return self.keystore.contains(int(key))

    def contains_keys_exact(self, keys) -> np.ndarray:
        """Vectorized ground truth: residency mask bool[B] in one keystore
        pass (``measure_false_positives`` probes millions of keys — the
        scalar form would loop Python per key)."""
        return self.keystore.contains_batch(keys)

    # ---------------------------------------------------------- control --

    def _maybe_resize(self, extra: int = 0, ops: int = 1) -> None:
        decision = self.policy.observe(items=self.count + extra,
                                       capacity=self.capacity, ops=ops)
        if decision is not None:
            self._resize(decision)

    def _rebuild_into(self, active_buckets: int, buffer_buckets: int) -> bool:
        """Rebuild from the keystore; the stash (when configured) restarts
        empty — rebuilding re-homes previously stashed fingerprints into the
        (larger) table and garbage-collects entries whose key was deleted
        while stashed."""
        keys = self.keystore.materialize()
        state = make_state(active_buckets, self.config.bucket_size,
                           buffer_buckets=buffer_buckets, device=self.device)
        stash = (make_stash(self.config.stash_slots, device=self.device)
                 if self.stash is not None else None)
        oks = []
        for hi, lo, valid, n in self._chunks(keys):
            if stash is not None:
                state, stash, ok = self.ops.insert_spill(state, stash, hi,
                                                         lo, valid=valid)
            else:
                state, ok = self.ops.insert(state, hi, lo, valid=valid)
            oks.append(ok[:n])
        # One sync after every chunk is queued (not one per chunk).
        ok_all = bool(torch.cat(oks).all()) if oks else True
        if ok_all:
            self.state = state
            self.stash = stash
            self.stats.rebuild_keys += keys.size
        return ok_all

    def _resize(self, decision: ResizeDecision) -> None:
        new_active = self._snap_buckets(decision.new_capacity)
        if new_active == int(self.state.n_buckets):
            return
        buf = self.state.table.shape[0]
        # Reallocate the buffer only when the active size outgrows it or
        # drops below a quarter of it (reclaim memory); pow2 sizes keep
        # reallocations to O(log range).
        if new_active > buf or new_active * 4 < buf:
            buf = pow2_at_least(new_active)
            self.stats.buffer_reallocs += 1
        while not self._rebuild_into(new_active, max(buf, pow2_at_least(
                new_active))):
            # Shrink too tight even after clamping: grow until it fits.
            new_active *= 2
            buf = pow2_at_least(new_active)
        self.stats.resizes += 1
        if decision.reason == "grow":
            self.stats.grows += 1
        else:
            self.stats.shrinks += 1
        self.capacity_history.append(self.capacity)
