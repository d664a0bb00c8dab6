"""TTL-aged filter generations: the streaming membership data plane.

Counterpart of ``repro.streaming.generations``, with the same decisions:
K rotating filter **generations**, inserts into the newest, lookups across
all live ones, and expiry by **retiring a whole generation** (an O(1)
state drop instead of per-key deletes).

  * every generation is a ``FilterState`` plus an overflow stash, driven
    through ``FilterOps.insert_spill`` (bounded eviction rounds, stash
    spill);
  * all generations share one **preallocated buffer pool** (one
    int32[K, buffer, bucket_size] tensor of pow2 tables and one
    int32[K, 2, S] of stashes on the device, allocated once; a generation
    holds one slot of each, and retirement zeroes it in place), so the
    ring never allocates a table or a stash after construction;
  * every lookup chunk is ONE fused ``probe_multi`` launch that reads the
    pool directly and probes the live generations' slots (keys hashed
    once);
  * TTL expiry is **lazy**: an expired generation stops answering at once
    (it is filtered out of the probe set by timestamp) and its buffer is
    reclaimed on the next rotation/advance.

A full-and-stashed insert failure rotates early and retries once in the
fresh generation.

The reference stacks the live generations' arrays into the kernel's
[K, ...] inputs and caches the stack by their identity.  Here the insert
kernel updates the pool IN PLACE and ``probe_multi`` takes the live slots,
so there is no stack to copy or to go stale.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Literal, Optional

import numpy as np
import torch

from repro_torch.core.chunking import (collect_chunk_results, key_chunks,
                                       pow2_at_least)
from repro_torch.core.filter import FilterState
from repro_torch.core.filter_ops import FilterOps, evict_rounds_for_load
from repro_torch.core.hashing import resolve_device
from repro_torch.core.scheduling import dedupe_keys
from repro_torch.kernels.stash import DEFAULT_STASH_SLOTS, stash_occupancy
from repro_torch.streaming.stash import OverflowStash


@dataclasses.dataclass(frozen=True)
class GenerationConfig:
    """Shape and policy of the generation ring."""

    generations: int = 4             # K live generations (the probe fan-out)
    capacity: int = 1 << 14          # item slots per generation
    bucket_size: int = 4
    fp_bits: int = 16
    stash_slots: int = DEFAULT_STASH_SLOTS
    backend: Literal["cuda", "auto"] = "auto"
    evict_rounds: Optional[int] = None   # None -> derived from o_max
    o_max: float = 0.85              # rotate when the active table fills past
    stash_high: float = 0.5          # ... or the active stash fills past
    ttl: Optional[float] = None      # seconds a generation stays live
    # Host-side lookup dedup (probe one lane per distinct key in a batch).
    # Off by default: all-unique batches would pay the np.unique sort for
    # nothing; dedup-window streams should turn it on.
    dedupe_lookups: bool = False
    # Where the ring lives.  "cuda" (default) needs a card and raises
    # without one; "cpu" runs the kernels' plain PyTorch versions.
    device: str = "cuda"

    def __post_init__(self):
        # A generation has no grow path (it rotates instead), so the stash
        # IS its burst absorber and a stash-less ring is a config error.
        if self.stash_slots < 1:
            raise ValueError(
                "GenerationConfig.stash_slots must be >= 1: generations "
                "absorb eviction storms in the stash (they rotate instead "
                "of growing); use OcfConfig(stash_slots=0) for a stash-"
                "less filter")
        if self.generations < 1:
            raise ValueError("GenerationConfig.generations must be >= 1")

    @property
    def n_buckets(self) -> int:
        return max(1, -(-self.capacity // self.bucket_size))

    def make_filter_ops(self) -> FilterOps:
        """Conflict-aware wave scheduling of insert batches, and in-place
        updates of the ring's pool (its generations are views of it)."""
        rounds = (self.evict_rounds if self.evict_rounds is not None
                  else evict_rounds_for_load(self.o_max))
        return FilterOps(fp_bits=self.fp_bits, backend=self.backend,
                         evict_rounds=rounds, schedule=True, donate=True)


@dataclasses.dataclass
class GenStats:
    inserts: int = 0
    lookups: int = 0
    rotations: int = 0
    expirations: int = 0             # generations retired by TTL
    spills: int = 0                  # fingerprints parked in stashes
    rotate_retries: int = 0          # inserts that needed the early-rotate


@dataclasses.dataclass
class _Generation:
    state: FilterState
    stash: OverflowStash
    born: float
    expires: Optional[float]         # None = no TTL
    slot: int                        # its table and stash in the pool

    def live(self, now: float) -> bool:
        return self.expires is None or now < self.expires


class _BufferPool:
    """K preallocated slots, each a pow2 table and a stash, recycled
    across generations.

    ``tables`` is int32[K, buffer_buckets, bucket_size] and ``stashes``
    int32[K, 2, S], both allocated once: a generation holds slot i and
    works on the views ``tables[i]`` and ``stashes[i]``.  ``release``
    zeroes a retired slot in place and hands it back, so every generation
    the ring ever creates lives in the two original allocations.
    """

    def __init__(self, k: int, buffer_buckets: int, bucket_size: int,
                 stash_slots: int, device: torch.device):
        self.tables = torch.zeros((k, buffer_buckets, bucket_size),
                                  dtype=torch.int32, device=device)
        self.stashes = torch.zeros((k, 2, stash_slots), dtype=torch.int32,
                                   device=device)
        self._free = list(range(k - 1, -1, -1))

    def acquire(self) -> int:
        assert self._free, "buffer pool exhausted (more gens than K?)"
        return self._free.pop()

    def release(self, slot: int) -> None:
        self.tables[slot].zero_()
        self.stashes[slot].zero_()
        self._free.append(slot)


class GenerationalFilter:
    """K rotating TTL-aged filter generations with per-generation stashes.

    All ``now`` parameters share ONE clock domain: pass nothing anywhere and
    the wall clock (``time.monotonic``) drives TTLs, or pass your own
    logical timestamps everywhere (tests, replay, event-time streams).  The
    constructor takes the stream's epoch for the same reason: the first
    generation's TTL starts there.
    """

    def __init__(self, config: GenerationConfig | None = None,
                 now: Optional[float] = None, metrics=None):
        """``metrics``: optional ``repro_torch.obs.MetricsRegistry``:
        rotation / TTL-expiry events become counters; None costs nothing."""
        self.config = config or GenerationConfig()
        self.device = resolve_device(self.config.device)
        self.metrics = metrics
        self.ops = self.config.make_filter_ops()
        buf = pow2_at_least(self.config.n_buckets)
        self.pool = _BufferPool(self.config.generations, buf,
                                self.config.bucket_size,
                                self.config.stash_slots, self.device)
        self.gens: list[_Generation] = []
        self.stats = GenStats()
        self._last_now: Optional[float] = None
        self._spawn(self._now(now))

    # --------------------------------------------------------- plumbing --

    def _now(self, now: Optional[float]) -> float:
        """Resolve a timestamp, remembering the caller's clock domain.

        The last ``now`` seen becomes the default for argument-less reads
        (``len``, ``live_generations``); callers who never pass ``now`` get
        the wall clock throughout.
        """
        if now is not None:
            self._last_now = now
            return now
        return time.monotonic() if self._last_now is None else self._last_now

    def _spawn(self, now: float) -> None:
        cfg = self.config
        slot = self.pool.acquire()
        state = FilterState(
            self.pool.tables[slot],
            torch.zeros((), dtype=torch.int64, device=self.device),
            cfg.n_buckets)
        ttl = None if cfg.ttl is None else now + cfg.ttl
        self.gens.append(_Generation(
            state, OverflowStash(cfg.stash_slots,
                                 array=self.pool.stashes[slot]),
            born=now, expires=ttl, slot=slot))

    def _retire(self, gen: _Generation, *, expired: bool) -> None:
        self.pool.release(gen.slot)
        if expired:
            self.stats.expirations += 1
            if self.metrics is not None:
                self.metrics.counter("generation_expirations").inc()

    @property
    def active(self) -> _Generation:
        return self.gens[-1]

    def _live(self, now: float) -> list[_Generation]:
        return [g for g in self.gens if g.live(now)]

    def _chunks(self, keys: np.ndarray, *, with_valid: bool = True):
        return key_chunks(keys, with_valid=with_valid, device=self.device)

    # ------------------------------------------------------------- fill --

    @property
    def fill(self) -> float:
        """Active generation's table occupancy (rotation + admission input)."""
        return int(self.active.state.count) / self.config.capacity

    @property
    def stash_fill(self) -> float:
        """Active generation's stash occupancy in [0, 1]."""
        return self.active.stash.fill

    def fills(self) -> tuple[float, float]:
        """(table fill, stash fill) of the active generation in ONE device
        transfer: what the admission controller polls."""
        count, occ = self._control_read()
        return count / self.config.capacity, occ / self.config.stash_slots

    @property
    def live_generations(self) -> int:
        return len(self._live(self._now(None)))

    def __len__(self) -> int:
        """Table-resident fingerprints across all generations (approx.)."""
        return sum(int(g.state.count) + g.stash.occupancy for g in self.gens)

    # ---------------------------------------------------------- control --

    def advance(self, now: Optional[float] = None) -> int:
        """Reclaim expired generations' buffers; returns how many retired.

        Lookups already ignore expired generations (lazy expiry); this
        returns their buffers to the pool.  The active generation is
        replaced with a fresh one if it expired.
        """
        now = self._now(now)
        dead = [g for g in self.gens if not g.live(now)]
        for g in dead:
            self.gens.remove(g)
            self._retire(g, expired=True)
        if not self.gens:
            self._spawn(now)
        return len(dead)

    def rotate(self, now: Optional[float] = None) -> None:
        """Seal the active generation and open a fresh one (O(1) aging)."""
        now = self._now(now)
        self.advance(now)
        if len(self.gens) >= self.config.generations:
            oldest = self.gens.pop(0)
            self._retire(oldest, expired=False)
        self._spawn(now)
        self.stats.rotations += 1
        if self.metrics is not None:
            self.metrics.counter("generation_rotations").inc()

    def _control_read(self) -> tuple[int, int]:
        """Active generation's (table count, stash occupancy) in ONE
        device-to-host transfer: the only per-chunk sync the insert path
        pays."""
        gen = self.active
        pair = torch.stack([gen.state.count.to(torch.int64),
                            stash_occupancy(gen.stash.array).to(torch.int64)])
        count, occ = pair.tolist()
        return count, occ

    # ------------------------------------------------------------- ops ---

    def insert(self, keys, now: Optional[float] = None) -> np.ndarray:
        """Insert a batch into the active generation -> ok bool[N].

        Overflow order: table -> bounded eviction rounds -> stash -> early
        rotation + one retry in the fresh generation.  ``ok`` is False only
        when even the retry fails (a chunk larger than a whole generation's
        capacity: a sizing error, not a burst).  Every chunk's ok mask
        comes back in one stacked transfer; the rotation decision costs one
        combined scalar read per chunk (``_control_read``), which doubles
        as the spill accounting.
        """
        now = self._now(now)
        keys = np.asarray(keys, dtype=np.uint64)
        self.stats.inserts += keys.size
        self.advance(now)
        out = np.ones(keys.size, dtype=bool)
        cfg = self.config
        count, occ = self._control_read()
        oks, ns = [], []
        for hi, lo, valid, n in self._chunks(keys):
            if (count / cfg.capacity >= cfg.o_max
                    or occ / cfg.stash_slots >= cfg.stash_high):
                self.rotate(now)
                count = occ = 0
            prev_occ = occ
            oks.append(self._insert_chunk(hi, lo, valid))
            ns.append(n)
            count, occ = self._control_read()
            self.stats.spills += occ - prev_occ
        idx = (np.flatnonzero(~collect_chunk_results(oks, ns)) if oks
               else np.zeros((0,), np.intp))   # one transfer, all chunks
        if idx.size:
            # Even the stash overflowed: rotate early and retry ONCE in the
            # fresh generation (the streaming analogue of emergency grow).
            self.stats.rotate_retries += idx.size
            self.rotate(now)
            off = 0
            for hi, lo, valid, n in self._chunks(keys[idx]):
                ok = self._insert_chunk(hi, lo, valid).cpu().numpy()[:n]
                out[idx[off:off + n]] = ok
                off += n
            _count, occ = self._control_read()
            self.stats.spills += occ               # fresh gen started at 0
        return out

    def _insert_chunk(self, hi, lo, valid) -> torch.Tensor:
        """One device insert into the active generation -> ok (on device).

        The table and stash are updated in place in the pool; only the
        count is new."""
        gen = self.active
        gen.state, _stash, ok = self.ops.insert_spill(
            gen.state, gen.stash.array, hi, lo, valid=valid)
        return ok

    def lookup(self, keys, now: Optional[float] = None) -> np.ndarray:
        """Membership across every live generation -> bool[N]."""
        return self._lookup(keys, now, active_only=False)

    def lookup_active(self, keys, now: Optional[float] = None) -> np.ndarray:
        """Membership in the ACTIVE generation only -> bool[N].

        The promote-on-read primitive of a multi-level design: a key that
        hits overall but misses here lives in an aging generation, and a
        caller that wants it to survive rotation re-inserts it (see
        ``serving.kvcache.GenerationalPrefixIndex.match_prefix``).
        """
        return self._lookup(keys, now, active_only=True)

    def _lookup(self, keys, now: Optional[float], *, active_only: bool
                ) -> np.ndarray:
        now = self._now(now)
        keys = np.asarray(keys, dtype=np.uint64)
        self.stats.lookups += keys.size
        live = self._live(now)
        if active_only:
            live = [g for g in live if g is self.gens[-1]]
        if not live:
            return np.zeros(keys.size, bool)
        if self.config.dedupe_lookups:
            uniq, inverse = dedupe_keys(keys)
        else:
            uniq, inverse = keys, None
        # ONE fused probe_multi launch per chunk over the pool's live
        # slots; the chunks' hits come back in one stacked transfer.
        prober = self.ops.fanout_prober(
            self.pool.tables, self.pool.stashes,
            n_buckets=self.config.n_buckets, gens=[g.slot for g in live])
        hits, ns = [], []
        for hi, lo, _valid, n in self._chunks(uniq, with_valid=False):
            hits.append(prober(hi, lo))
            ns.append(n)
        out = collect_chunk_results(hits, ns)
        return out[inverse] if inverse is not None else out
