"""Paged-prefix KV-cache index backed by the filters.

Counterpart of ``repro.serving.kvcache``.  Token streams are chunked into
fixed-size blocks; each block's rolling content hash is a key.  The index
answers "is this prefix block cached somewhere?" in O(1) filter probes
before any page table is consulted:

  * ``PrefixCacheIndex`` keeps the keys in an ``OCF`` (true deletes on
    eviction, EOF resizes under admission bursts);
  * ``GenerationalPrefixIndex`` keeps them in the streaming generation
    ring, where freshness replaces the LRU delete loop.

Both run on the card by default (``device="cuda"``) and raise without one.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from repro_torch.core.hashing import murmur3_mix_np, splitmix32_np
from repro_torch.core.ocf import OCF, OcfConfig
from repro_torch.streaming.generations import (GenerationalFilter,
                                               GenerationConfig)


def block_hashes(tokens: np.ndarray, block: int = 64) -> np.ndarray:
    """Rolling prefix hashes, one uint64 key per complete block.

    Hash of block i commits to ALL tokens in blocks 0..i (prefix semantics:
    a block is reusable only if the entire prefix matches).
    """
    tokens = np.asarray(tokens, dtype=np.uint32)
    n = tokens.size // block
    keys = np.zeros(n, dtype=np.uint64)
    h_hi = np.uint32(0x9E3779B9)
    h_lo = np.uint32(0x85EBCA6B)
    with np.errstate(over="ignore"):  # uint32 wraparound is the hash mix
        for i in range(n):
            blk = tokens[i * block:(i + 1) * block]
            for off in range(0, block, 4):  # mix 4 tokens per round
                h_lo = murmur3_mix_np(h_lo ^ splitmix32_np(
                    np.bitwise_xor.reduce(blk[off:off + 4])))
                h_hi = splitmix32_np(h_hi + h_lo)
            keys[i] = (np.uint64(h_hi) << np.uint64(32)) | np.uint64(h_lo)
    return keys


@dataclasses.dataclass
class PrefixStats:
    queries: int = 0
    block_hits: int = 0
    block_misses: int = 0
    admitted: int = 0
    evicted: int = 0


class PrefixCacheIndex:
    """OCF-backed membership index over cached KV prefix blocks.

    ``backend`` optionally overrides the OCF's filter backend; ``device``
    places the default OCF (a given ``config`` carries its own).
    """

    def __init__(self, config: Optional[OcfConfig] = None, block: int = 64,
                 max_blocks: int = 1 << 16, backend: Optional[str] = None,
                 device: str = "cuda"):
        self.block = block
        self.max_blocks = max_blocks
        config = config or OcfConfig(capacity=4096, mode="EOF", device=device)
        if backend is not None:
            config = dataclasses.replace(config, backend=backend)
        self.ocf = OCF(config)
        self.stats = PrefixStats()
        self._lru: list[int] = []   # admitted block keys, oldest first

    def match_prefix(self, tokens: np.ndarray) -> int:
        """Longest cached prefix in *tokens*, in complete blocks."""
        keys = block_hashes(tokens, self.block)
        self.stats.queries += 1
        if keys.size == 0:
            return 0
        hits = self.ocf.lookup(keys)
        n = 0
        while n < len(hits) and hits[n]:
            n += 1
        self.stats.block_hits += n
        self.stats.block_misses += len(hits) - n
        return n

    def admit(self, tokens: np.ndarray) -> int:
        """Insert all blocks of a finished prefill; evict LRU on pressure."""
        keys = block_hashes(tokens, self.block)
        if keys.size == 0:
            return 0
        new = keys[~self.ocf.lookup(keys)]
        if new.size:
            self.ocf.insert(new)
            self._lru.extend(int(k) for k in new)
            self.stats.admitted += new.size
        while len(self._lru) > self.max_blocks:
            victim = self._lru.pop(0)
            self.ocf.delete(np.array([victim], dtype=np.uint64))
            self.stats.evicted += 1
        return int(new.size)

    def evict(self, tokens: np.ndarray) -> int:
        """Verified delete of a sequence's blocks (paper's safe-delete)."""
        keys = block_hashes(tokens, self.block)
        ok = self.ocf.delete(keys)
        lru_set = set(int(k) for k in keys[ok])
        self._lru = [k for k in self._lru if k not in lru_set]
        self.stats.evicted += int(ok.sum())
        return int(ok.sum())

    @property
    def hit_rate(self) -> float:
        tot = self.stats.block_hits + self.stats.block_misses
        return self.stats.block_hits / tot if tot else 0.0


class GenerationalPrefixIndex:
    """Prefix-cache index over TTL-aged filter generations (streaming).

    Same duck API as ``PrefixCacheIndex`` (``match_prefix`` / ``admit`` /
    ``evict`` / ``hit_rate``) but backed by ``GenerationalFilter``:
    admitted blocks land in the active generation, lookups probe every
    live generation plus the overflow stashes in one fused launch per
    chunk, and stale blocks age out when their generation's TTL expires or
    the ring rotates past them.  ``evict`` is therefore a no-op, and the
    page-table layer must treat the index as advisory: false positives
    possible, false negatives never, within the freshness window.
    """

    def __init__(self, block: int = 64, *,
                 config: Optional[GenerationConfig] = None,
                 backend: Optional[str] = None, ttl: Optional[float] = None,
                 generations: int = 4, capacity: int = 4096,
                 now: Optional[float] = None, device: str = "cuda"):
        """``now`` is the stream epoch: pass it (and every later ``now``)
        when driving TTLs on a logical clock; omit all of them for wall
        time.  ``device`` places the ring when no ``config`` is given."""
        self.block = block
        if config is None:
            config = GenerationConfig(
                generations=generations, capacity=capacity, ttl=ttl,
                backend=backend if backend is not None else "auto",
                device=device)
        self.filt = GenerationalFilter(config, now=now)
        self.stats = PrefixStats()

    def match_prefix(self, tokens: np.ndarray,
                     now: Optional[float] = None) -> int:
        """Longest cached prefix in *tokens*, in complete blocks.

        Matched blocks resident only in an *aging* generation are promoted
        (re-inserted into the active one), so a continuously-hot prefix
        never ages out.
        """
        keys = block_hashes(tokens, self.block)
        self.stats.queries += 1
        if keys.size == 0:
            return 0
        hits = self.filt.lookup(keys, now=now)
        n = 0
        while n < len(hits) and hits[n]:
            n += 1
        if n:
            hot = keys[:n]
            in_active = self.filt.lookup_active(hot, now=now)
            if not in_active.all():
                self.filt.insert(hot[~in_active], now=now)
        self.stats.block_hits += n
        self.stats.block_misses += len(hits) - n
        return n

    def admit(self, tokens: np.ndarray, now: Optional[float] = None) -> int:
        """Insert all blocks of a finished prefill into the active gen."""
        keys = block_hashes(tokens, self.block)
        if keys.size == 0:
            return 0
        new = keys[~self.filt.lookup(keys, now=now)]
        if new.size:
            self.filt.insert(new, now=now)
            self.stats.admitted += new.size
        return int(new.size)

    def evict(self, tokens: np.ndarray) -> int:
        """No-op: generational aging (TTL/rotation) replaces per-key
        eviction; see the class docstring."""
        del tokens
        return 0

    @property
    def hit_rate(self) -> float:
        tot = self.stats.block_hits + self.stats.block_misses
        return self.stats.block_hits / tot if tot else 0.0
