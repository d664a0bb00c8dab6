"""Overflow stash: the shared math of the insert and probe kernels.

Counterpart of ``repro.kernels.stash``.  Layout: an ``int32[2, slots]``
tensor holding uint32 bit patterns —

  * row 0: fingerprints (0 == EMPTY; real fingerprints are never 0);
  * row 1: the bucket the entry was bound for when it was stashed.

Because the alternate index is an involution, whichever bucket of the pair
a chain held at exhaustion identifies the pair: a probe matches a stash
entry when the fingerprints agree AND the stored bucket is either of its
two candidate buckets.

These are plain tensor functions; the CUDA kernels implement the same
match (``csrc/probe.cu``) and spill (``csrc/insert.cu``).  The stash
delete runs outside the kernels, as in the reference.
"""
from __future__ import annotations

import torch

from repro_torch.core import hashing
from repro_torch.core.scheduling import pair_rank

DEFAULT_STASH_SLOTS = 128
# Lane x slot pairs up to which ``stash_delete`` takes its dense, sync-free
# form (a 4096-lane wave on a 128-slot stash is 2^19).
DENSE_DELETE_PAIRS = 1 << 22


def make_stash(slots: int = DEFAULT_STASH_SLOTS, *, device="cuda"
               ) -> torch.Tensor:
    """Fresh empty stash: int32[2, slots] of zeros on ``device``."""
    if slots <= 0:
        raise ValueError("a stash needs at least one slot")
    return torch.zeros((2, slots), dtype=torch.int32,
                       device=hashing.resolve_device(device))


def stash_occupancy(stash: torch.Tensor) -> torch.Tensor:
    """Live entry count -> int64 0-dim tensor (stays on the device)."""
    return (stash[0] != 0).sum()


def stash_match(stash: torch.Tensor, fp: torch.Tensor, i1: torch.Tensor,
                i2: torch.Tensor) -> torch.Tensor:
    """Membership of (fp, {i1, i2}) lanes against the stash -> bool[N].

    Empty slots hold fp == 0, which no real fingerprint equals.
    """
    s_fp = hashing.to_u32(stash[0])[None, :]
    s_bkt = hashing.to_u32(stash[1])[None, :]
    fp = hashing.to_u32(fp)[:, None]
    i1 = hashing.to_u32(i1)[:, None]
    i2 = hashing.to_u32(i2)[:, None]
    hit = (s_fp == fp) & ((s_bkt == i1) | (s_bkt == i2))
    return hit.any(dim=1)


def stash_spill(stash: torch.Tensor, carried: torch.Tensor,
                bucket: torch.Tensor, want: torch.Tensor) -> torch.Tensor:
    """Spill ``want`` lanes' (carried fp, bucket) into free stash slots,
    IN PLACE -> spilled bool[N].

    Lanes are ranked in lane order and lane i takes the rank-th empty slot;
    lanes whose rank reaches the free-slot count miss.
    """
    empty_slots = torch.nonzero(stash[0] == 0).flatten()
    rank = torch.cumsum(want.to(torch.int64), 0) - 1
    fits = want & (rank < empty_slots.numel())
    slot = empty_slots[rank[fits]]
    stash[0, slot] = hashing.to_i32(carried[fits])
    stash[1, slot] = hashing.to_i32(bucket[fits])
    return fits


def stash_delete(stash: torch.Tensor, fp: torch.Tensor, i1: torch.Tensor,
                 i2: torch.Tensor, want: torch.Tensor) -> torch.Tensor:
    """Clear ``want`` lanes' matching stash entries IN PLACE -> cleared[N].

    Lane i matches slots whose fingerprint equals ``fp[i]`` and whose
    stored bucket is either candidate, is ranked among earlier want-lanes
    with the same (home bucket, fingerprint) pair (``pair_rank``), and
    clears the rank-th matching slot; lanes whose rank reaches the match
    count report False.  A cleared slot zeroes both rows.
    """
    if want.numel() * stash.shape[1] <= DENSE_DELETE_PAIRS:
        return _stash_delete_dense(stash, fp, i1, i2, want)
    cleared = torch.zeros_like(want)
    lanes = torch.nonzero(want).flatten()   # ranks among want lanes only
    if lanes.numel() == 0:
        return cleared
    fp, i1, i2 = fp[lanes], i1[lanes], i2[lanes]
    s_fp = hashing.to_u32(stash[0])[None, :]
    s_bkt = hashing.to_u32(stash[1])[None, :]
    match = (s_fp == hashing.to_u32(fp)[:, None]) & (
        (s_bkt == hashing.to_u32(i1)[:, None])
        | (s_bkt == hashing.to_u32(i2)[:, None]))                 # [L, S]
    rank = pair_rank(i1, fp, torch.ones_like(lanes, dtype=torch.bool))
    hit = rank < match.sum(dim=1)
    match_pos = torch.cumsum(match.to(torch.int64), dim=1) - 1
    slot = (match & (match_pos == rank[:, None])).to(torch.int8).argmax(1)
    stash[:, slot[hit]] = 0
    cleared[lanes] = hit
    return cleared


def _stash_delete_dense(stash, fp, i1, i2, want):
    """``stash_delete`` over every (lane, slot) pair at once: the same
    clears, with no host sync (no ``nonzero``), for batches small enough
    that an [N, S] mask is cheap (a serving wave)."""
    s_fp = hashing.to_u32(stash[0])[None, :]
    s_bkt = hashing.to_u32(stash[1])[None, :]
    i1 = hashing.to_u32(i1)[:, None]
    match = want[:, None] & (s_fp == hashing.to_u32(fp)[:, None]) & (
        (s_bkt == i1) | (s_bkt == hashing.to_u32(i2)[:, None]))  # [N, S]
    rank = pair_rank(i1[:, 0], fp, want)    # ranks among want lanes only
    hit = want & (rank < match.sum(dim=1))
    match_pos = torch.cumsum(match.to(torch.int64), dim=1) - 1
    chosen = match & (match_pos == rank[:, None]) & hit[:, None]
    stash.masked_fill_(chosen.any(dim=0)[None, :], 0)
    return hit


def _hash(hi, lo, fp_bits: int, n_buckets: int):
    fp = hashing.fingerprint(hi, lo, fp_bits)
    i1 = hashing.index_hash(hi, lo, n_buckets)
    return fp, i1, hashing.alt_index(i1, fp, n_buckets)


def stash_probe_ref(stash: torch.Tensor, hi: torch.Tensor, lo: torch.Tensor,
                    *, fp_bits: int, n_buckets: int) -> torch.Tensor:
    """Hash a key batch and match it against the stash."""
    fp, i1, i2 = _hash(hi, lo, fp_bits, n_buckets)
    return stash_match(stash, fp, i1, i2)


def stash_spill_ref(stash: torch.Tensor, hi: torch.Tensor, lo: torch.Tensor,
                    want: torch.Tensor, *, fp_bits: int, n_buckets: int
                    ) -> torch.Tensor:
    """Spill whole keys, bound for their alternate bucket, IN PLACE
    -> spilled bool[N]."""
    fp, _i1, i2 = _hash(hi, lo, fp_bits, n_buckets)
    return stash_spill(stash, fp, i2, want)


def stash_delete_ref(stash: torch.Tensor, hi: torch.Tensor, lo: torch.Tensor,
                     want: torch.Tensor, *, fp_bits: int, n_buckets: int
                     ) -> torch.Tensor:
    """Hash a key batch and clear its stash entries IN PLACE -> cleared[N]
    (the whole-key pass the deletes compose after the table pass)."""
    fp, i1, i2 = _hash(hi, lo, fp_bits, n_buckets)
    return stash_delete(stash, fp, i1, i2, want)
