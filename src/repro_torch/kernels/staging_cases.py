"""Seeded inputs that stress the staged filter kernels, as numpy arrays.

``STAGING_CASES`` and ``ADAPTIVE_STAGING_CASES`` name shapes that drive the
insert and delete kernels (``csrc/insert*.cu``, ``csrc/delete*.cu``)
through what their shared-memory staging makes hard: tiny tables whose
rows many blocks share, calls of several windows, blocks whose lane region
is in device memory, bucket sizes 2 and 8, and (for the four adaptive
planes) adapted and scrambled slots that chains kick and roll back.  The
tests hold the kernels against their plain versions on these inputs, and
so does ``chip_smoke.py`` on the card: one source, so that both see the
same arrays for a label and seed.
"""
from __future__ import annotations

import numpy as np

from repro_torch.core import hashing


def random_keys(rng: np.random.RandomState, n: int) -> np.ndarray:
    """``n`` uint64 keys below 2^63 from ``rng``."""
    return rng.randint(0, 2 ** 63, size=n, dtype=np.int64).astype(np.uint64)


def adaptive_planes(rng, n_buckets, buffer, load, *, fp_bits=16,
                    bucket_size=4, sel_share=0.25):
    """A consistent four-plane adaptive state, uint32 numpy: keys placed in
    their home buckets up to ``load``, and a ``sel_share`` of the occupied
    slots given a nonzero selector with the fingerprint rewritten under it
    -> (table, sels, khi, klo, resident keys)."""
    keys = random_keys(rng, int(n_buckets * bucket_size * load * 1.6))
    hi, lo = hashing.key_to_u32_pair_np(keys)
    home = hashing.index_hash_np(hi, lo, n_buckets).astype(np.int64)
    order = np.argsort(home, kind="stable")
    start = np.searchsorted(home[order], home[order], side="left")
    rank = np.empty_like(home)
    rank[order] = np.arange(keys.size) - start
    take = np.nonzero(rank < bucket_size)[0][: int(n_buckets * bucket_size
                                                   * load)]
    shape = (buffer, bucket_size)
    khi, klo = np.zeros(shape, np.uint32), np.zeros(shape, np.uint32)
    sel = np.zeros(shape, np.uint32)
    b, s = home[take], rank[take]
    khi[b, s], klo[b, s] = hi[take], lo[take]
    adapt = rng.rand(take.size) < sel_share
    sel[b[adapt], s[adapt]] = rng.randint(1, 4, size=int(adapt.sum()))
    table = np.zeros(shape, np.uint32)
    table[b, s] = hashing.fingerprint_sel_np(khi[b, s], klo[b, s], sel[b, s],
                                             fp_bits)
    sels = (sel << (2 * np.arange(bucket_size, dtype=np.uint32))).sum(
        axis=1, keepdims=True, dtype=np.uint32)
    return table, sels, khi, klo, keys[take]


# Inputs that stress the staged insert and delete kernels (rows staged in
# shared memory a window of logical blocks at a time): label -> (buffer,
# active buckets, bucket size, keys, block, eviction rounds, stash slots,
# table load, stash load).  A tiny active table shares rows across blocks
# and windows and runs long chains that roll back into a nearly full
# stash; 8192 keys at block 128 are three windows, the last one short;
# blocks 1024 and 8192 take the device-memory lane region (8192 also
# stages only part of its rows); bucket sizes 2 and 8.
STAGING_CASES = {
    "tiny-table": (128, 64, 4, 1024, 128, 8, 16, 0.5, 0.75),
    "three-windows": (4096, 4000, 4, 8192, 128, 32, 128, 0.8, 0.0),
    "block-1024": (2048, 2000, 4, 4096, 1024, 16, 32, 0.85, 0.0),
    "block-8192": (4096, 4000, 4, 8192, 8192, 8, 0, 0.7, 0.0),
    "bucket-2": (4096, 3000, 2, 2048, 256, 32, 8, 0.8, 0.0),
    "bucket-8": (1024, 1000, 8, 2048, 128, 32, 0, 0.85, 0.0),
}


def staging_inputs(label, seed=0):
    """numpy inputs of a STAGING_CASES case: a dict with the uint32 table
    and stash (None without one), the insert keys (the first quarter twice,
    in other blocks), their valid mask, and the delete keys (the first
    half, then the first quarter twice more: the k-th repeat clears the
    k-th copy, one more than resident reports False)."""
    buf, nb, bsz, n, block, rounds, slots, load, stash_load = \
        STAGING_CASES[label]
    rng = np.random.RandomState(seed)
    fill = rng.rand(buf, bsz) < load
    table = np.where(fill, rng.randint(1, 1 << 16, size=(buf, bsz)),
                     0).astype(np.uint32)
    table[nb:] = 0
    stash = None
    if slots:
        stash = np.zeros((2, slots), np.uint32)
        used = rng.rand(slots) < stash_load
        stash[0, used] = rng.randint(1, 1 << 16, size=used.sum())
        stash[1, used] = rng.randint(0, nb, size=used.sum())
    base = random_keys(rng, n)
    keys = np.concatenate([base[: n - n // 4], base[: n // 4]])
    delete = np.concatenate([base[: n // 2], base[: n // 4], base[: n // 4]])
    return dict(table=table, stash=stash, keys=keys,
                valid=rng.rand(n) < 0.95, delete=delete,
                delete_valid=np.ones(delete.size, bool), n_buckets=nb,
                block=block, rounds=rounds)


# The same shapes for the adaptive insert and delete kernels, over four
# planes: label -> (buffer, active buckets, bucket size, keys, block,
# eviction rounds, stash slots, table load, stash load, selector share).
# The planes hold resident keys in their home buckets, a share of them on
# a nonzero selector, and one slot in ten scrambled (a fingerprint that
# is no family member of its mirror key), so that rollback has to restore
# every plane verbatim.  "tiny-rollback" is a tiny table near full with
# few rounds and no stash: chains kick adapted slots and roll back.
ADAPTIVE_STAGING_CASES = {
    **{label: (*case, 0.3) for label, case in STAGING_CASES.items()},
    "tiny-rollback": (128, 64, 4, 1024, 128, 3, 0, 0.95, 0.0, 0.6),
}


def adaptive_staging_inputs(label, seed=0):
    """numpy inputs of an ADAPTIVE_STAGING_CASES case: a dict with the
    uint32 planes and stash (None without one), the resident keys, the
    insert keys (the first quarter twice, in other blocks), their valid
    mask, and the delete keys (the first half of the insert keys, their
    first quarter again, then residents, cycled to a quarter of the
    keys)."""
    buf, nb, bsz, n, block, rounds, slots, load, stash_load, share = \
        ADAPTIVE_STAGING_CASES[label]
    rng = np.random.RandomState(seed)
    table, sels, khi, klo, members = adaptive_planes(
        rng, nb, buf, load, bucket_size=bsz, sel_share=share)
    scramble = (table != 0) & (rng.rand(buf, bsz) < 0.1)
    table[scramble] = rng.randint(1, 1 << 16, size=int(scramble.sum()))
    stash = None
    if slots:
        stash = np.zeros((2, slots), np.uint32)
        used = rng.rand(slots) < stash_load
        stash[0, used] = rng.randint(1, 1 << 16, size=used.sum())
        stash[1, used] = rng.randint(0, nb, size=used.sum())
    base = random_keys(rng, n)
    keys = np.concatenate([base[: n - n // 4], base[: n // 4]])
    delete = np.concatenate([base[: n // 2], base[: n // 4],
                             np.resize(members, n // 4)])
    return dict(planes=[table, sels, khi, klo], stash=stash, members=members,
                keys=keys, valid=rng.rand(n) < 0.95, delete=delete,
                delete_valid=np.ones(delete.size, bool), n_buckets=nb,
                block=block, rounds=rounds)
