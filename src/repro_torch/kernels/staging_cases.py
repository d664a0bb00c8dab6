"""Seeded inputs that stress the filter kernels, as numpy arrays.

``STAGING_CASES`` and ``ADAPTIVE_STAGING_CASES`` name shapes that drive the
insert and delete kernels (``csrc/insert*.cu``, ``csrc/delete*.cu``)
through what their shared-memory staging makes hard: tiny tables whose rows
many blocks share, calls of several windows, blocks whose lane region is in
device memory, bucket sizes 2 and 8, and (for the four adaptive planes)
adapted and scrambled slots that chains kick and roll back.
``PROBE_MULTI_CASES`` do the same for ``csrc/probe_multi.cu``'s stash
prefilter, its batched bucket loads and its launches of 64 pool slots, and
``PROBE_ADAPTIVE_CASES`` for ``csrc/probe_adaptive.cu``'s (the same
prefilter over one stash, selector words read only for rows that match a
family fingerprint, the alternate row only where the home row missed), and
``PROBE_CASES`` for ``csrc/probe.cu``'s (the same prefilter over one
stash, and its telemetry instantiation: keys answered at every depth,
padding lanes that hit and must not count), and ``FINGERPRINT_CASES`` for
``csrc/fingerprint.cu`` (ragged sizes up to its serving paths' largest
launches, and views that start inside their storage), and ``SCAN_CASES``
for ``csrc/scan.cu`` (chains that fail and roll back at load 0.97, spills
into a stash that fills, active counts below the buffer, bucket size 8, a
stack of shards with mostly-invalid lanes, duplicate deletes; and, for
the kernels' window and conflict-group schedules, crowded rows, windows
whose chains cross their edges, spills inside a window, self-pairs, and
deletes of one fingerprint across one bucket pair).  The
tests hold the kernels against their plain versions on these inputs, and so
does ``chip_smoke.py`` on the card: one source, so that both see the same
arrays for a label and seed.
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


# Inputs that stress probe_multi (``csrc/probe_multi.cu``): its stash
# prefilter (a compact list of the live entries and a map of their 16-bit
# fingerprint folds), its bucket loads issued for all live generations at
# once, and its launches of 64 pool slots: label -> (pool slots, live
# slots, buffer, active buckets, bucket size, fp_bits, stash slots, keys,
# table load, stash load, stash mix).  Live slots fewer than the pool are
# a random subset in random order.  The mix shares the filled stash
# entries between (exact: a probe key's fingerprint and one of its
# buckets; same fingerprint, another bucket; another fingerprint of the
# same 16-bit fold, a right bucket; random).  A quarter of the keys are
# also planted in a random slot's table, live or not.
PROBE_MULTI_MIX = (0.25, 0.25, 0.25, 0.25)
PROBE_MULTI_CASES = {
    # every live stash full: 512 entries, one staging pass
    "full-stashes": (4, 4, 4096, 4000, 4, 16, 128, 4096, 0.8, 1.0,
                     PROBE_MULTI_MIX),
    # 64 live slots of full stashes: 8192 entries, eight staging passes
    "full-64-slots": (64, 64, 256, 250, 4, 16, 128, 4096, 0.5, 1.0,
                      PROBE_MULTI_MIX),
    # the map's bit set, the exact compare misses
    "same-fp-other-bucket": (4, 4, 2048, 2000, 4, 16, 64, 4096, 0.8, 0.8,
                             (0.1, 0.9, 0.0, 0.0)),
    # 32-bit fingerprints whose folds collide but whose values differ
    "fp32-folds": (4, 4, 2048, 2000, 4, 32, 128, 4096, 0.8, 0.9,
                   (0.2, 0.2, 0.5, 0.1)),
    # 8-bit fingerprints: 512 entries over 255 values, a dense map
    "fp8-dense": (4, 4, 2048, 2000, 4, 8, 128, 4096, 0.8, 1.0,
                  PROBE_MULTI_MIX),
    "all-empty": (4, 4, 2048, 2000, 4, 16, 128, 4096, 0.8, 0.0,
                  PROBE_MULTI_MIX),
    "pool-5": (5, 3, 1024, 1000, 4, 16, 32, 4096, 0.7, 0.5,
               PROBE_MULTI_MIX),
    "pool-65": (65, 40, 256, 250, 4, 16, 32, 4096, 0.5, 0.5,
                PROBE_MULTI_MIX),
    "pool-130": (130, 100, 256, 250, 4, 16, 32, 4096, 0.5, 0.5,
                 PROBE_MULTI_MIX),
    "n-1": (3, 3, 1024, 1000, 4, 16, 32, 1, 0.8, 0.5, PROBE_MULTI_MIX),
    "n-1000": (3, 3, 1024, 1000, 4, 16, 32, 1000, 0.8, 0.5,
               PROBE_MULTI_MIX),
    "n-5000": (3, 3, 1024, 1000, 4, 16, 32, 5000, 0.8, 0.5,
               PROBE_MULTI_MIX),
    "bucket-2": (4, 4, 2048, 2000, 2, 16, 64, 4096, 0.8, 0.5,
                 PROBE_MULTI_MIX),
    "bucket-8": (4, 4, 1024, 1000, 8, 16, 64, 4096, 0.8, 0.5,
                 PROBE_MULTI_MIX),
}


def probe_multi_inputs(label, seed=0):
    """numpy inputs of a PROBE_MULTI_CASES case: a dict with the uint32
    tables [K, buffer, bucket size] and stashes [K, 2, S] (None without
    stash slots), ``gens`` (the live slots; None when all K are live), the
    uint64 keys, fp_bits, n_buckets and the block the reference takes
    (128, or the key count where that is no multiple of it)."""
    (k, live, buf, nb, bsz, fp_bits, slots, n, load, stash_load,
     mix) = PROBE_MULTI_CASES[label]
    rng = np.random.RandomState(seed)
    top = 1 << fp_bits
    fill = rng.rand(k, buf, bsz) < load
    tables = np.where(fill, rng.randint(1, top, size=(k, buf, bsz),
                                        dtype=np.int64), 0).astype(np.uint32)
    tables[:, nb:] = 0
    keys = random_keys(rng, n)
    hi, lo = hashing.key_to_u32_pair_np(keys)
    fp = hashing.fingerprint_np(hi, lo, fp_bits)
    i1 = hashing.index_hash_np(hi, lo, nb)
    i2 = hashing.alt_index_np(i1, fp, nb)
    plant = np.nonzero(rng.rand(n) < 0.25)[0]
    home = rng.rand(plant.size) < 0.5
    tables[rng.randint(0, k, plant.size),
           np.where(home, i1[plant], i2[plant]),
           rng.randint(0, bsz, plant.size)] = fp[plant]
    stashes = None
    if slots:
        stashes = np.zeros((k, 2, slots), np.uint32)
        used = np.nonzero(rng.rand(k * slots) < stash_load)[0]
        j = rng.randint(0, n, used.size)
        kind = rng.choice(4, size=used.size, p=mix)
        right = np.where(rng.rand(used.size) < 0.5, i1[j], i2[j])
        other = (i1[j] + 1 + rng.randint(0, max(nb - 2, 1), used.size)) % nb
        bad = (other == i1[j]) | (other == i2[j])
        while bad.any():
            other[bad] = rng.randint(0, nb, int(bad.sum()))
            bad = (nb > 2) & ((other == i1[j]) | (other == i2[j]))
        flip = np.uint32(0x10001 if fp_bits > 16 else 1)
        folded = fp[j] ^ flip
        folded = np.where(folded == 0, np.uint32(1), folded)
        e_fp = np.select([kind == 0, kind == 1, kind == 2],
                         [fp[j], fp[j], folded],
                         rng.randint(1, top, used.size, dtype=np.int64))
        e_bkt = np.select([kind == 0, kind == 1, kind == 2],
                          [right, other, right],
                          rng.randint(0, nb, used.size))
        stashes[used // slots, 0, used % slots] = e_fp.astype(np.uint32)
        stashes[used // slots, 1, used % slots] = e_bkt.astype(np.uint32)
    gens = None if live == k else rng.permutation(k)[:live].tolist()
    return dict(tables=tables, stashes=stashes, gens=gens, keys=keys,
                fp_bits=fp_bits, n_buckets=nb,
                block=128 if n % 128 == 0 else n)


# Inputs that stress probe_adaptive (``csrc/probe_adaptive.cu``): its stash
# prefilter over one stash, its selector words read only for rows in which
# some slot equals one of the key's four family fingerprints, and its
# alternate row loaded only for keys the home row did not answer (every
# case, small or large, runs the code of the adaptive path's 10M-key
# launches): label -> (buffer, active buckets, bucket size, fp_bits, stash
# slots, keys, table load, selector share, stash load, stash mix, decoy
# share).  The planes come from ``adaptive_planes`` (residents in their
# home buckets, a selector share of them adapted).  Half the probe keys are
# residents, half random.  The mix shares the filled stash entries as in
# PROBE_MULTI_MIX, against the probe keys' selector-0 fingerprints.  A
# decoy share of the random keys gets a slot of its home or alternate row
# rewritten to its family fingerprint fam[j] under a selector other than
# j, which must miss.
PROBE_ADAPTIVE_MIX = PROBE_MULTI_MIX
PROBE_ADAPTIVE_CASES = {
    # the adaptive path's stash, full: 128 entries
    "stash-128-full": (4096, 4000, 4, 16, 128, 4096, 0.8, 0.25, 1.0,
                       PROBE_ADAPTIVE_MIX, 0.1),
    # 512 entries, one staging pass
    "stash-512-full": (4096, 4000, 4, 16, 512, 4096, 0.8, 0.25, 1.0,
                       PROBE_ADAPTIVE_MIX, 0.1),
    # the path's stash as it is there: empty (no map, no walk)
    "stash-empty": (4096, 4000, 4, 16, 128, 4096, 0.8, 0.25, 0.0,
                    PROBE_ADAPTIVE_MIX, 0.1),
    # 2500 slots: three staging passes in every CTA
    "stash-2500": (2048, 2000, 4, 16, 2500, 5000, 0.8, 0.25, 0.9,
                   PROBE_ADAPTIVE_MIX, 0.1),
    # the map's bit set, the exact compare misses
    "same-fp-other-bucket": (4096, 4000, 4, 16, 128, 4096, 0.8, 0.25, 0.8,
                             (0.1, 0.9, 0.0, 0.0), 0.1),
    # 32-bit fingerprints whose folds collide but whose values differ
    "fp32-folds": (4096, 4000, 4, 32, 128, 4096, 0.8, 0.25, 0.9,
                   (0.2, 0.2, 0.5, 0.1), 0.1),
    # 8-bit fingerprints: a dense map, and many rows that match a family
    # fingerprint, so selector words are read
    "fp8-dense": (2048, 2000, 4, 8, 128, 4096, 0.8, 0.25, 1.0,
                  PROBE_ADAPTIVE_MIX, 0.1),
    # slots holding fam[j] under a selector other than j
    "wrong-selector": (2048, 2000, 4, 16, 128, 4096, 0.8, 0.5, 0.5,
                       PROBE_ADAPTIVE_MIX, 0.6),
    # most resident slots adapted, the whole buffer active
    "adapted-rows": (2048, 2048, 4, 16, 128, 4096, 0.9, 0.9, 0.5,
                     PROBE_ADAPTIVE_MIX, 0.1),
    "bucket-1": (4096, 4000, 1, 16, 64, 4096, 0.8, 0.3, 0.5,
                 PROBE_ADAPTIVE_MIX, 0.1),
    "bucket-2": (4096, 4000, 2, 16, 64, 4096, 0.8, 0.3, 0.5,
                 PROBE_ADAPTIVE_MIX, 0.1),
    "bucket-8": (1024, 1000, 8, 16, 64, 4096, 0.8, 0.3, 0.5,
                 PROBE_ADAPTIVE_MIX, 0.1),
    "n-1": (1024, 1000, 4, 16, 32, 1, 0.8, 0.25, 0.5, PROBE_ADAPTIVE_MIX,
            0.1),
    "n-1000": (1024, 1000, 4, 16, 32, 1000, 0.8, 0.25, 0.5,
               PROBE_ADAPTIVE_MIX, 0.1),
    "n-5000": (1024, 1000, 4, 16, 32, 5000, 0.8, 0.25, 0.5,
               PROBE_ADAPTIVE_MIX, 0.1),
    # more keys than one wave of resident CTAs, on a 2^16-bucket table
    "n-1.1M": (1 << 16, (1 << 16) - 100, 4, 16, 128, 1_100_032, 0.8, 0.25,
               0.5, PROBE_ADAPTIVE_MIX, 0.05),
}


def probe_adaptive_inputs(label, seed=0):
    """numpy inputs of a PROBE_ADAPTIVE_CASES case: a dict with the uint32
    table [buffer, bucket size], packed selector plane [buffer, 1] and
    stash [2, S], the uint64 probe keys, fp_bits, n_buckets and the block
    the reference takes (128, or the key count where that is no multiple
    of it)."""
    (buf, nb, bsz, fp_bits, slots, n, load, share, stash_load, mix,
     decoy) = PROBE_ADAPTIVE_CASES[label]
    rng = np.random.RandomState(seed)
    table, sels, _khi, _klo, members = adaptive_planes(
        rng, nb, buf, load, fp_bits=fp_bits, bucket_size=bsz,
        sel_share=share)
    half = n // 2
    keys = np.concatenate([members[rng.randint(0, members.size, half)],
                           random_keys(rng, n - half)])
    hi, lo = hashing.key_to_u32_pair_np(keys)
    fam = np.stack([hashing.fingerprint_sel_np(hi, lo, j, fp_bits)
                    for j in range(4)])
    i1 = hashing.index_hash_np(hi, lo, nb)
    i2 = hashing.alt_index_np(i1, fam[0], nb)
    k = half + np.nonzero(rng.rand(n - half) < decoy)[0]
    row = np.where(rng.rand(k.size) < 0.5, i1[k], i2[k])
    slot = rng.randint(0, bsz, k.size)
    sel = rng.randint(0, 4, k.size).astype(np.uint32)
    j = (sel + rng.randint(1, 4, k.size)) % 4
    table[row, slot] = fam[j, k]
    shift = (2 * slot).astype(np.uint32)
    sels[row, 0] = (sels[row, 0] & ~(np.uint32(3) << shift)) | (sel << shift)
    stash = np.zeros((2, slots), np.uint32)
    used = np.nonzero(rng.rand(slots) < stash_load)[0]
    e = rng.randint(0, n, used.size)
    kind = rng.choice(4, size=used.size, p=mix)
    right = np.where(rng.rand(used.size) < 0.5, i1[e], i2[e])
    other = (i1[e] + 1 + rng.randint(0, max(nb - 2, 1), used.size)) % nb
    bad = (other == i1[e]) | (other == i2[e])
    while bad.any():
        other[bad] = rng.randint(0, nb, int(bad.sum()))
        bad = (nb > 2) & ((other == i1[e]) | (other == i2[e]))
    flip = np.uint32(0x10001 if fp_bits > 16 else 1)
    folded = fam[0, e] ^ flip
    folded = np.where(folded == 0, np.uint32(1), folded)
    stash[0, used] = np.select(
        [kind == 0, kind == 1, kind == 2], [fam[0, e], fam[0, e], folded],
        rng.randint(1, 1 << fp_bits, used.size, dtype=np.int64))
    stash[1, used] = np.select([kind == 0, kind == 1, kind == 2],
                               [right, other, right],
                               rng.randint(0, nb, used.size))
    return dict(table=table, sels=sels, stash=stash, keys=keys,
                fp_bits=fp_bits, n_buckets=nb,
                block=128 if n % 128 == 0 else n)


# fingerprint_hash's stress cases (``csrc/fingerprint.cu``): (keys,
# elements the key views start into their storage).  Small and ragged n
# up to the serving paths' largest launches (2^19 keys) with 1-3 keys past
# a multiple of four, and views one element into their storage, which no
# 16-byte access may read.
FINGERPRINT_CASES = ((1, 0), (3, 0), (4097, 0), (4097, 1),
                     ((1 << 17) + 5, 0), ((1 << 17) + 5, 1),
                     ((1 << 19) + 5, 0), ((1 << 19) + 5, 1))


# Inputs for probe.cu, its stash prefilter and its telemetry instantiation
# (the probe-depth plane): label -> (buffer, active buckets, bucket size,
# fp_bits, stash slots, keys, counted keys, table load, stash load[, stash
# mix]).  A quarter of the keys are planted in their home bucket, a quarter
# in their alternate bucket, and (with a stash) some of the rest in the
# stash; the lanes after the counted ones are padding, key 0, which is
# planted too, so that a kernel counting them would differ.  Without a mix
# every filled stash entry holds a counted key's fingerprint at one of its
# buckets; with one, the filled entries are shared as in PROBE_MULTI_MIX
# (exact; same fingerprint, a third bucket; another fingerprint of the same
# 16-bit fold, a right bucket; random).
PROBE_MIX = PROBE_MULTI_MIX
PROBE_CASES = {
    "stash-128-padded": (4096, 4000, 4, 16, 128, 4096, 4000, 0.8, 0.5),
    "no-stash": (4096, 4000, 4, 16, 0, 4096, 4096, 0.8, 0.0),
    "n-1000-padded": (1024, 1000, 4, 16, 32, 1000, 990, 0.8, 0.5),
    "stash-2500": (2048, 2000, 4, 16, 2500, 5000, 4999, 0.8, 0.3),
    "bucket-8": (1024, 1000, 8, 16, 64, 2048, 2000, 0.85, 0.5),
    # the serving paths' stash, every slot live
    "stash-128-full": (4096, 4000, 4, 16, 128, 4096, 4000, 0.8, 1.0,
                       PROBE_MIX),
    # the map's bit set, the exact compare misses (a third bucket)
    "same-fp-other-bucket": (4096, 4000, 4, 16, 128, 4096, 4000, 0.8, 0.8,
                             (0.1, 0.9, 0.0, 0.0)),
    # 32-bit fingerprints whose folds collide but whose values differ
    "fp32-folds": (4096, 4000, 4, 32, 128, 4096, 4000, 0.8, 0.9,
                   (0.2, 0.2, 0.5, 0.1)),
    # 8-bit fingerprints: 128 entries over 255 values, a dense map
    "fp8-dense": (2048, 2000, 4, 8, 128, 4096, 4000, 0.8, 1.0, PROBE_MIX),
    # one slot; 1025 slots, two staging passes in every CTA
    "stash-1": (1024, 1000, 4, 16, 1, 1024, 1000, 0.8, 1.0,
                (1.0, 0.0, 0.0, 0.0)),
    "stash-1025": (2048, 2000, 4, 16, 1025, 4096, 4000, 0.8, 0.9,
                   PROBE_MIX),
    "bucket-1": (4096, 4000, 1, 16, 64, 4096, 4000, 0.8, 0.5, PROBE_MIX),
    "bucket-8-mixed": (1024, 1000, 8, 16, 64, 4096, 4000, 0.85, 0.8,
                       PROBE_MIX),
    "n-1": (1024, 1000, 4, 16, 32, 1, 1, 0.8, 0.5, PROBE_MIX),
    "n-4097": (4096, 4000, 4, 16, 128, 4097, 4090, 0.8, 0.5, PROBE_MIX),
    # more keys than a launch that loads both buckets at once
    # (csrc/probe.cu's kEagerKeys): the alternate bucket after the home one
    "n-20000": (4096, 4000, 4, 16, 128, 20000, 19990, 0.8, 0.5, PROBE_MIX),
}
# The cases whose counted keys reach every depth (home, alternate, and
# with their stash the stash), which tests of the depth plane require.
PROBE_DEPTH_CASES = ("stash-128-padded", "no-stash", "n-1000-padded",
                     "stash-2500", "bucket-8")


def probe_inputs(label, seed=0):
    """numpy inputs of a PROBE_CASES case: a dict with the uint32 table
    and stash (None without stash slots), the uint64 keys (padding key 0
    after the counted ones), the counted count, fp_bits, n_buckets and the
    block the reference takes (128, or the key count where that is no
    multiple of it)."""
    buf, nb, bsz, fp_bits, slots, n, counted, load, stash_load, *mix = \
        PROBE_CASES[label]
    rng = np.random.RandomState(seed)
    fill = rng.rand(buf, bsz) < load
    table = np.where(fill, rng.randint(1, 1 << fp_bits, size=(buf, bsz)),
                     0).astype(np.uint32)
    table[nb:] = 0
    keys = random_keys(rng, n)
    keys[counted:] = 0
    hi, lo = hashing.key_to_u32_pair_np(keys)
    fp = hashing.fingerprint_np(hi, lo, fp_bits)
    i1 = hashing.index_hash_np(hi, lo, nb)
    i2 = hashing.alt_index_np(i1, fp, nb)
    where = rng.randint(0, 4, n)
    where[counted:] = 0                      # the padding key, at home
    slot = rng.randint(0, bsz, n)
    home, alt = where == 0, where == 1
    table[i1[home], slot[home]] = fp[home]
    table[i2[alt], slot[alt]] = fp[alt]
    stash = None
    if slots:
        stash = np.zeros((2, slots), np.uint32)
        used = np.nonzero(rng.rand(slots) < stash_load)[0]
        e = rng.randint(0, counted, used.size)
        right = np.where(rng.rand(used.size) < 0.5, i1[e], i2[e])
        stash[0, used] = fp[e]
        stash[1, used] = right
        if mix:
            kind = rng.choice(4, size=used.size, p=mix[0])
            other = (i1[e] + 1 + rng.randint(0, max(nb - 2, 1), used.size)
                     ) % nb
            bad = (other == i1[e]) | (other == i2[e])
            while bad.any():
                other[bad] = rng.randint(0, nb, int(bad.sum()))
                bad = (nb > 2) & ((other == i1[e]) | (other == i2[e]))
            flip = np.uint32(0x10001 if fp_bits > 16 else 1)
            folded = fp[e] ^ flip
            folded = np.where(folded == 0, np.uint32(1), folded)
            stash[0, used] = np.select(
                [kind == 0, kind == 1, kind == 2], [fp[e], fp[e], folded],
                rng.randint(1, 1 << fp_bits, used.size, dtype=np.int64))
            stash[1, used] = np.select([kind == 0, kind == 1, kind == 2],
                                       [right, other, right],
                                       rng.randint(0, nb, used.size))
    return dict(table=table, stash=stash, keys=keys, counted=counted,
                fp_bits=fp_bits, n_buckets=nb,
                block=128 if n % 128 == 0 else n)


# ------------------------------------------------------------- scan walks --
#
# label -> (kind, shards, n_buckets, buffer, bucket_size, prefill load,
#           lanes a shard, valid share, max_disp, stash slots, live stash[,
#           extras]); extras: ``fp_bits`` (16 by default), ``rows`` and
# ``fps`` (pair lanes' home rows drawn from ``rows`` consecutive rows and
# their fingerprints from ``fps`` values, so that their pairs crowd onto a
# few dozen rows).  The later cases drive the kernels' schedules: windows
# whose speculations are mostly dirty, chains that cross a window's edge,
# spills inside a window, deletes of one fingerprint whose home bucket is
# another lane's alternate, self-pairs (i1 == i2), absent keys, and rows
# wider than the insert kernel's 15-slot masks.
SCAN_CASES = {
    "key-load-0.97": ("key", 1, 1 << 12, 1 << 12, 4, 0.0, 1 << 14, 1.0,
                      500, 0, 0),
    "key-spill-active": ("key", 1, 3000, 1 << 12, 4, 0.85, 4096, 1.0, 8,
                         16, 3),
    "key-bs8": ("key", 2, 1 << 10, 1 << 10, 8, 0.8, 4096, 0.9, 16, 0, 0),
    "pair-stash-16": ("pair", 1, 1 << 12, 1 << 12, 4, 0.9, 4096, 1.0, 64,
                      16, 4),
    "pair-shards": ("pair", 4, 1 << 10, 1 << 10, 4, 0.7, 8192, 0.15, 64,
                    128, 40),
    "delete-dups": ("delete", 1, 1 << 12, 1 << 12, 4, 0.9, 1 << 14, 1.0,
                    0, 0, 0),
    "delete-shards": ("delete", 3, 1 << 10, 1 << 10, 4, 0.8, 4096, 0.3, 0,
                      0, 0),
    "pair-crowded": ("pair", 1, 1 << 12, 1 << 12, 4, 0.3, 2048, 1.0, 32,
                     32, 4, {"rows": 40, "fps": 3}),
    "pair-windows": ("pair", 1, 1 << 12, 1 << 12, 4, 0.45, 10000, 1.0, 64,
                     16, 0),
    "key-spill-window": ("key", 2, 1 << 11, 1 << 11, 4, 0.9, 2048, 1.0, 4,
                         64, 8),
    "key-tiny-n": ("key", 1, 61, 64, 4, 0.5, 1024, 1.0, 32, 16, 2,
                   {"fp_bits": 6}),
    "pair-self-bs2": ("pair", 2, 37, 40, 2, 0.3, 512, 0.8, 16, 8, 0,
                      {"fp_bits": 6}),
    "delete-fp4": ("delete", 2, 64, 64, 4, 0.9, 2048, 1.0, 0, 0, 0,
                   {"fp_bits": 4}),
    "key-bs16": ("key", 1, 200, 256, 16, 0.85, 2048, 1.0, 32, 8, 2),
}


def _fill_home_or_alt(rng, table, n_buckets, load, fp_bits):
    """Place random keys, home bucket else alternate, until ``load`` of the
    active slots is taken -> the placed keys' (hi, lo), uint32."""
    bs = table.shape[1]
    want = int(n_buckets * bs * load)
    keys = random_keys(rng, int(want * 1.5) + 16)
    hi, lo = hashing.key_to_u32_pair_np(keys)
    fp = hashing.fingerprint_np(hi, lo, fp_bits)
    i1 = hashing.index_hash_np(hi, lo, n_buckets)
    i2 = hashing.alt_index_np(i1, fp, n_buckets)
    fill = (table != 0).sum(axis=1)
    placed = []
    for k in range(keys.size):
        if len(placed) >= want:
            break
        for b in (int(i1[k]), int(i2[k])):
            if fill[b] < bs:
                table[b, fill[b]] = fp[k]
                fill[b] += 1
                placed.append(k)
                break
    placed = np.asarray(placed, np.int64)
    return hi[placed], lo[placed]


def scan_inputs(label, seed=0):
    """Inputs of a ``SCAN_CASES`` case, uint32 / bool numpy: (tables [S,
    buffer, b], stashes [S, 2, slots] or None, a [S, L], b [S, L], valid
    [S, L], kwargs of the walk: mode (``"key"``, ``"pair"``, or
    ``"delete"`` for ``scan_delete``), n_buckets, fp_bits, max_disp)."""
    (kind, shards, nb, buf, bs, load, lanes, share, max_disp, slots,
     live, *extras) = SCAN_CASES[label]
    extras = extras[0] if extras else {}
    rng = np.random.RandomState(seed + 11)
    fp_bits = extras.get("fp_bits", 16)
    tables = np.zeros((shards, buf, bs), np.uint32)
    a = np.zeros((shards, lanes), np.uint32)
    b = np.zeros((shards, lanes), np.uint32)
    for s in range(shards):
        shard_load = load * (0.8 + 0.2 * s / max(shards - 1, 1))
        hi, lo = _fill_home_or_alt(rng, tables[s], nb, shard_load, fp_bits)
        if kind == "delete":
            # residents, some of them twice over, and absent keys
            pick = rng.randint(0, hi.size, lanes)
            absent = rng.rand(lanes) < 0.1
            khi, klo = hashing.key_to_u32_pair_np(random_keys(rng, lanes))
            a[s] = np.where(absent, khi, hi[pick])
            b[s] = np.where(absent, klo, lo[pick])
        elif kind == "key":
            a[s], b[s] = hashing.key_to_u32_pair_np(random_keys(rng, lanes))
        elif "rows" in extras:
            start = rng.randint(0, nb)
            a[s] = ((start + rng.randint(0, extras["rows"], lanes)) % nb
                    ).astype(np.uint32)
            fps = rng.randint(1, 1 << fp_bits, extras["fps"])
            b[s] = fps[rng.randint(0, fps.size, lanes)].astype(np.uint32)
        else:
            a[s] = rng.randint(0, 1 << 31, lanes).astype(np.uint32)
            b[s] = rng.randint(1, 1 << fp_bits, lanes).astype(np.uint32)
    valid = rng.rand(shards, lanes) < share
    stashes = None
    if slots:
        stashes = np.zeros((shards, 2, slots), np.uint32)
        for s in range(shards):
            at = rng.choice(slots, size=live, replace=False)
            stashes[s, 0, at] = rng.randint(1, 1 << fp_bits, live)
            stashes[s, 1, at] = rng.randint(0, nb, live)
    return tables, stashes, a, b, valid, dict(
        mode=kind, n_buckets=nb, fp_bits=fp_bits, max_disp=max_disp)
