"""Fused hash + bulk insert with bounded eviction rounds (kernels 3 and 8).

Counterpart of ``repro.kernels.insert.insert_bulk`` / ``insert_once`` and
of ``insert_bulk_adaptive`` (the four-plane insert, at the end of this
module).
Per logical block, in order, with the table (and stash) carried from block
to block:

  1. two optimistic placement rounds (home bucket, then alternate): each
     lane takes the rank-th empty slot of its bucket;
  2. up to ``evict_rounds`` eviction rounds while any lane still carries a
     fingerprint: phase A places the carried fingerprint into an empty
     slot; phase B lets the rank-0 lane of each bucket kick the first
     non-dirty slot (rotating from ``steps % bucket_size``) and chase the
     victim to its alternate bucket;
  3. with a stash, exhausted lanes spill their carried fingerprint into it;
  4. lanes that still fail roll their kicks back, newest first.

The CUDA kernel (``csrc/insert.cu``) is one CTA walking the logical blocks
in order, with a window's rows staged in shared memory and a block-local
dirty set on chip.  The plain version below follows the same block /
round / rank schedule in int64-masked tensor ops and keeps the
reference's table-shaped dirty mask.  Both update ``table`` (and
``stash``) IN PLACE.
"""
from __future__ import annotations

import torch

from repro_torch.core import hashing
from repro_torch.core.scheduling import dispatch_order_from_buckets
from repro_torch.kernels import cuda
from repro_torch.kernels.fingerprint import fingerprint_hash
from repro_torch.kernels.rank import rank_among_earlier
from repro_torch.kernels.selector import sel_pack, sel_unpack
from repro_torch.kernels.stash import stash_spill
from repro_torch.kernels.telemetry import KICK_BINS, insert_plane

DEFAULT_BLOCK = 1024
# Bounded eviction budget: 32 rounds drain random batches at the OCF's
# o_max = 0.85 operating load; the loop exits as soon as every lane lands.
DEFAULT_EVICT_ROUNDS = 32


def _first_true(mask: torch.Tensor) -> torch.Tensor:
    """Index of the first True along dim 1, else 0 (argmax of a bool row)."""
    return mask.to(torch.int8).argmax(dim=1)


def _place_round(table, target, active, value):
    """One placement attempt for every active lane into ``target`` buckets
    (reads see the table as before the round) -> placed bool[N]."""
    rank = rank_among_earlier(target, active)
    empty = table[target] == 0                            # [n, bucket_size]
    fits = active & (rank < empty.sum(dim=1))
    empty_pos = torch.cumsum(empty.to(torch.int64), dim=1) - 1
    slot = _first_true(empty & (empty_pos == rank[:, None]))
    table[target[fits], slot[fits]] = value[fits]
    return fits


def _evict_rounds(table, stash, fp, start_bucket, residue, n_buckets,
                  rounds: int, want_stats: bool = False):
    """Bounded eviction rounds, stash spill and rollback for the residue
    -> completed bool[N]; with ``want_stats`` also the per-lane
    (steps, spilled, failed): kicks of the lane's chain, whether it
    spilled to the stash, whether it rolled back."""
    buf, bucket_size = table.shape
    n = fp.shape[0]
    dev = table.device
    dirty = torch.zeros((buf, bucket_size), dtype=torch.bool, device=dev)
    carried, bucket = fp.clone(), start_bucket.clone()
    active = residue.clone()
    steps = torch.zeros((n,), dtype=torch.int64, device=dev)
    hb = torch.zeros((n, rounds), dtype=torch.int64, device=dev)
    hs = torch.zeros_like(hb)
    hw = torch.zeros_like(hb)
    t_iota = torch.arange(rounds, device=dev)
    slot_iota = torch.arange(bucket_size, device=dev)
    r = 0
    while r < rounds and bool(active.any()):
        # phase A: the carried fp into an empty slot of the current bucket.
        placed = _place_round(table, bucket, active, hashing.to_i32(carried))
        active = active & ~placed
        # A lane that landed never rolls back: release its kicked slots.
        rel = placed[:, None] & (t_iota[None, :] < steps[:, None])
        dirty[hb[rel], hs[rel]] = False
        # phase B: one kick per bucket, earliest active lane wins.
        first = active & (rank_among_earlier(bucket, active) == 0)
        pos = (slot_iota[None, :] + (steps % bucket_size)[:, None]) \
            % bucket_size
        cand_free = ~torch.gather(dirty[bucket], 1, pos)
        kick = first & cand_free.any(dim=1)
        slot = torch.gather(pos, 1, _first_true(cand_free)[:, None])[:, 0]
        victim = hashing.to_u32(table[bucket, slot])
        kb, ks = bucket[kick], slot[kick]
        table[kb, ks] = hashing.to_i32(carried[kick])
        dirty[kb, ks] = True
        lanes = torch.nonzero(kick).flatten()
        col = steps[lanes]
        hb[lanes, col] = kb
        hs[lanes, col] = ks
        hw[lanes, col] = carried[lanes]
        nxt = hashing.alt_index(bucket, victim, n_buckets)
        carried = torch.where(kick, victim, carried)
        bucket = torch.where(kick, nxt, bucket)
        steps = steps + kick.to(torch.int64)
        r += 1
    spilled = torch.zeros_like(active)
    if stash is not None:
        spilled = stash_spill(stash, carried, bucket, active)
        active = active & ~spilled
    failed = active
    if bool(failed.any()):
        cur = carried
        for k in range(rounds):
            t = steps - 1 - k
            do = failed & (t >= 0)
            if not bool(do.any()):
                break
            tc = t.clamp(0, rounds - 1)[:, None]
            b = torch.gather(hb, 1, tc)[:, 0]
            s = torch.gather(hs, 1, tc)[:, 0]
            table[b[do], s[do]] = hashing.to_i32(cur[do])
            cur = torch.where(do, torch.gather(hw, 1, tc)[:, 0], cur)
    if want_stats:
        return residue & ~failed, (steps, spilled, failed)
    return residue & ~failed


def _no_stats(n: int, device):
    """Per-lane (steps, spilled, failed) of lanes that never kicked."""
    zero = torch.zeros((n,), dtype=torch.bool, device=device)
    return torch.zeros((n,), dtype=torch.int64, device=device), zero, zero


def _insert_block(table, stash, hi, lo, valid, n_buckets, *, fp_bits: int,
                  evict_rounds: int, want_stats: bool = False):
    """One logical block -> ok, or (ok, (steps, spilled, failed)) with
    ``want_stats``: lanes placed without a kick have 0 steps; with no
    eviction rounds no lane rolls back, and with a stash the optimistic
    residue spills straight away (the reference's accounting)."""
    fp = hashing.fingerprint(hi, lo, fp_bits)
    i1 = hashing.index_hash(hi, lo, n_buckets)
    i2 = hashing.alt_index(i1, fp, n_buckets)
    fp32 = hashing.to_i32(fp)
    ok = _place_round(table, i1, valid, fp32)
    ok = ok | _place_round(table, i2, valid & ~ok, fp32)
    stats = _no_stats(hi.shape[0], hi.device)
    if evict_rounds > 0:
        # Chains start at the alternate bucket, like the sequential path.
        done = _evict_rounds(table, stash, fp, i2, valid & ~ok, n_buckets,
                             evict_rounds, want_stats=want_stats)
        if want_stats:
            done, stats = done
        ok = ok | done
    elif stash is not None:
        spilled = stash_spill(stash, fp, i2, valid & ~ok)
        ok = ok | spilled
        stats = (stats[0], spilled, stats[2])
    return (ok, stats) if want_stats else ok


def _cat_stats(outs):
    """Concatenate per-block (ok, stats) -> (ok, (steps, spilled, failed))."""
    ok = torch.cat([o for o, _ in outs])
    return ok, tuple(torch.cat(parts) for parts in zip(*(s for _, s in outs)))


def insert_bulk_plain(table: torch.Tensor, hi: torch.Tensor,
                      lo: torch.Tensor, valid: torch.Tensor, *, fp_bits: int,
                      n_buckets: int, evict_rounds: int,
                      stash: torch.Tensor | None, block: int,
                      want_stats: bool = False):
    """Plain PyTorch version: logical blocks in order, IN PLACE -> ok; with
    ``want_stats`` (ok, (steps, spilled, failed)) per lane."""
    cuda.PLAIN_CALLS["insert_bulk"] += 1
    ok = [_insert_block(table, stash, hi[s:s + block], lo[s:s + block],
                        valid[s:s + block], n_buckets, fp_bits=fp_bits,
                        evict_rounds=evict_rounds, want_stats=want_stats)
          for s in range(0, hi.shape[0], block)]
    return _cat_stats(ok) if want_stats else torch.cat(ok)


def _insert_cuda(table, hi, lo, valid, *, fp_bits, n_buckets, evict_rounds,
                 stash, block, plane=None):
    cuda.check_cuda("insert_bulk", table=table, hi=hi, lo=lo, valid=valid,
                    stash=stash)
    cuda.check_dtype("insert_bulk", torch.int32, table=table, hi=hi, lo=lo,
                     stash=stash)
    cuda.check_dtype("insert_bulk", torch.bool, valid=valid)
    cuda.check_table("insert_bulk", table, n_buckets, stash)
    if table.shape[1] > 256 or table.numel() >= 2**32 - 1:
        raise ValueError(f"insert_bulk: the kernel keeps a kicked slot in "
                         f"one byte and its (bucket, slot) in 32 bits, so "
                         f"bucket_size <= 256 and fewer than 2^32 - 1 "
                         f"slots; got {tuple(table.shape)}")
    n = hi.shape[0]
    slots = 0 if stash is None else stash.shape[1]
    ok = torch.empty((n,), dtype=torch.bool, device=table.device)
    spill = cuda.spill_buffer("insert_bulk", table.device, table.shape[1],
                              slots, n, block, evict_rounds)
    args = (table.data_ptr(), table.shape[1], int(n_buckets),
            cuda.ptr(stash), slots, hi.data_ptr(), lo.data_ptr(),
            valid.data_ptr(), ok.data_ptr(), n, block, fp_bits, evict_rounds,
            cuda.ptr(spill))
    if plane is None:
        cuda.launch("insert_bulk", table.device, *args)
    else:
        cuda.launch("insert_bulk_tm", table.device, *args, plane.data_ptr())
    return ok


def _insert_plane(device) -> torch.Tensor:
    """The zeroed uint32 plane a telemetry launch adds its counts to."""
    return torch.zeros((KICK_BINS + 2,), dtype=torch.int32, device=device)


def insert_bulk(table: torch.Tensor, hi: torch.Tensor, lo: torch.Tensor, *,
                fp_bits: int, n_buckets: int | None = None,
                valid: torch.Tensor | None = None,
                evict_rounds: int = DEFAULT_EVICT_ROUNDS,
                stash: torch.Tensor | None = None,
                block: int = DEFAULT_BLOCK, schedule: bool = False):
    """Full bulk insert, updating ``table`` (and ``stash``) IN PLACE
    -> (table, ok bool[N]), or (table, stash, ok) with a stash.

    ``table``: int32[buffer_buckets, bucket_size]; ``n_buckets``: ACTIVE
    bucket count (host int).  N must be a multiple of ``min(block, N)``;
    ranks are taken within each logical block, so ``block`` is part of the
    result.  ``valid=False`` lanes never touch the table.
    ``evict_rounds=0`` is the optimistic-only insert (``insert_once``).
    ``schedule`` runs the conflict-wave pre-pass (``core.scheduling``, on
    home buckets from ``fingerprint_hash``) and scatters ``ok`` back.  CPU tensors take the plain version; CUDA tensors
    launch the kernel.
    """
    ok, _plane = _insert_bulk(table, hi, lo, fp_bits=fp_bits,
                              n_buckets=n_buckets, valid=valid,
                              evict_rounds=evict_rounds, stash=stash,
                              block=block, schedule=schedule, tm=False)
    return (table, ok) if stash is None else (table, stash, ok)


def insert_bulk_tm(table: torch.Tensor, hi: torch.Tensor, lo: torch.Tensor,
                   *, fp_bits: int, n_buckets: int | None = None,
                   valid: torch.Tensor | None = None,
                   evict_rounds: int = DEFAULT_EVICT_ROUNDS,
                   stash: torch.Tensor | None = None,
                   block: int = DEFAULT_BLOCK, schedule: bool = False):
    """``insert_bulk`` plus its counter plane -> (table, ok, plane) or
    (table, stash, ok, plane).  ``plane`` is int64[KICK_BINS + 2]: the
    kick-depth histogram of the valid lanes, then the lanes spilled to the
    stash, then the lanes rolled back (``telemetry.insert_plane``).  CPU
    tensors take the plain version with stats; CUDA tensors launch the
    kernel's telemetry instantiation, which counts while it walks."""
    ok, plane = _insert_bulk(table, hi, lo, fp_bits=fp_bits,
                             n_buckets=n_buckets, valid=valid,
                             evict_rounds=evict_rounds, stash=stash,
                             block=block, schedule=schedule, tm=True)
    return ((table, ok, plane) if stash is None
            else (table, stash, ok, plane))


def _insert_bulk(table, hi, lo, *, fp_bits, n_buckets, valid, evict_rounds,
                 stash, block, schedule, tm):
    n = hi.shape[0]
    block = min(block, n) if n else block
    if n and n % block:
        raise ValueError(f"{n=} not a multiple of {block=}")
    if n_buckets is None:
        n_buckets = table.shape[0]
    if valid is None:
        valid = torch.ones((n,), dtype=torch.bool, device=hi.device)
    plane = None
    if tm:
        plane = torch.zeros((KICK_BINS + 2,), dtype=torch.int64,
                            device=table.device)
    if n == 0:
        return torch.zeros((0,), dtype=torch.bool, device=table.device), plane
    # A single-block batch gains nothing from the pre-pass (the stable
    # permutation keeps same-bucket lane order, so ranks are unchanged).
    schedule = schedule and n > block
    if schedule:
        # The home buckets come from the fingerprint kernel.
        _fp, i1, _i2 = fingerprint_hash(hi, lo, fp_bits=fp_bits,
                                        n_buckets=n_buckets, block=block)
        perm, inv = dispatch_order_from_buckets(i1, valid)
        hi, lo, valid = hi[perm], lo[perm], valid[perm]
    kw = dict(fp_bits=fp_bits, n_buckets=n_buckets,
              evict_rounds=evict_rounds, stash=stash, block=block)
    if table.device.type == "cpu":
        ok = insert_bulk_plain(table, hi, lo, valid, want_stats=tm, **kw)
        if tm:
            ok, stats = ok
            plane = insert_plane(*stats, valid)
    elif tm:
        raw = _insert_plane(table.device)
        ok = _insert_cuda(table, hi, lo, valid, plane=raw, **kw)
        plane = raw.to(torch.int64)
    else:
        ok = _insert_cuda(table, hi, lo, valid, **kw)
    if schedule:
        ok = ok[inv]
    return ok, plane


def insert_once(table: torch.Tensor, hi: torch.Tensor, lo: torch.Tensor, *,
                fp_bits: int, n_buckets: int | None = None,
                valid: torch.Tensor | None = None,
                block: int = DEFAULT_BLOCK):
    """One optimistic insert round (no eviction) -> (table, placed)."""
    return insert_bulk(table, hi, lo, fp_bits=fp_bits, n_buckets=n_buckets,
                       valid=valid, evict_rounds=0, block=block)


# ------------------------------------------- selector-aware (adaptive) -----
#
# The four-plane insert (table, packed selectors, mirror khi/klo): the
# same block / round / rank schedule as above, with three differences.
# Placements and kicks write (fp0, selector 0, key).  Lanes carry the KEY,
# and a kicked victim's next bucket comes from its MIRROR key's fp0 (the
# stored fingerprint may be an adapted member).  The chain history keeps
# each kicked slot's original four-plane contents, and rollback restores
# them newest first; a failed lane owns its kicked slots (they stay
# dirty), so that is exact.  The plain version unpacks the selector plane
# once per call and packs it back at the end (pack and unpack are
# inverses).  The kernel (``csrc/insert_adaptive.cu``, staged like
# ``insert.cu``) stages only the rows' fingerprints in shared memory; it
# keeps the selector words and khi / klo in device memory, reads them from
# L2 for a kicked victim and sets the 2-bit selector fields with global
# atomics.  (``csrc/delete_adaptive.cu`` stages each row's selector word
# beside its fingerprints.)


def _place_round_adaptive(planes, target, active, fp32, khi32, klo32):
    """Adaptive placement round: (fp, sel 0, key) into the rank-th empty
    slot of each active lane's ``target`` bucket -> placed bool[N]."""
    table, sel_tbl, khi_t, klo_t = planes
    rank = rank_among_earlier(target, active)
    empty = table[target] == 0                            # [n, bucket_size]
    fits = active & (rank < empty.sum(dim=1))
    empty_pos = torch.cumsum(empty.to(torch.int64), dim=1) - 1
    slot = _first_true(empty & (empty_pos == rank[:, None]))
    t, s = target[fits], slot[fits]
    table[t, s] = fp32[fits]
    sel_tbl[t, s] = 0
    khi_t[t, s] = khi32[fits]
    klo_t[t, s] = klo32[fits]
    return fits


def _evict_rounds_adaptive(planes, stash, hi, lo, start_bucket, residue,
                           n_buckets, rounds: int, *, fp_bits: int,
                           want_stats: bool = False):
    """Bounded eviction rounds, stash spill and rollback over the four
    planes -> completed bool[N]; with ``want_stats`` also the per-lane
    (steps, spilled, failed), as ``_evict_rounds``."""
    table, sel_tbl, khi_t, klo_t = planes
    buf, bucket_size = table.shape
    n = hi.shape[0]
    dev = table.device
    dirty = torch.zeros((buf, bucket_size), dtype=torch.bool, device=dev)
    chi, clo = hi.clone(), lo.clone()            # carried key (int32 bits)
    bucket, active = start_bucket.clone(), residue.clone()
    steps = torch.zeros((n,), dtype=torch.int64, device=dev)
    hb = torch.zeros((n, rounds), dtype=torch.int64, device=dev)
    hs, hsel = torch.zeros_like(hb), torch.zeros_like(hb)
    hfp = torch.zeros((n, rounds), dtype=torch.int32, device=dev)
    hhi, hlo = torch.zeros_like(hfp), torch.zeros_like(hfp)
    t_iota = torch.arange(rounds, device=dev)
    slot_iota = torch.arange(bucket_size, device=dev)
    r = 0
    while r < rounds and bool(active.any()):
        cfp = hashing.to_i32(hashing.fingerprint(chi, clo, fp_bits))
        # phase A: the carried key into an empty slot of its bucket.
        placed = _place_round_adaptive(planes, bucket, active, cfp, chi, clo)
        active = active & ~placed
        # A lane that landed never rolls back: release its kicked slots.
        rel = placed[:, None] & (t_iota[None, :] < steps[:, None])
        dirty[hb[rel], hs[rel]] = False
        # phase B: one kick per bucket, earliest active lane wins.
        first = active & (rank_among_earlier(bucket, active) == 0)
        pos = (slot_iota[None, :] + (steps % bucket_size)[:, None]) \
            % bucket_size
        cand_free = ~torch.gather(dirty[bucket], 1, pos)
        kick = first & cand_free.any(dim=1)
        slot = torch.gather(pos, 1, _first_true(cand_free)[:, None])[:, 0]
        # The victim's original contents, all four planes.
        vfp, vsel = table[bucket, slot], sel_tbl[bucket, slot]
        vhi, vlo = khi_t[bucket, slot], klo_t[bucket, slot]
        kb, ks = bucket[kick], slot[kick]
        table[kb, ks] = cfp[kick]
        sel_tbl[kb, ks] = 0
        khi_t[kb, ks] = chi[kick]
        klo_t[kb, ks] = clo[kick]
        dirty[kb, ks] = True
        lanes = torch.nonzero(kick).flatten()
        col = steps[lanes]
        for plane, value in ((hb, kb), (hs, ks), (hfp, vfp[lanes]),
                             (hsel, vsel[lanes]), (hhi, vhi[lanes]),
                             (hlo, vlo[lanes])):
            plane[lanes, col] = value
        # Chase the victim to ITS alternate bucket: selector-0 geometry
        # from the mirror key.
        nxt = hashing.alt_index(bucket, hashing.fingerprint(vhi, vlo, fp_bits),
                                n_buckets)
        chi = torch.where(kick, vhi, chi)
        clo = torch.where(kick, vlo, clo)
        bucket = torch.where(kick, nxt, bucket)
        steps = steps + kick.to(torch.int64)
        r += 1
    spilled = torch.zeros_like(active)
    if stash is not None:
        # Spills park the carried key's fp0.
        cfp = hashing.fingerprint(chi, clo, fp_bits)
        spilled = stash_spill(stash, cfp, bucket, active)
        active = active & ~spilled
    failed = active
    if bool(failed.any()):
        for k in range(rounds):
            t = steps - 1 - k
            do = failed & (t >= 0)
            if not bool(do.any()):
                break
            tc = t.clamp(0, rounds - 1)[:, None]
            b = torch.gather(hb, 1, tc)[:, 0][do]
            s = torch.gather(hs, 1, tc)[:, 0][do]
            for plane, hist in ((table, hfp), (sel_tbl, hsel), (khi_t, hhi),
                                (klo_t, hlo)):
                plane[b, s] = torch.gather(hist, 1, tc)[:, 0][do]
    if want_stats:
        return residue & ~failed, (steps, spilled, failed)
    return residue & ~failed


def _insert_adaptive_block(planes, stash, hi, lo, valid, n_buckets, *,
                           fp_bits: int, evict_rounds: int,
                           want_stats: bool = False):
    """One logical block -> ok, or (ok, (steps, spilled, failed)), with
    ``_insert_block``'s accounting."""
    fp = hashing.fingerprint(hi, lo, fp_bits)
    i1 = hashing.index_hash(hi, lo, n_buckets)
    i2 = hashing.alt_index(i1, fp, n_buckets)
    fp32 = hashing.to_i32(fp)
    ok = _place_round_adaptive(planes, i1, valid, fp32, hi, lo)
    ok = ok | _place_round_adaptive(planes, i2, valid & ~ok, fp32, hi, lo)
    stats = _no_stats(hi.shape[0], hi.device)
    if evict_rounds > 0:
        # Chains start at the alternate bucket, like the static path.
        done = _evict_rounds_adaptive(planes, stash, hi, lo, i2,
                                      valid & ~ok, n_buckets, evict_rounds,
                                      fp_bits=fp_bits, want_stats=want_stats)
        if want_stats:
            done, stats = done
        ok = ok | done
    elif stash is not None:
        spilled = stash_spill(stash, fp, i2, valid & ~ok)
        ok = ok | spilled
        stats = (stats[0], spilled, stats[2])
    return (ok, stats) if want_stats else ok


def insert_bulk_adaptive_plain(table, sels, khi, klo, hi, lo, valid, *,
                               fp_bits: int, n_buckets: int,
                               evict_rounds: int, stash, block: int,
                               want_stats: bool = False):
    """Plain PyTorch version: logical blocks in order, all four planes
    (and the stash) updated IN PLACE -> ok; with ``want_stats``
    (ok, (steps, spilled, failed)) per lane."""
    cuda.PLAIN_CALLS["insert_bulk_adaptive"] += 1
    sel_tbl = sel_unpack(sels, table.shape[1])
    planes = (table, sel_tbl, khi, klo)
    ok = [_insert_adaptive_block(planes, stash, hi[s:s + block],
                                 lo[s:s + block], valid[s:s + block],
                                 n_buckets, fp_bits=fp_bits,
                                 evict_rounds=evict_rounds,
                                 want_stats=want_stats)
          for s in range(0, hi.shape[0], block)]
    sels.copy_(sel_pack(sel_tbl))
    return _cat_stats(ok) if want_stats else torch.cat(ok)


def _insert_adaptive_cuda(table, sels, khi, klo, hi, lo, valid, *, fp_bits,
                          n_buckets, evict_rounds, stash, block,
                          split_keys=cuda.SPLIT_KEYS, plane=None):
    name = "insert_bulk_adaptive"
    cuda.check_cuda(name, table=table, sels=sels, khi=khi, klo=klo, hi=hi,
                    lo=lo, valid=valid, stash=stash)
    cuda.check_dtype(name, torch.int32, table=table, sels=sels, khi=khi,
                     klo=klo, hi=hi, lo=lo, stash=stash)
    cuda.check_dtype(name, torch.bool, valid=valid)
    cuda.check_table(name, table, n_buckets, stash, sels=sels, khi=khi,
                     klo=klo)
    if table.numel() >= 2**32 - 1:
        raise ValueError(f"{name}: the kernel keeps a kicked slot's (bucket, "
                         f"slot) in 32 bits, so fewer than 2^32 - 1 slots; "
                         f"got {tuple(table.shape)}")
    n = hi.shape[0]
    slots = 0 if stash is None else stash.shape[1]
    ok = torch.empty((n,), dtype=torch.bool, device=table.device)
    # The dirty set and the kick history live in the per-lane region: in
    # shared memory on the main path (no buffer), else in this buffer,
    # which the call's launches share in turn.
    spill = cuda.spill_buffer(name, table.device, table.shape[1], slots,
                              min(n, split_keys), block, evict_rounds)
    # The telemetry launches of one call add their counts to one plane.
    for s, e in cuda.spans(n, block, split_keys):
        args = (table.data_ptr(), sels.data_ptr(), khi.data_ptr(),
                klo.data_ptr(), table.shape[1], int(n_buckets),
                cuda.ptr(stash), slots, hi[s:e].data_ptr(),
                lo[s:e].data_ptr(), valid[s:e].data_ptr(),
                ok[s:e].data_ptr(), e - s, block, fp_bits, evict_rounds,
                cuda.ptr(spill))
        if plane is None:
            cuda.launch(name, table.device, *args)
        else:
            cuda.launch(name + "_tm", table.device, *args,
                        plane.data_ptr())
    return ok


def insert_bulk_adaptive(table: torch.Tensor, sels: torch.Tensor,
                         khi: torch.Tensor, klo: torch.Tensor,
                         hi: torch.Tensor, lo: torch.Tensor, *, fp_bits: int,
                         n_buckets: int | None = None,
                         valid: torch.Tensor | None = None,
                         evict_rounds: int = DEFAULT_EVICT_ROUNDS,
                         stash: torch.Tensor | None = None,
                         block: int = DEFAULT_BLOCK, schedule: bool = False,
                         split_keys: int = cuda.SPLIT_KEYS):
    """Selector-aware bulk insert over the four adaptive planes, IN PLACE
    -> (table, sels, khi, klo, ok) or (table, sels, khi, klo, stash, ok).

    ``sels``: the packed selector plane int32[buffer, 1]; ``khi``/``klo``:
    mirror key planes of the table's shape.  Otherwise the contract of
    ``insert_bulk``.  CPU tensors take the plain version; CUDA tensors
    launch the kernel, as launches of at most ``split_keys`` keys at
    logical-block boundaries (the same result: the blocks run in order).
    """
    ok, _plane = _insert_adaptive(table, sels, khi, klo, hi, lo,
                                  fp_bits=fp_bits, n_buckets=n_buckets,
                                  valid=valid, evict_rounds=evict_rounds,
                                  stash=stash, block=block,
                                  schedule=schedule, split_keys=split_keys,
                                  tm=False)
    planes = (table, sels, khi, klo)
    return (*planes, ok) if stash is None else (*planes, stash, ok)


def insert_bulk_adaptive_tm(table: torch.Tensor, sels: torch.Tensor,
                            khi: torch.Tensor, klo: torch.Tensor,
                            hi: torch.Tensor, lo: torch.Tensor, *,
                            fp_bits: int, n_buckets: int | None = None,
                            valid: torch.Tensor | None = None,
                            evict_rounds: int = DEFAULT_EVICT_ROUNDS,
                            stash: torch.Tensor | None = None,
                            block: int = DEFAULT_BLOCK,
                            schedule: bool = False,
                            split_keys: int = cuda.SPLIT_KEYS):
    """``insert_bulk_adaptive`` plus its counter plane (``insert_bulk_tm``'s
    layout) -> (table, sels, khi, klo, ok, plane) or (..., stash, ok,
    plane).  On the card every launch of the call adds its counts to the
    one plane."""
    ok, plane = _insert_adaptive(table, sels, khi, klo, hi, lo,
                                 fp_bits=fp_bits, n_buckets=n_buckets,
                                 valid=valid, evict_rounds=evict_rounds,
                                 stash=stash, block=block, schedule=schedule,
                                 split_keys=split_keys, tm=True)
    planes = (table, sels, khi, klo)
    return ((*planes, ok, plane) if stash is None
            else (*planes, stash, ok, plane))


def _insert_adaptive(table, sels, khi, klo, hi, lo, *, fp_bits, n_buckets,
                     valid, evict_rounds, stash, block, schedule, split_keys,
                     tm):
    n = hi.shape[0]
    block = min(block, n) if n else block
    if n and n % block:
        raise ValueError(f"{n=} not a multiple of {block=}")
    if n_buckets is None:
        n_buckets = table.shape[0]
    if valid is None:
        valid = torch.ones((n,), dtype=torch.bool, device=hi.device)
    plane = None
    if tm:
        plane = torch.zeros((KICK_BINS + 2,), dtype=torch.int64,
                            device=table.device)
    if n == 0:
        return torch.zeros((0,), dtype=torch.bool, device=table.device), plane
    schedule = schedule and n > block
    if schedule:
        _fp, i1, _i2 = fingerprint_hash(hi, lo, fp_bits=fp_bits,
                                        n_buckets=n_buckets, block=block)
        perm, inv = dispatch_order_from_buckets(i1, valid)
        hi, lo, valid = hi[perm], lo[perm], valid[perm]
    kw = dict(fp_bits=fp_bits, n_buckets=n_buckets,
              evict_rounds=evict_rounds, stash=stash, block=block)
    if table.device.type == "cpu":
        ok = insert_bulk_adaptive_plain(table, sels, khi, klo, hi, lo, valid,
                                        want_stats=tm, **kw)
        if tm:
            ok, stats = ok
            plane = insert_plane(*stats, valid)
    elif tm:
        raw = _insert_plane(table.device)
        ok = _insert_adaptive_cuda(table, sels, khi, klo, hi, lo, valid,
                                   split_keys=split_keys, plane=raw, **kw)
        plane = raw.to(torch.int64)
    else:
        ok = _insert_adaptive_cuda(table, sels, khi, klo, hi, lo, valid,
                                   split_keys=split_keys, **kw)
    if schedule:
        ok = ok[inv]
    return ok, plane
