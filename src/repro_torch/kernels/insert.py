"""Fused hash + bulk insert with bounded eviction rounds (kernel 3).

Counterpart of ``repro.kernels.insert.insert_bulk`` / ``insert_once``.
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
in order.  The plain version below follows the same block / round / rank
schedule in int64-masked tensor ops and keeps the reference's table-shaped
dirty mask.  Both update ``table`` (and ``stash``) IN PLACE.
"""
from __future__ import annotations

import torch

from repro_torch.core import hashing
from repro_torch.core.scheduling import dispatch_order_from_buckets
from repro_torch.kernels import cuda
from repro_torch.kernels.fingerprint import fingerprint_hash
from repro_torch.kernels.rank import rank_among_earlier
from repro_torch.kernels.stash import stash_spill

DEFAULT_BLOCK = 1024
# Bounded eviction budget: 32 rounds drain random batches at the OCF's
# o_max = 0.85 operating load; the loop exits as soon as every lane lands.
DEFAULT_EVICT_ROUNDS = 32
# One zeroed dirty byte array per (device, stream), grown with the table.
# The kernel leaves it all-zero at exit, so it is cleared once, when made.
_DIRTY: dict = {}


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
                  rounds: int):
    """Bounded eviction rounds, stash spill and rollback for the residue
    -> completed bool[N]."""
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
    if stash is not None:
        active = active & ~stash_spill(stash, carried, bucket, active)
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
    return residue & ~failed


def _insert_block(table, stash, hi, lo, valid, n_buckets, *, fp_bits: int,
                  evict_rounds: int):
    fp = hashing.fingerprint(hi, lo, fp_bits)
    i1 = hashing.index_hash(hi, lo, n_buckets)
    i2 = hashing.alt_index(i1, fp, n_buckets)
    fp32 = hashing.to_i32(fp)
    ok = _place_round(table, i1, valid, fp32)
    ok = ok | _place_round(table, i2, valid & ~ok, fp32)
    if evict_rounds > 0:
        # Chains start at the alternate bucket, like the sequential path.
        ok = ok | _evict_rounds(table, stash, fp, i2, valid & ~ok, n_buckets,
                                evict_rounds)
    elif stash is not None:
        ok = ok | stash_spill(stash, fp, i2, valid & ~ok)
    return ok


def insert_bulk_plain(table: torch.Tensor, hi: torch.Tensor,
                      lo: torch.Tensor, valid: torch.Tensor, *, fp_bits: int,
                      n_buckets: int, evict_rounds: int,
                      stash: torch.Tensor | None, block: int) -> torch.Tensor:
    """Plain PyTorch version: logical blocks in order, IN PLACE -> ok."""
    cuda.PLAIN_CALLS["insert_bulk"] += 1
    ok = [_insert_block(table, stash, hi[s:s + block], lo[s:s + block],
                        valid[s:s + block], n_buckets, fp_bits=fp_bits,
                        evict_rounds=evict_rounds)
          for s in range(0, hi.shape[0], block)]
    return torch.cat(ok)


def _dirty_mask(table: torch.Tensor) -> torch.Tensor:
    key = (table.device, torch.cuda.current_stream(table.device).cuda_stream)
    dirty = _DIRTY.get(key)
    if dirty is None or dirty.numel() < table.numel():
        dirty = torch.zeros((table.numel(),), dtype=torch.uint8,
                            device=table.device)
        _DIRTY[key] = dirty
    return dirty


def _insert_cuda(table, hi, lo, valid, *, fp_bits, n_buckets, evict_rounds,
                 stash, block):
    cuda.check_cuda("insert_bulk", table=table, hi=hi, lo=lo, valid=valid,
                    stash=stash)
    cuda.check_dtype("insert_bulk", torch.int32, table=table, hi=hi, lo=lo,
                     stash=stash)
    cuda.check_dtype("insert_bulk", torch.bool, valid=valid)
    cuda.check_table("insert_bulk", table, n_buckets, stash)
    n = hi.shape[0]
    dev = table.device
    ok = torch.empty((n,), dtype=torch.bool, device=dev)
    lane_u32 = torch.empty((9, block), dtype=torch.int32, device=dev)
    lane_u8 = torch.empty((5, block), dtype=torch.uint8, device=dev)
    hist = torch.empty((3, block * max(evict_rounds, 1)), dtype=torch.int32,
                       device=dev)
    dirty = _dirty_mask(table)
    cuda.launch("insert_bulk", table.data_ptr(), table.shape[1],
                int(n_buckets), cuda.ptr(stash),
                0 if stash is None else stash.shape[1], hi.data_ptr(),
                lo.data_ptr(), valid.data_ptr(), ok.data_ptr(), n, block,
                fp_bits, evict_rounds, lane_u32.data_ptr(),
                lane_u8.data_ptr(), hist.data_ptr(), dirty.data_ptr())
    return ok


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
    n = hi.shape[0]
    block = min(block, n) if n else block
    if n and n % block:
        raise ValueError(f"{n=} not a multiple of {block=}")
    if n_buckets is None:
        n_buckets = table.shape[0]
    if valid is None:
        valid = torch.ones((n,), dtype=torch.bool, device=hi.device)
    if n == 0:
        ok = torch.zeros((0,), dtype=torch.bool, device=table.device)
        return (table, ok) if stash is None else (table, stash, ok)
    # A single-block batch gains nothing from the pre-pass (the stable
    # permutation keeps same-bucket lane order, so ranks are unchanged).
    schedule = schedule and n > block
    if schedule:
        # The home buckets come from the fingerprint kernel.
        _fp, i1, _i2 = fingerprint_hash(hi, lo, fp_bits=fp_bits,
                                        n_buckets=n_buckets, block=block)
        perm, inv = dispatch_order_from_buckets(i1, valid)
        hi, lo, valid = hi[perm], lo[perm], valid[perm]
    run = insert_bulk_plain if table.device.type == "cpu" else _insert_cuda
    ok = run(table, hi, lo, valid, fp_bits=fp_bits, n_buckets=n_buckets,
             evict_rounds=evict_rounds, stash=stash, block=block)
    if schedule:
        ok = ok[inv]
    return (table, ok) if stash is None else (table, stash, ok)


def insert_once(table: torch.Tensor, hi: torch.Tensor, lo: torch.Tensor, *,
                fp_bits: int, n_buckets: int | None = None,
                valid: torch.Tensor | None = None,
                block: int = DEFAULT_BLOCK):
    """One optimistic insert round (no eviction) -> (table, placed)."""
    return insert_bulk(table, hi, lo, fp_bits=fp_bits, n_buckets=n_buckets,
                       valid=valid, evict_rounds=0, block=block)
