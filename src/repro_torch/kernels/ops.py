"""Public wrappers around the filter kernels: padding, block rule, copies.

Counterpart of ``repro.kernels.ops`` for the main path (``hash_keys``,
``probe_dispatch``, ``filter_lookup``, ``filter_insert``,
``filter_delete``), the streaming ring's fan-out (``filter_lookup_multi``,
``multi_prober``) and the adaptive filter (``adaptive_lookup``,
``adaptive_insert``, ``adaptive_delete``, ``adaptive_report``), their
telemetry twins (``*_tm``: the same results plus a
``kernels.telemetry.FilterTelemetry``), and the LM stack's attention
dispatcher (``attention``).  Every wrapper
goes to its kernel; a kernel module takes its plain version only for CPU
tensors, so there is no fallback arm here.

**Telemetry twins.**  The insert and lookup twins launch the kernels'
telemetry instantiations (``probe_tm``, ``insert_bulk_tm``, ...), which
count inside the kernel; their answers are the telemetry-off kernels'.
The delete and report twins run the same kernels as their off twins and
add one reduction each on the device, as the reference does.  No twin
syncs with the host.  Padding lanes are never counted: inserts and
deletes pad with ``valid=False``, lookups pass the caller's lane count.

**The parity block rule.**  Insert and delete rank lanes within a logical
block, so the block size is part of their result.  To leave the same
tables as the reference, the port picks the reference's block for the
same arguments: ``autotune_block`` below is the reference's pure function,
with its constants copied under ``PARITY_*`` names.  They model a TPU's
VMEM, not anything on the GPU; they are kept only so that both packages
agree on the block (for the OCF's 4096-key chunks that is 128, at every
table size).  A block tuned for the H100 would be a separate setting, held
against the port's own plain version at that block.
"""
from __future__ import annotations

import functools
from typing import Sequence

import torch

from repro_torch.kernels.delete import delete_bulk, delete_bulk_adaptive
from repro_torch.kernels.flash_attention import HEAD_DIMS, flash_attention
from repro_torch.kernels.fingerprint import (fingerprint_hash,
                                             fingerprint_hash_family)
from repro_torch.kernels.insert import (DEFAULT_EVICT_ROUNDS, insert_bulk,
                                        insert_bulk_adaptive,
                                        insert_bulk_adaptive_tm,
                                        insert_bulk_tm, insert_once)
from repro_torch.kernels.probe import (probe, probe_adaptive,
                                       probe_adaptive_tm, probe_multi,
                                       probe_tm)
from repro_torch.kernels.ref import blockwise_attention
from repro_torch.kernels.selector import (make_key_planes, make_sel_plane,
                                          report_adapt)
from repro_torch.kernels.stash import (DEFAULT_STASH_SLOTS, make_stash,
                                       stash_delete_ref, stash_occupancy)
from repro_torch.kernels.telemetry import (FilterTelemetry, empty_telemetry,
                                           from_counts, from_insert_plane)

# Parity constants: the reference's VMEM footprint model and candidates
# (``RANK_BYTES_PER_ELEM``, an int32 rank, keeps the reference's name).
PARITY_VMEM_TABLE_BUDGET = 12 * 2**20
RANK_BYTES_PER_ELEM = 4
PARITY_BLOCK_CANDIDATES = (128, 256, 512, 1024, 2048, 4096, 8192)


def kernel_vmem_bytes(op: str, *, table_bytes: int, block: int,
                      evict_rounds: int = 0, stash_slots: int = 0) -> int:
    """The reference's footprint model of one kernel program (parity
    only: ``autotune_block`` budgets with it)."""
    rank_bytes = RANK_BYTES_PER_ELEM * block * block
    stash_bytes = 8 * stash_slots + block * stash_slots if stash_slots else 0
    if op == "probe":
        return table_bytes + 16 * block + stash_bytes
    if op == "delete":
        return table_bytes + rank_bytes + 16 * block
    if op == "insert":
        return (2 * table_bytes + rank_bytes
                + 3 * 4 * block * max(evict_rounds, 1) + 16 * block
                + stash_bytes)
    raise ValueError(f"unknown filter kernel op {op!r}")


@functools.lru_cache(maxsize=256)
def autotune_block(op: str, *, table_bytes: int, evict_rounds: int = 0,
                   stash_slots: int = 0, n_keys: int | None = None) -> int:
    """The reference's logical block for these arguments (parity rule).

    probe takes the largest candidate within the parity budget; insert and
    delete the smallest, unless one budget-fitting block holds the whole
    batch.
    """
    fits = [b for b in PARITY_BLOCK_CANDIDATES
            if kernel_vmem_bytes(op, table_bytes=table_bytes, block=b,
                                 evict_rounds=evict_rounds,
                                 stash_slots=stash_slots)
            <= PARITY_VMEM_TABLE_BUDGET]
    if not fits:
        return PARITY_BLOCK_CANDIDATES[0]
    if op == "probe":
        return fits[-1]
    if n_keys is not None:
        whole = [b for b in fits if b >= n_keys]
        if whole:
            return whole[0]
    return fits[0]


def _pad_to(x: torch.Tensor, mult: int):
    """Zero-pad a 1-D tensor to a multiple of ``mult`` -> (padded, n)."""
    n = x.shape[0]
    pad = (-n) % mult
    if pad:
        x = torch.cat([x, torch.zeros((pad,), dtype=x.dtype,
                                      device=x.device)])
    return x, n


def _unpad(x: torch.Tensor, n: int):
    return x if x.shape[0] == n else x[:n]


def hash_keys(hi: torch.Tensor, lo: torch.Tensor, *, fp_bits: int,
              n_buckets: int):
    """(fp, i1, i2) via the fingerprint kernel, padded to its block."""
    if hi.shape[0] == 0:
        empty = torch.zeros((0,), dtype=torch.int32, device=hi.device)
        return empty, empty.clone(), empty.clone()
    block = min(autotune_block("probe", table_bytes=0), hi.shape[0])
    hi_p, n = _pad_to(hi, block)
    lo_p, _ = _pad_to(lo, block)
    fp, i1, i2 = fingerprint_hash(hi_p, lo_p, fp_bits=fp_bits,
                                  n_buckets=n_buckets, block=block)
    return _unpad(fp, n), _unpad(i1, n), _unpad(i2, n)


def probe_dispatch(table: torch.Tensor, hi: torch.Tensor, lo: torch.Tensor,
                   *, fp_bits: int, n_buckets: int | None = None,
                   stash: torch.Tensor | None = None) -> torch.Tensor:
    """Bulk membership through the probe kernel -> bool[N]."""
    return _lookup(probe, (table,), hi, lo, table.numel() * 4,
                   fp_bits=fp_bits, n_buckets=n_buckets, stash=stash)


def filter_lookup(table: torch.Tensor, hi: torch.Tensor, lo: torch.Tensor,
                  *, fp_bits: int, n_buckets: int | None = None,
                  stash: torch.Tensor | None = None) -> torch.Tensor:
    """Bulk membership through the probe kernel -> bool[N]; ``stash`` is
    checked in the same pass.  The reference's entry point with a
    non-kernel arm; the port has a kernel on every device, so this is
    ``probe_dispatch``."""
    return probe_dispatch(table, hi, lo, fp_bits=fp_bits,
                          n_buckets=n_buckets, stash=stash)


def probe_dispatch_tm(table: torch.Tensor, hi: torch.Tensor,
                      lo: torch.Tensor, *, fp_bits: int,
                      n_buckets: int | None = None,
                      stash: torch.Tensor | None = None):
    """Telemetry twin of ``probe_dispatch`` -> (hit[N], FilterTelemetry)
    with the probe-depth plane of the caller's N lanes."""
    return _lookup(probe_tm, (table,), hi, lo, table.numel() * 4,
                   fp_bits=fp_bits, n_buckets=n_buckets, stash=stash)


def _lookup(kernel, planes, hi, lo, table_bytes: int, *, stash, **kw):
    """Pad to the parity block and call a probe ``kernel`` over ``planes``
    -> bool[N], or (bool[N], FilterTelemetry) for a telemetry twin
    (``probe_tm``, ``probe_adaptive_tm``), which counts the N lanes."""
    tm = kernel in (probe_tm, probe_adaptive_tm)
    if hi.shape[0] == 0:
        hit = torch.zeros((0,), dtype=torch.bool, device=planes[0].device)
        return (hit, empty_telemetry(hit.device)) if tm else hit
    stash_slots = 0 if stash is None else stash.shape[1]
    block = min(autotune_block("probe", table_bytes=table_bytes,
                               stash_slots=stash_slots), hi.shape[0])
    hi_p, n = _pad_to(hi, block)
    lo_p, _ = _pad_to(lo, block)
    if not tm:
        return _unpad(kernel(*planes, hi_p, lo_p, stash=stash, block=block,
                             **kw), n)
    hit, plane = kernel(*planes, hi_p, lo_p, stash=stash, n_valid=n,
                        block=block, **kw)
    return _unpad(hit, n), from_counts(hit.device, probe_depth=plane)


def filter_lookup_multi(tables: torch.Tensor, hi: torch.Tensor,
                        lo: torch.Tensor, *, fp_bits: int,
                        n_buckets: int | None = None,
                        stashes: torch.Tensor | None = None,
                        gens: Sequence[int] | None = None) -> torch.Tensor:
    """Bulk membership across K generations -> bool[N]: one
    ``probe_multi`` launch (keys hashed once).  ``tables``:
    int32[K, buffer_buckets, bucket_size]; ``stashes``: optional
    int32[K, 2, S]; ``gens``: the generations to probe, default all K;
    ``n_buckets``: the shared ACTIVE bucket count."""
    return multi_prober(tables, fp_bits=fp_bits, n_buckets=n_buckets,
                        stashes=stashes, gens=gens)(hi, lo)


def multi_prober(tables: torch.Tensor, *, fp_bits: int,
                 n_buckets: int | None = None,
                 stashes: torch.Tensor | None = None,
                 gens: Sequence[int] | None = None):
    """Pin ``filter_lookup_multi``'s block for a fixed set of generations
    -> callable ``(hi, lo) -> bool[N]``.

    The block is the parity rule's for ONE generation's bytes; it only sets
    the padding (answers do not depend on it).  An empty batch gives
    ``bool[0]`` without a launch.
    """
    per_table_bytes = (tables.numel() // max(tables.shape[0], 1)) * 4
    stash_slots = 0 if stashes is None else stashes.shape[2]
    block = autotune_block("probe", table_bytes=per_table_bytes,
                           stash_slots=stash_slots)

    def kernel_probe(hi: torch.Tensor, lo: torch.Tensor) -> torch.Tensor:
        if hi.shape[0] == 0:
            return torch.zeros((0,), dtype=torch.bool, device=tables.device)
        b = min(block, hi.shape[0])
        hi_p, n = _pad_to(hi, b)
        lo_p, _ = _pad_to(lo, b)
        hit = probe_multi(tables, hi_p, lo_p, fp_bits=fp_bits,
                          n_buckets=n_buckets, stashes=stashes, gens=gens,
                          block=b)
        return _unpad(hit, n)

    return kernel_probe


def filter_insert(table: torch.Tensor, hi: torch.Tensor, lo: torch.Tensor,
                  *, fp_bits: int, n_buckets: int | None = None,
                  valid: torch.Tensor | None = None, evict_rounds: int = 0,
                  stash: torch.Tensor | None = None, schedule: bool = False,
                  donate: bool = False):
    """Bulk insert through the insert kernel -> (table, ok[N]), or
    (table, stash, ok[N]) with a stash.

    ``donate=True`` updates the caller's ``table`` (and ``stash``) in
    place; otherwise they are copied first and the copies are returned.
    """
    return _insert(insert_bulk, (table,), hi, lo, table.numel() * 4,
                   evict_rounds=evict_rounds, fp_bits=fp_bits,
                   n_buckets=n_buckets, valid=valid, stash=stash,
                   schedule=schedule, donate=donate)


def filter_insert_tm(table: torch.Tensor, hi: torch.Tensor, lo: torch.Tensor,
                     *, fp_bits: int, n_buckets: int | None = None,
                     valid: torch.Tensor | None = None,
                     evict_rounds: int = 0,
                     stash: torch.Tensor | None = None,
                     schedule: bool = False, donate: bool = False):
    """Telemetry twin of ``filter_insert`` -> its results plus a
    ``FilterTelemetry``: the kick-depth histogram of the valid lanes,
    spills, rollbacks and the stash's occupancy after the call."""
    return _insert(insert_bulk_tm, (table,), hi, lo, table.numel() * 4,
                   evict_rounds=evict_rounds, fp_bits=fp_bits,
                   n_buckets=n_buckets, valid=valid, stash=stash,
                   schedule=schedule, donate=donate)


def _insert(kernel, planes, hi, lo, table_bytes: int, *, evict_rounds,
            valid, stash, donate, **kw):
    """Copy (unless donated), pad to the parity block and call an insert
    ``kernel`` over ``planes`` -> (*planes, ok) or (*planes, stash, ok),
    plus a ``FilterTelemetry`` for a telemetry twin (``insert_bulk_tm``,
    ``insert_bulk_adaptive_tm``).  Padding lanes are ``valid=False``: they
    never touch the planes and are never counted."""
    tm = kernel in (insert_bulk_tm, insert_bulk_adaptive_tm)
    if not donate:
        planes = tuple(p.clone() for p in planes)
        stash = None if stash is None else stash.clone()
    kept = planes if stash is None else (*planes, stash)
    if hi.shape[0] == 0:
        ok = torch.zeros((0,), dtype=torch.bool, device=planes[0].device)
        return (*kept, ok, empty_telemetry(ok.device)) if tm else (*kept, ok)
    if valid is None:
        valid = torch.ones(hi.shape, dtype=torch.bool, device=hi.device)
    stash_slots = 0 if stash is None else stash.shape[1]
    # The adaptive parity rule counts twice the rounds (its chain history is
    # six arrays wide, not three).
    parity_rounds = evict_rounds * (1 if len(planes) == 1 else 2)
    block = min(autotune_block("insert", table_bytes=table_bytes,
                               evict_rounds=parity_rounds,
                               stash_slots=stash_slots,
                               n_keys=hi.shape[0]), hi.shape[0])
    hi_p, n = _pad_to(hi, block)
    lo_p, _ = _pad_to(lo, block)
    valid_p, _ = _pad_to(valid, block)   # pads False: never touches planes
    out = kernel(*planes, hi_p, lo_p, valid=valid_p,
                 evict_rounds=evict_rounds, stash=stash, block=block, **kw)
    if not tm:
        return (*kept, _unpad(out[-1], n))
    fill = None if stash is None else stash_occupancy(stash)
    return (*kept, _unpad(out[-2], n), from_insert_plane(out[-1], fill))


def filter_delete(table: torch.Tensor, hi: torch.Tensor, lo: torch.Tensor,
                  *, fp_bits: int, n_buckets: int | None = None,
                  valid: torch.Tensor | None = None,
                  stash: torch.Tensor | None = None, donate: bool = False):
    """Bulk delete through the delete kernel -> (table, ok[N]), or
    (table, stash, ok[N]) with an overflow ``stash``.

    With a stash, the lanes that missed the table then clear their stash
    entry (``stash_delete_ref``, the reference's order: table copies
    first), and ``ok`` reports either.  ``donate=True`` clears the
    caller's ``table`` (and ``stash``) in place; otherwise they are copied
    first.  Callers verify membership first (the OCF keystore does).
    """
    return _delete(delete_bulk, (table,), hi, lo, table.numel() * 4,
                   fp_bits=fp_bits, n_buckets=n_buckets, valid=valid,
                   stash=stash, donate=donate, tm=False)


def filter_delete_tm(table: torch.Tensor, hi: torch.Tensor,
                     lo: torch.Tensor, *, fp_bits: int,
                     n_buckets: int | None = None,
                     valid: torch.Tensor | None = None,
                     stash: torch.Tensor | None = None,
                     donate: bool = False):
    """Telemetry twin of ``filter_delete`` -> its results plus a
    ``FilterTelemetry`` of table- and stash-resolved deletes (and, with a
    stash, its occupancy after the call as the high-water mark): the same
    kernel and one reduction each, as in the reference."""
    return _delete(delete_bulk, (table,), hi, lo, table.numel() * 4,
                   fp_bits=fp_bits, n_buckets=n_buckets, valid=valid,
                   stash=stash, donate=donate, tm=True)


def _delete(kernel, planes, hi, lo, table_bytes: int, *, fp_bits, n_buckets,
            valid, stash, donate, tm):
    """Copy (unless donated), pad to the parity block and call a delete
    ``kernel`` over ``planes``; then the lanes that missed the table clear
    their stash entry -> (*planes, ok) or (*planes, stash, ok), plus a
    ``FilterTelemetry`` when ``tm``."""
    if not donate:
        planes = tuple(p.clone() for p in planes)
        stash = None if stash is None else stash.clone()
    kept = planes if stash is None else (*planes, stash)
    if hi.shape[0] == 0:
        ok = torch.zeros((0,), dtype=torch.bool, device=planes[0].device)
        return (*kept, ok, empty_telemetry(ok.device)) if tm else (*kept, ok)
    if valid is None:
        valid = torch.ones(hi.shape, dtype=torch.bool, device=hi.device)
    block = min(autotune_block("delete", table_bytes=table_bytes,
                               n_keys=hi.shape[0]), hi.shape[0])
    hi_p, n = _pad_to(hi, block)
    lo_p, _ = _pad_to(lo, block)
    valid_p, _ = _pad_to(valid, block)
    out = kernel(*planes, hi_p, lo_p, fp_bits=fp_bits, n_buckets=n_buckets,
                 valid=valid_p, block=block)
    ok = _unpad(out[-1], n)
    if stash is None:
        return (*kept, ok, _delete_tm_plane(ok)) if tm else (*kept, ok)
    nb = planes[0].shape[0] if n_buckets is None else n_buckets
    cleared = stash_delete_ref(stash, hi, lo, valid & ~ok, fp_bits=fp_bits,
                               n_buckets=nb)
    if not tm:
        return (*kept, ok | cleared)
    return (*kept, ok | cleared, _delete_tm_plane_stash(ok, cleared, stash))


def _delete_tm_plane(ok: torch.Tensor):
    """Counter plane of a stashless delete: one reduction on the device."""
    return from_counts(ok.device, table_deletes=ok.sum())


def _delete_tm_plane_stash(ok: torch.Tensor, cleared: torch.Tensor,
                           stash: torch.Tensor):
    """... and of a delete with a stash (``stash`` after the call)."""
    return from_counts(ok.device, table_deletes=ok.sum(),
                       stash_deletes=cleared.sum(),
                       stash_fill_hw=stash_occupancy(stash))


# ------------------------------------------------- adaptive dispatch -------
#
# The adaptive state is four planes (fingerprints, packed selector column,
# two mirror-key planes).  The parity block rule is fed the reference's
# adaptive arguments: the plane-scaled table bytes, and twice the eviction
# rounds for insert (its chain history is six arrays wide, not three).


def _adaptive_plane_bytes(table: torch.Tensor) -> int:
    """The reference's footprint of the four planes (parity only)."""
    return 3 * table.numel() * 4 + table.shape[0] * 4


def hash_family(hi: torch.Tensor, lo: torch.Tensor, *, fp_bits: int,
                n_buckets: int):
    """((f0..f3), i1, i2) via the family kernel, padded to its block."""
    n = hi.shape[0]
    if n == 0:
        empty = torch.zeros((0,), dtype=torch.int32, device=hi.device)
        return tuple(empty.clone() for _ in range(4)), empty, empty.clone()
    block = min(autotune_block("probe", table_bytes=0), n)
    hi_p, _ = _pad_to(hi, block)
    lo_p, _ = _pad_to(lo, block)
    fam, i1, i2 = fingerprint_hash_family(hi_p, lo_p, fp_bits=fp_bits,
                                          n_buckets=n_buckets, block=block)
    return (tuple(_unpad(f, n) for f in fam), _unpad(i1, n), _unpad(i2, n))


def adaptive_lookup(table: torch.Tensor, sels: torch.Tensor,
                    hi: torch.Tensor, lo: torch.Tensor, *, fp_bits: int,
                    n_buckets: int | None = None,
                    stash: torch.Tensor | None = None) -> torch.Tensor:
    """Selector-aware bulk membership through the kernel -> bool[N]."""
    return _lookup(probe_adaptive, (table, sels), hi, lo,
                   _adaptive_plane_bytes(table), fp_bits=fp_bits,
                   n_buckets=n_buckets, stash=stash)


def adaptive_insert(table: torch.Tensor, sels: torch.Tensor,
                    khi: torch.Tensor, klo: torch.Tensor, hi: torch.Tensor,
                    lo: torch.Tensor, *, fp_bits: int,
                    n_buckets: int | None = None,
                    valid: torch.Tensor | None = None, evict_rounds: int = 0,
                    stash: torch.Tensor | None = None,
                    schedule: bool = False, donate: bool = False):
    """Bulk insert over the adaptive planes through the kernel
    -> (table, sels, khi, klo, ok) or (..., stash, ok).

    ``donate=True`` updates the caller's planes (and stash) in place;
    otherwise they are copied first and the copies are returned.
    """
    return _insert(insert_bulk_adaptive, (table, sels, khi, klo), hi, lo,
                   _adaptive_plane_bytes(table), evict_rounds=evict_rounds,
                   fp_bits=fp_bits, n_buckets=n_buckets, valid=valid,
                   stash=stash, schedule=schedule, donate=donate)


def adaptive_delete(table: torch.Tensor, sels: torch.Tensor,
                    khi: torch.Tensor, klo: torch.Tensor, hi: torch.Tensor,
                    lo: torch.Tensor, *, fp_bits: int,
                    n_buckets: int | None = None,
                    valid: torch.Tensor | None = None,
                    stash: torch.Tensor | None = None, donate: bool = False):
    """Bulk delete over the adaptive planes through the kernel
    -> (table, sels, khi, klo, ok) or (..., stash, ok).

    Lanes that miss the table clear their selector-0 stash entry in the
    composed ``stash_delete_ref`` pass (unpadded lanes), as in the
    reference.
    """
    return _delete(delete_bulk_adaptive, (table, sels, khi, klo), hi, lo,
                   _adaptive_plane_bytes(table), fp_bits=fp_bits,
                   n_buckets=n_buckets, valid=valid, stash=stash,
                   donate=donate, tm=False)


def adaptive_report(table: torch.Tensor, sels: torch.Tensor,
                    khi: torch.Tensor, klo: torch.Tensor, hi: torch.Tensor,
                    lo: torch.Tensor, *, fp_bits: int, n_buckets: int,
                    valid: torch.Tensor | None = None, donate: bool = False):
    """Confirmed-false-positive feedback -> (table, sels, adapted[N],
    resident[N]).

    The reported keys are hashed once by the family kernel; the sequential
    repair (``kernels.selector.report_adapt``) is torch code.
    """
    if not donate:
        table, sels = table.clone(), sels.clone()
    if valid is None:
        valid = torch.ones(hi.shape, dtype=torch.bool, device=hi.device)
    family = hash_family(hi, lo, fp_bits=fp_bits, n_buckets=n_buckets)
    return report_adapt(table, sels, khi, klo, hi, lo, valid,
                        fp_bits=fp_bits, n_buckets=n_buckets, family=family)


def adaptive_lookup_tm(table: torch.Tensor, sels: torch.Tensor,
                       hi: torch.Tensor, lo: torch.Tensor, *, fp_bits: int,
                       n_buckets: int | None = None,
                       stash: torch.Tensor | None = None):
    """Telemetry twin of ``adaptive_lookup`` -> (hit[N], FilterTelemetry)
    with the probe-depth plane of the caller's N lanes."""
    return _lookup(probe_adaptive_tm, (table, sels), hi, lo,
                   _adaptive_plane_bytes(table), fp_bits=fp_bits,
                   n_buckets=n_buckets, stash=stash)


def adaptive_insert_tm(table: torch.Tensor, sels: torch.Tensor,
                       khi: torch.Tensor, klo: torch.Tensor, hi: torch.Tensor,
                       lo: torch.Tensor, *, fp_bits: int,
                       n_buckets: int | None = None,
                       valid: torch.Tensor | None = None,
                       evict_rounds: int = 0,
                       stash: torch.Tensor | None = None,
                       schedule: bool = False, donate: bool = False):
    """Telemetry twin of ``adaptive_insert`` -> its results plus a
    ``FilterTelemetry`` (``filter_insert_tm``'s counters; the launches of
    one call add to one plane)."""
    return _insert(insert_bulk_adaptive_tm, (table, sels, khi, klo), hi, lo,
                   _adaptive_plane_bytes(table), evict_rounds=evict_rounds,
                   fp_bits=fp_bits, n_buckets=n_buckets, valid=valid,
                   stash=stash, schedule=schedule, donate=donate)


def adaptive_delete_tm(table: torch.Tensor, sels: torch.Tensor,
                       khi: torch.Tensor, klo: torch.Tensor, hi: torch.Tensor,
                       lo: torch.Tensor, *, fp_bits: int,
                       n_buckets: int | None = None,
                       valid: torch.Tensor | None = None,
                       stash: torch.Tensor | None = None,
                       donate: bool = False):
    """Telemetry twin of ``adaptive_delete`` -> its results plus a
    ``FilterTelemetry`` of table- and stash-resolved deletes."""
    return _delete(delete_bulk_adaptive, (table, sels, khi, klo), hi, lo,
                   _adaptive_plane_bytes(table), fp_bits=fp_bits,
                   n_buckets=n_buckets, valid=valid, stash=stash,
                   donate=donate, tm=True)


def adaptive_report_tm(table: torch.Tensor, sels: torch.Tensor,
                       khi: torch.Tensor, klo: torch.Tensor, hi: torch.Tensor,
                       lo: torch.Tensor, *, fp_bits: int, n_buckets: int,
                       valid: torch.Tensor | None = None,
                       donate: bool = False):
    """Telemetry twin of ``adaptive_report``: ``selector_bumps`` counts the
    slots whose selector advanced in this pass."""
    table, sels, adapted, resident = adaptive_report(
        table, sels, khi, klo, hi, lo, fp_bits=fp_bits, n_buckets=n_buckets,
        valid=valid, donate=donate)
    tm = from_counts(table.device, selector_bumps=adapted.sum())
    return table, sels, adapted, resident, tm


def _per_shard(call, q, k, v):
    """Attention of DTensor q, k, v, one block a rank.  Attention is
    independent over batch and heads, so each rank runs ``call`` on its
    own rows: batch sharding stays; head sharding stays where both head
    counts divide by its shards (a rank's q heads then read its own kv
    heads); every other dim (sequence, head width) and a partial sum are
    made whole first.  The output has q's batch and head placements."""
    from torch.distributed.tensor import DTensor, Replicate, Shard
    mesh = q.device_mesh
    head_shards = 1
    for i, pl in enumerate(q.placements):
        if isinstance(pl, Shard) and pl.dim == 1:
            head_shards *= mesh.size(i)
    keep_heads = q.shape[1] % head_shards == 0 \
        and k.shape[1] % head_shards == 0
    placements = [pl if isinstance(pl, Shard) and (
        pl.dim == 0 or (pl.dim == 1 and keep_heads)) else Replicate()
        for pl in q.placements]
    local = [t.redistribute(mesh, placements).to_local() for t in (q, k, v)]
    out = call(*local)
    b, hq, sq = q.shape[:3]
    shape = (b, hq, sq, v.shape[-1])
    stride = (hq * sq * shape[3], sq * shape[3], shape[3], 1)
    return DTensor.from_local(out, mesh, placements, run_check=False,
                              shape=shape, stride=stride)


def attention(q, k, v, *, causal: bool = True, window: int | None = None,
              logit_softcap: float | None = None, scale: float | None = None,
              qpos_start=None, valid_len=None, key_positions=None):
    """Attention dispatcher, with the reference's rule: a cache-less call
    (no ``qpos_start``, ``valid_len`` or ``key_positions``) goes to the
    flash kernel (its plain version for CPU tensors); a call over a cache
    goes to ``blockwise_attention``.  The reference's off-TPU
    ``local_attention`` arm is not ported (the port has a kernel on every
    device it runs on).

    The flash kernel takes one head dim D in ``HEAD_DIMS`` for q, k and v.
    Where v's head dim differs from q's and k's, or theirs is not in
    ``HEAD_DIMS`` (MLA: 192 and 128), q, k and v are zero-padded to the
    smallest D in ``HEAD_DIMS`` that holds both, the scale fixed first
    (the given one, else Dk^-0.5), and the output cut back to v's width:
    zero columns add 0 to every dot product and give zero output
    columns, so this is the same function.

    DTensor q, k, v (the dry-run's) run one block a rank
    (``_per_shard``), each rank's call taking the route above."""
    if type(q).__name__ == "DTensor":
        return _per_shard(functools.partial(
            attention, causal=causal, window=window,
            logit_softcap=logit_softcap, scale=scale, qpos_start=qpos_start,
            valid_len=valid_len, key_positions=key_positions), q, k, v)
    if qpos_start is None and valid_len is None and key_positions is None:
        dk, dv = q.shape[-1], v.shape[-1]
        if dk == dv and dk in HEAD_DIMS:
            return flash_attention(q, k, v, causal=causal, window=window,
                                   logit_softcap=logit_softcap, scale=scale)
        d = next((h for h in HEAD_DIMS if h >= max(dk, dv)), None)
        if d is None:
            raise ValueError(f"attention: head dims {dk}, {dv} exceed the "
                             f"flash kernel's {HEAD_DIMS[-1]}")

        def pad(t):
            return torch.nn.functional.pad(t, (0, d - t.shape[-1]))
        out = flash_attention(pad(q), pad(k), pad(v), causal=causal,
                              window=window, logit_softcap=logit_softcap,
                              scale=scale if scale is not None else dk ** -0.5)
        return out[..., :dv]
    return blockwise_attention(q, k, v, causal=causal, window=window,
                               logit_softcap=logit_softcap, scale=scale,
                               qpos_start=qpos_start, valid_len=valid_len,
                               key_positions=key_positions)


# The reference's ``__all__`` but its TPU budget ``VMEM_TABLE_BUDGET``.
__all__ = ["hash_keys", "filter_lookup", "filter_lookup_multi",
           "filter_insert", "filter_delete", "attention", "fingerprint_hash",
           "fingerprint_hash_family", "probe", "probe_multi", "insert_once",
           "insert_bulk", "delete_bulk", "flash_attention",
           "kernel_vmem_bytes", "autotune_block", "DEFAULT_EVICT_ROUNDS",
           "DEFAULT_STASH_SLOTS", "make_stash", "stash_occupancy",
           "adaptive_lookup", "adaptive_insert", "adaptive_delete",
           "adaptive_report", "make_sel_plane", "make_key_planes",
           "FilterTelemetry", "empty_telemetry", "probe_dispatch_tm",
           "filter_insert_tm", "filter_delete_tm", "adaptive_lookup_tm",
           "adaptive_insert_tm", "adaptive_delete_tm", "adaptive_report_tm"]
