"""Public wrappers around the filter kernels: padding, block rule, copies.

Counterpart of ``repro.kernels.ops`` for the main path (``hash_keys``,
``probe_dispatch``, ``filter_insert``, ``filter_delete``).  Every wrapper
goes to its kernel; a kernel module takes its plain version only for CPU
tensors, so there is no fallback arm here.

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

import torch

from repro_torch.kernels.delete import delete_bulk
from repro_torch.kernels.fingerprint import fingerprint_hash
from repro_torch.kernels.insert import insert_bulk
from repro_torch.kernels.probe import probe

# Parity constants: the reference's VMEM footprint model and candidates.
PARITY_VMEM_TABLE_BUDGET = 12 * 2**20
PARITY_RANK_BYTES_PER_ELEM = 4
PARITY_BLOCK_CANDIDATES = (128, 256, 512, 1024, 2048, 4096, 8192)


def kernel_vmem_bytes(op: str, *, table_bytes: int, block: int,
                      evict_rounds: int = 0, stash_slots: int = 0) -> int:
    """The reference's footprint model of one kernel program (parity
    only: ``autotune_block`` budgets with it)."""
    rank_bytes = PARITY_RANK_BYTES_PER_ELEM * block * block
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
    if hi.shape[0] == 0:
        return torch.zeros((0,), dtype=torch.bool, device=table.device)
    stash_slots = 0 if stash is None else stash.shape[1]
    block = min(autotune_block("probe", table_bytes=table.numel() * 4,
                               stash_slots=stash_slots), hi.shape[0])
    hi_p, n = _pad_to(hi, block)
    lo_p, _ = _pad_to(lo, block)
    hit = probe(table, hi_p, lo_p, fp_bits=fp_bits, n_buckets=n_buckets,
                stash=stash, block=block)
    return _unpad(hit, n)


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
    if not donate:
        table = table.clone()
        stash = None if stash is None else stash.clone()
    if hi.shape[0] == 0:
        ok = torch.zeros((0,), dtype=torch.bool, device=table.device)
        return (table, ok) if stash is None else (table, stash, ok)
    if valid is None:
        valid = torch.ones(hi.shape, dtype=torch.bool, device=hi.device)
    stash_slots = 0 if stash is None else stash.shape[1]
    block = min(autotune_block("insert", table_bytes=table.numel() * 4,
                               evict_rounds=evict_rounds,
                               stash_slots=stash_slots,
                               n_keys=hi.shape[0]), hi.shape[0])
    hi_p, n = _pad_to(hi, block)
    lo_p, _ = _pad_to(lo, block)
    valid_p, _ = _pad_to(valid, block)   # pads False: never touches the table
    out = insert_bulk(table, hi_p, lo_p, fp_bits=fp_bits,
                      n_buckets=n_buckets, valid=valid_p,
                      evict_rounds=evict_rounds, stash=stash, block=block,
                      schedule=schedule)
    return (*out[:-1], _unpad(out[-1], n))


def filter_delete(table: torch.Tensor, hi: torch.Tensor, lo: torch.Tensor,
                  *, fp_bits: int, n_buckets: int | None = None,
                  valid: torch.Tensor | None = None, donate: bool = False):
    """Bulk delete through the delete kernel -> (table, ok[N]).

    ``donate=True`` clears the caller's ``table`` in place; otherwise it is
    copied first.  Callers verify membership first (the OCF keystore does).
    """
    if not donate:
        table = table.clone()
    if hi.shape[0] == 0:
        return table, torch.zeros((0,), dtype=torch.bool, device=table.device)
    if valid is None:
        valid = torch.ones(hi.shape, dtype=torch.bool, device=hi.device)
    block = min(autotune_block("delete", table_bytes=table.numel() * 4,
                               n_keys=hi.shape[0]), hi.shape[0])
    hi_p, n = _pad_to(hi, block)
    lo_p, _ = _pad_to(lo, block)
    valid_p, _ = _pad_to(valid, block)
    table, ok = delete_bulk(table, hi_p, lo_p, fp_bits=fp_bits,
                            n_buckets=n_buckets, valid=valid_p, block=block)
    return table, _unpad(ok, n)
