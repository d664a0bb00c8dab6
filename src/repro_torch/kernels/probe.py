"""Fused hash + bucket-probe bulk lookup, with an optional stash
(kernels 2, 5 and 7).

Counterpart of ``repro.kernels.probe.probe``, ``probe_multi`` and
``probe_adaptive``.  The CUDA kernels (``csrc/probe.cu``,
``csrc/probe_multi.cu``, ``csrc/probe_adaptive.cu``) run one thread per
key: hash, two 16-byte bucket loads, compare; ``probe`` scans its stash
staged in shared memory.  ``probe_multi`` issues the bucket loads of every
live generation (up to eight at once) before it compares any;
``probe_adaptive`` loads a row's packed selector word only where a slot
holds one of the key's family fingerprints, and the alternate row only
where the home row missed.  Both check
their stashes through a prefilter (``csrc/stash_prefilter.cuh``): each CTA
stages the live entries into a compact list and a bitmap of fingerprint
folds, and a key walks the list only where its bit is set.  The plain
versions below gather both buckets with tensor indexing.
"""
from __future__ import annotations

from typing import Sequence

import torch

from repro_torch.core import hashing
from repro_torch.kernels import cuda
from repro_torch.kernels.selector import fp_family, sel_unpack, select_fp
from repro_torch.kernels.stash import stash_match
from repro_torch.kernels.telemetry import PROBE_DEPTHS, probe_depth_counts

DEFAULT_BLOCK = 1024


def probe_plain(table: torch.Tensor, hi: torch.Tensor, lo: torch.Tensor, *,
                fp_bits: int, n_buckets: int | None = None,
                stash: torch.Tensor | None = None, want_stats: bool = False):
    """Plain PyTorch version -> bool[N]; with ``want_stats`` also the
    per-lane hits (h1, h2, hs) of the home bucket, the alternate bucket
    and the stash (all False without one)."""
    cuda.PLAIN_CALLS["probe"] += 1
    if n_buckets is None:
        n_buckets = table.shape[0]
    fp = hashing.fingerprint(hi, lo, fp_bits)
    i1 = hashing.index_hash(hi, lo, n_buckets)
    i2 = hashing.alt_index(i1, fp, n_buckets)
    fp32 = hashing.to_i32(fp)[:, None]
    h1 = (table[i1] == fp32).any(dim=1)
    h2 = (table[i2] == fp32).any(dim=1)
    hs = (torch.zeros_like(h1) if stash is None
          else stash_match(stash, fp, i1, i2))
    hit = h1 | h2 | hs
    return (hit, (h1, h2, hs)) if want_stats else hit


def probe(table: torch.Tensor, hi: torch.Tensor, lo: torch.Tensor, *,
          fp_bits: int, n_buckets: int | None = None,
          stash: torch.Tensor | None = None,
          block: int = DEFAULT_BLOCK) -> torch.Tensor:
    """Bulk membership test -> bool[N].

    ``table``: int32[buffer_buckets, bucket_size]; ``n_buckets`` is the
    ACTIVE bucket count (a host int, default the whole buffer); ``stash``:
    optional int32[2, S] checked in the same pass.  N must be a multiple
    of ``min(block, N)`` (the reference's tiling; answers do not depend on
    it).  CPU tensors take the plain version; CUDA tensors launch the
    kernel.
    """
    n = hi.shape[0]
    if n and n % min(block, n):
        raise ValueError(f"{n=} not a multiple of {block=}")
    if n_buckets is None:
        n_buckets = table.shape[0]
    if table.device.type == "cpu":
        return probe_plain(table, hi, lo, fp_bits=fp_bits,
                           n_buckets=n_buckets, stash=stash)
    cuda.check_cuda("probe", table=table, hi=hi, lo=lo, stash=stash)
    cuda.check_dtype("probe", torch.int32, table=table, hi=hi, lo=lo,
                     stash=stash)
    cuda.check_table("probe", table, n_buckets, stash)
    hit = torch.empty((n,), dtype=torch.bool, device=table.device)
    cuda.launch("probe", table.device, table.data_ptr(), table.shape[1],
                cuda.ptr(stash), 0 if stash is None else stash.shape[1],
                hi.data_ptr(), lo.data_ptr(), hit.data_ptr(), n, fp_bits,
                int(n_buckets))
    return hit


def probe_tm(table: torch.Tensor, hi: torch.Tensor, lo: torch.Tensor, *,
             fp_bits: int, n_buckets: int | None = None,
             stash: torch.Tensor | None = None, n_valid: int | None = None,
             block: int = DEFAULT_BLOCK):
    """``probe`` plus its probe-depth plane -> (bool[N], int64[4]).

    The plane counts the first ``n_valid`` lanes (default all N; padding
    lanes after them are answered but not counted) by their shallowest
    hit: home bucket, alternate bucket, stash, miss.  CPU tensors take the
    plain version with stats; CUDA tensors launch the kernel's telemetry
    instantiation, which counts per warp and adds one count a CTA.
    """
    n = hi.shape[0]
    if n and n % min(block, n):
        raise ValueError(f"{n=} not a multiple of {block=}")
    if n_buckets is None:
        n_buckets = table.shape[0]
    n_valid = n if n_valid is None else n_valid
    if table.device.type == "cpu":
        hit, (h1, h2, hs) = probe_plain(table, hi, lo, fp_bits=fp_bits,
                                        n_buckets=n_buckets, stash=stash,
                                        want_stats=True)
        valid = torch.arange(n, device=hi.device) < n_valid
        return hit, probe_depth_counts(h1, h2, hs, valid)
    cuda.check_cuda("probe_tm", table=table, hi=hi, lo=lo, stash=stash)
    cuda.check_dtype("probe_tm", torch.int32, table=table, hi=hi, lo=lo,
                     stash=stash)
    cuda.check_table("probe_tm", table, n_buckets, stash)
    hit = torch.empty((n,), dtype=torch.bool, device=table.device)
    plane = torch.zeros((PROBE_DEPTHS,), dtype=torch.int32,
                        device=table.device)
    cuda.launch("probe_tm", table.device, table.data_ptr(), table.shape[1],
                cuda.ptr(stash), 0 if stash is None else stash.shape[1],
                hi.data_ptr(), lo.data_ptr(), hit.data_ptr(), n, fp_bits,
                int(n_buckets), plane.data_ptr(), n_valid)
    return hit, plane.to(torch.int64)


def probe_multi_plain(tables: torch.Tensor, hi: torch.Tensor,
                      lo: torch.Tensor, *, fp_bits: int,
                      n_buckets: int | None = None,
                      stashes: torch.Tensor | None = None,
                      gens: Sequence[int] | None = None) -> torch.Tensor:
    """Plain PyTorch version -> bool[N]: hash once, OR the two-bucket
    compare over the tables ``gens`` names (default all K) and the stash
    match over their stashes."""
    cuda.PLAIN_CALLS["probe_multi"] += 1
    if n_buckets is None:
        n_buckets = tables.shape[1]
    fp = hashing.fingerprint(hi, lo, fp_bits)
    i1 = hashing.index_hash(hi, lo, n_buckets)
    i2 = hashing.alt_index(i1, fp, n_buckets)
    fp32 = hashing.to_i32(fp)[:, None]
    hit = torch.zeros(hi.shape, dtype=torch.bool, device=hi.device)
    for g in range(tables.shape[0]) if gens is None else gens:
        hit |= ((tables[g][i1] == fp32).any(dim=1)
                | (tables[g][i2] == fp32).any(dim=1))
        if stashes is not None:
            hit |= stash_match(stashes[g], fp, i1, i2)
    return hit


def probe_multi(tables: torch.Tensor, hi: torch.Tensor, lo: torch.Tensor, *,
                fp_bits: int, n_buckets: int | None = None,
                stashes: torch.Tensor | None = None,
                gens: Sequence[int] | None = None,
                block: int = DEFAULT_BLOCK) -> torch.Tensor:
    """Membership across K generations -> bool[N], keys hashed once.

    ``tables``: int32[K, buffer_buckets, bucket_size], the generations'
    tables; ``stashes``: optional int32[K, 2, S], checked in the same
    pass; ``gens``: the indices into K of the generations to probe (the
    generation ring's live pool slots), default all K; ``n_buckets``: the
    generations' shared ACTIVE bucket count (a host int, default the whole
    buffer).  N must be a multiple of ``min(block, N)``.  CPU tensors take
    the plain version; CUDA tensors launch the kernel once per 64 pool
    slots that hold a generation to probe (once for K <= 64).
    """
    n = hi.shape[0]
    if n and n % min(block, n):
        raise ValueError(f"{n=} not a multiple of {block=}")
    if n_buckets is None:
        n_buckets = tables.shape[1]
    if tables.device.type == "cpu":
        return probe_multi_plain(tables, hi, lo, fp_bits=fp_bits,
                                 n_buckets=n_buckets, stashes=stashes,
                                 gens=gens)
    return _probe_multi_cuda(tables, hi, lo, fp_bits=fp_bits,
                             n_buckets=n_buckets, stashes=stashes, gens=gens)


def _probe_multi_cuda(tables, hi, lo, *, fp_bits, n_buckets, stashes,
                      gens=None):
    name = "probe_multi"
    cuda.check_cuda(name, tables=tables, hi=hi, lo=lo, stashes=stashes)
    cuda.check_dtype(name, torch.int32, tables=tables, hi=hi, lo=lo,
                     stashes=stashes)
    if tables.dim() != 3 or tables.shape[0] < 1:
        raise ValueError(f"{name}: tables must be [K >= 1, buffer, "
                         f"bucket_size], got {tuple(tables.shape)}")
    if stashes is not None and (stashes.dim() != 3
                                or stashes.shape[0] != tables.shape[0]):
        raise ValueError(f"{name}: stashes must be [K, 2, slots] with the "
                         f"tables' K, got {tuple(stashes.shape)}")
    cuda.check_table(name, tables[0], n_buckets,
                     None if stashes is None else stashes[0])
    k, buf, bucket_size = tables.shape
    if gens is None:
        gens = range(k)
    elif any(not 0 <= g < k for g in gens):
        raise ValueError(f"{name}: gens {list(gens)} must index the "
                         f"{k} tables")
    mask = sum(1 << g for g in set(gens))
    slots = 0 if stashes is None else stashes.shape[2]
    n = hi.shape[0]
    hit = torch.empty((n,), dtype=torch.bool, device=tables.device)
    # The kernel's live mask is one 64-bit word: 64 pool slots a launch.
    for c0 in range(0, k, 64):
        word = (mask >> c0) & ((1 << 64) - 1)
        if c0 and not word:
            continue
        cuda.launch(name, tables.device, tables[c0].data_ptr(),
                    min(64, k - c0), word, buf, bucket_size,
                    None if stashes is None else stashes[c0].data_ptr(),
                    slots, hi.data_ptr(), lo.data_ptr(), hit.data_ptr(), n,
                    fp_bits, int(n_buckets), int(c0 > 0))
    return hit


def probe_adaptive_plain(table: torch.Tensor, sels: torch.Tensor,
                         hi: torch.Tensor, lo: torch.Tensor, *, fp_bits: int,
                         n_buckets: int | None = None,
                         stash: torch.Tensor | None = None,
                         want_stats: bool = False):
    """Plain PyTorch version -> bool[N]; with ``want_stats`` also the
    per-lane hits (h1, h2, hs), as ``probe_plain``."""
    cuda.PLAIN_CALLS["probe_adaptive"] += 1
    if n_buckets is None:
        n_buckets = table.shape[0]
    bucket_size = table.shape[1]
    fam = fp_family(hi, lo, fp_bits)
    i1 = hashing.index_hash(hi, lo, n_buckets)
    i2 = hashing.alt_index(i1, fam[0], n_buckets)
    h1, h2 = (
        (table[b] == hashing.to_i32(
            select_fp(fam, sel_unpack(sels[b], bucket_size)))).any(dim=1)
        for b in (i1, i2))
    hs = (torch.zeros_like(h1) if stash is None
          else stash_match(stash, fam[0], i1, i2))
    hit = h1 | h2 | hs
    return (hit, (h1, h2, hs)) if want_stats else hit


def probe_adaptive(table: torch.Tensor, sels: torch.Tensor, hi: torch.Tensor,
                   lo: torch.Tensor, *, fp_bits: int,
                   n_buckets: int | None = None,
                   stash: torch.Tensor | None = None,
                   block: int = DEFAULT_BLOCK) -> torch.Tensor:
    """Selector-aware bulk membership -> bool[N].

    A slot hits when it stores the key's family fingerprint under the
    slot's own selector (``sels``: the packed plane int32[buffer, 1]);
    stash entries are selector-0.  With an all-zero selector plane this is
    ``probe``.  Same contract as ``probe`` otherwise.
    """
    n = hi.shape[0]
    if n and n % min(block, n):
        raise ValueError(f"{n=} not a multiple of {block=}")
    if n_buckets is None:
        n_buckets = table.shape[0]
    if table.device.type == "cpu":
        return probe_adaptive_plain(table, sels, hi, lo, fp_bits=fp_bits,
                                    n_buckets=n_buckets, stash=stash)
    return _probe_adaptive_cuda(table, sels, hi, lo, fp_bits=fp_bits,
                                n_buckets=n_buckets, stash=stash)


def _probe_adaptive_cuda(table, sels, hi, lo, *, fp_bits, n_buckets, stash):
    name = "probe_adaptive"
    cuda.check_cuda(name, table=table, sels=sels, hi=hi, lo=lo, stash=stash)
    cuda.check_dtype(name, torch.int32, table=table, sels=sels, hi=hi, lo=lo,
                     stash=stash)
    cuda.check_table(name, table, n_buckets, stash, sels=sels)
    n = hi.shape[0]
    hit = torch.empty((n,), dtype=torch.bool, device=table.device)
    cuda.launch(name, table.device, table.data_ptr(), sels.data_ptr(),
                table.shape[1],
                cuda.ptr(stash), 0 if stash is None else stash.shape[1],
                hi.data_ptr(), lo.data_ptr(), hit.data_ptr(), n, fp_bits,
                int(n_buckets))
    return hit


def probe_adaptive_tm(table: torch.Tensor, sels: torch.Tensor,
                      hi: torch.Tensor, lo: torch.Tensor, *, fp_bits: int,
                      n_buckets: int | None = None,
                      stash: torch.Tensor | None = None,
                      n_valid: int | None = None,
                      block: int = DEFAULT_BLOCK):
    """``probe_adaptive`` plus its probe-depth plane -> (bool[N],
    int64[4]), with ``probe_tm``'s contract.  On the card the kernel's
    telemetry instantiation counts at the stage that answered: home row,
    alternate row, stash prefilter."""
    n = hi.shape[0]
    if n and n % min(block, n):
        raise ValueError(f"{n=} not a multiple of {block=}")
    if n_buckets is None:
        n_buckets = table.shape[0]
    n_valid = n if n_valid is None else n_valid
    if table.device.type == "cpu":
        hit, (h1, h2, hs) = probe_adaptive_plain(
            table, sels, hi, lo, fp_bits=fp_bits, n_buckets=n_buckets,
            stash=stash, want_stats=True)
        valid = torch.arange(n, device=hi.device) < n_valid
        return hit, probe_depth_counts(h1, h2, hs, valid)
    name = "probe_adaptive_tm"
    cuda.check_cuda(name, table=table, sels=sels, hi=hi, lo=lo, stash=stash)
    cuda.check_dtype(name, torch.int32, table=table, sels=sels, hi=hi, lo=lo,
                     stash=stash)
    cuda.check_table(name, table, n_buckets, stash, sels=sels)
    hit = torch.empty((n,), dtype=torch.bool, device=table.device)
    plane = torch.zeros((PROBE_DEPTHS,), dtype=torch.int32,
                        device=table.device)
    cuda.launch(name, table.device, table.data_ptr(), sels.data_ptr(),
                table.shape[1],
                cuda.ptr(stash), 0 if stash is None else stash.shape[1],
                hi.data_ptr(), lo.data_ptr(), hit.data_ptr(), n, fp_bits,
                int(n_buckets), plane.data_ptr(), n_valid)
    return hit, plane.to(torch.int64)
