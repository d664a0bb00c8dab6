"""Fused hash + bucket-probe bulk lookup, with an optional stash
(kernels 2, 5 and 7).

Counterpart of ``repro.kernels.probe.probe``, ``probe_multi`` and
``probe_adaptive``.  The CUDA kernels (``csrc/probe.cu``,
``csrc/probe_multi.cu``, ``csrc/probe_adaptive.cu``) run one thread per
key: hash, two 16-byte bucket loads (per generation for ``probe_multi``;
and, adaptive, the two packed selector words), compare; with a stash, a
scan of the stash staged in shared memory.  The plain versions below
gather both buckets with tensor indexing.
"""
from __future__ import annotations

from typing import Sequence

import torch

from repro_torch.core import hashing
from repro_torch.kernels import cuda
from repro_torch.kernels.selector import fp_family, sel_unpack, select_fp
from repro_torch.kernels.stash import stash_match

DEFAULT_BLOCK = 1024


def probe_plain(table: torch.Tensor, hi: torch.Tensor, lo: torch.Tensor, *,
                fp_bits: int, n_buckets: int | None = None,
                stash: torch.Tensor | None = None) -> torch.Tensor:
    """Plain PyTorch version -> bool[N]."""
    cuda.PLAIN_CALLS["probe"] += 1
    if n_buckets is None:
        n_buckets = table.shape[0]
    fp = hashing.fingerprint(hi, lo, fp_bits)
    i1 = hashing.index_hash(hi, lo, n_buckets)
    i2 = hashing.alt_index(i1, fp, n_buckets)
    fp32 = hashing.to_i32(fp)[:, None]
    hit = (table[i1] == fp32).any(dim=1) | (table[i2] == fp32).any(dim=1)
    if stash is not None:
        hit = hit | stash_match(stash, fp, i1, i2)
    return hit


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
    cuda.launch("probe", table.data_ptr(), table.shape[1], cuda.ptr(stash),
                0 if stash is None else stash.shape[1], hi.data_ptr(),
                lo.data_ptr(), hit.data_ptr(), n, fp_bits, int(n_buckets))
    return hit


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
    the plain version; CUDA tensors launch the kernel, which takes at most
    64 generations.
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
    if tables.dim() != 3 or not 1 <= tables.shape[0] <= 64:
        raise ValueError(f"{name}: tables must be [1 <= K <= 64, buffer, "
                         f"bucket_size], got {tuple(tables.shape)}")
    if stashes is not None and (stashes.dim() != 3
                                or stashes.shape[0] != tables.shape[0]):
        raise ValueError(f"{name}: stashes must be [K, 2, slots] with the "
                         f"tables' K, got {tuple(stashes.shape)}")
    cuda.check_table(name, tables[0], n_buckets,
                     None if stashes is None else stashes[0])
    k, buf, bucket_size = tables.shape
    mask = (1 << k) - 1
    if gens is not None:
        if any(not 0 <= g < k for g in gens):
            raise ValueError(f"{name}: gens {list(gens)} must index the "
                             f"{k} tables")
        mask = sum(1 << g for g in set(gens))
    n = hi.shape[0]
    hit = torch.empty((n,), dtype=torch.bool, device=tables.device)
    cuda.launch(name, tables.data_ptr(), k, mask, buf, bucket_size,
                cuda.ptr(stashes), 0 if stashes is None else stashes.shape[2],
                hi.data_ptr(), lo.data_ptr(), hit.data_ptr(), n, fp_bits,
                int(n_buckets))
    return hit


def probe_adaptive_plain(table: torch.Tensor, sels: torch.Tensor,
                         hi: torch.Tensor, lo: torch.Tensor, *, fp_bits: int,
                         n_buckets: int | None = None,
                         stash: torch.Tensor | None = None) -> torch.Tensor:
    """Plain PyTorch version -> bool[N]."""
    cuda.PLAIN_CALLS["probe_adaptive"] += 1
    if n_buckets is None:
        n_buckets = table.shape[0]
    bucket_size = table.shape[1]
    fam = fp_family(hi, lo, fp_bits)
    i1 = hashing.index_hash(hi, lo, n_buckets)
    i2 = hashing.alt_index(i1, fam[0], n_buckets)
    hit = torch.zeros(hi.shape, dtype=torch.bool, device=hi.device)
    for b in (i1, i2):
        exp = select_fp(fam, sel_unpack(sels[b], bucket_size))
        hit |= (table[b] == hashing.to_i32(exp)).any(dim=1)
    if stash is not None:
        hit = hit | stash_match(stash, fam[0], i1, i2)
    return hit


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
    cuda.launch(name, table.data_ptr(), sels.data_ptr(), table.shape[1],
                cuda.ptr(stash), 0 if stash is None else stash.shape[1],
                hi.data_ptr(), lo.data_ptr(), hit.data_ptr(), n, fp_bits,
                int(n_buckets))
    return hit
