"""Fused hash + bucket-probe bulk lookup, with an optional stash (kernel 2).

Counterpart of ``repro.kernels.probe.probe``.  The CUDA kernel
(``csrc/probe.cu``) runs one thread per key: hash, two 16-byte bucket
loads, compare; with a stash, a scan of the stash staged in shared memory.
The plain version below gathers both buckets with tensor indexing.
"""
from __future__ import annotations

import torch

from repro_torch.core import hashing
from repro_torch.kernels import cuda
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
