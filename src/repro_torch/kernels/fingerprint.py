"""Batched fingerprint + bucket-index hashing (kernel 1).

Counterpart of ``repro.kernels.fingerprint.fingerprint_hash``.  The CUDA
kernel (``csrc/fingerprint.cu``) runs one thread per key; the plain
version below computes the same bits with ``core.hashing``.
"""
from __future__ import annotations

import torch

from repro_torch.core import hashing
from repro_torch.kernels import cuda

DEFAULT_BLOCK = 1024


def fingerprint_hash_plain(hi: torch.Tensor, lo: torch.Tensor, *,
                           fp_bits: int, n_buckets: int):
    """Plain PyTorch version -> (fp, i1, i2), int32[N] each."""
    cuda.PLAIN_CALLS["fingerprint_hash"] += 1
    fp = hashing.fingerprint(hi, lo, fp_bits)
    i1 = hashing.index_hash(hi, lo, n_buckets)
    i2 = hashing.alt_index(i1, fp, n_buckets)
    return hashing.to_i32(fp), hashing.to_i32(i1), hashing.to_i32(i2)


def fingerprint_hash(hi: torch.Tensor, lo: torch.Tensor, *, fp_bits: int,
                     n_buckets: int, block: int = DEFAULT_BLOCK):
    """(fp, i1, i2) for int32 key halves -> int32[N] each (uint32 bits).

    ``block`` is the reference's tiling; N must be a multiple of
    ``min(block, N)`` (``kernels.ops.hash_keys`` pads).  CPU tensors take
    the plain version; CUDA tensors launch the kernel.
    """
    n = hi.shape[0]
    if n and n % min(block, n):
        raise ValueError(f"{n=} not a multiple of {block=}")
    if hi.device.type == "cpu":
        return fingerprint_hash_plain(hi, lo, fp_bits=fp_bits,
                                      n_buckets=n_buckets)
    cuda.check_cuda("fingerprint_hash", hi=hi, lo=lo)
    cuda.check_dtype("fingerprint_hash", torch.int32, hi=hi, lo=lo)
    fp, i1, i2 = (torch.empty_like(hi) for _ in range(3))
    cuda.launch("fingerprint_hash", hi.data_ptr(), lo.data_ptr(),
                fp.data_ptr(), i1.data_ptr(), i2.data_ptr(), n, fp_bits,
                int(n_buckets))
    return fp, i1, i2
