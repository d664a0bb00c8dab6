"""Batched fingerprint + bucket-index hashing (kernels 1 and 6).

Counterpart of ``repro.kernels.fingerprint.fingerprint_hash`` and
``fingerprint_hash_family``.  The CUDA kernels (``csrc/fingerprint.cu``,
``csrc/fingerprint_family.cu``) run one thread per key; the plain versions
below compute the same bits with ``core.hashing``.
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
    cuda.launch("fingerprint_hash", hi.device, hi.data_ptr(),
                lo.data_ptr(), fp.data_ptr(), i1.data_ptr(), i2.data_ptr(),
                n, fp_bits, int(n_buckets))
    return fp, i1, i2


def fingerprint_hash_family_plain(hi: torch.Tensor, lo: torch.Tensor, *,
                                  fp_bits: int, n_buckets: int):
    """Plain PyTorch version -> ((f0, f1, f2, f3), i1, i2), int32[N] each."""
    cuda.PLAIN_CALLS["fingerprint_hash_family"] += 1
    fam = [hashing.fingerprint_sel(hi, lo, s, fp_bits)
           for s in range(hashing.SEL_VARIANTS)]
    i1 = hashing.index_hash(hi, lo, n_buckets)
    i2 = hashing.alt_index(i1, fam[0], n_buckets)
    return (tuple(hashing.to_i32(f) for f in fam), hashing.to_i32(i1),
            hashing.to_i32(i2))


def fingerprint_hash_family(hi: torch.Tensor, lo: torch.Tensor, *,
                            fp_bits: int, n_buckets: int,
                            block: int = DEFAULT_BLOCK):
    """Selector family ``(f0, f1, f2, f3)`` and the bucket pair ``(i1, i2)``,
    which comes from ``f0`` -> ((f0..f3), i1, i2), int32[N] each.

    ``f0`` is ``fingerprint_hash``'s ``fp`` bit for bit.  N must be a
    multiple of ``min(block, N)``.  CPU tensors take the plain version;
    CUDA tensors launch the kernel.
    """
    n = hi.shape[0]
    if n and n % min(block, n):
        raise ValueError(f"{n=} not a multiple of {block=}")
    if hi.device.type == "cpu":
        return fingerprint_hash_family_plain(hi, lo, fp_bits=fp_bits,
                                             n_buckets=n_buckets)
    return _family_cuda(hi, lo, fp_bits=fp_bits, n_buckets=n_buckets)


def _family_cuda(hi, lo, *, fp_bits, n_buckets):
    cuda.check_cuda("fingerprint_hash_family", hi=hi, lo=lo)
    cuda.check_dtype("fingerprint_hash_family", torch.int32, hi=hi, lo=lo)
    n = hi.shape[0]
    out = torch.empty((6, n), dtype=torch.int32, device=hi.device)
    cuda.launch("fingerprint_hash_family", hi.device, hi.data_ptr(),
                lo.data_ptr(), out.data_ptr(), n, fp_bits, int(n_buckets))
    return tuple(out[:4]), out[4], out[5]
