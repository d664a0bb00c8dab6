"""Hash primitives of the Optimized Cuckoo Filter, in PyTorch and numpy.

Counterpart of ``repro.core.hashing``.  The hash family is 32-bit mixing
(murmur3 finalizer and a splitmix-derived mixer) over ``(hi, lo)`` uint32
key halves.  Every function has two spellings with identical bits:

  * ``*_np`` — numpy uint32 (host side: key splitting, oracles);
  * torch    — tensors on any device.  PyTorch on the CPU has no ``>>``,
    ``+``, ``%`` or ``minimum`` for ``uint32``, so the torch spelling
    carries every value in ``int64`` masked to 32 bits, and splits each
    32x32-bit product so that no intermediate leaves the int64 range.

The CUDA kernels (``csrc/ocf_common.cuh``) implement the same spec in
native uint32 arithmetic; the tests hold all three spellings together.

Partial-key cuckoo hashing, per key:
  fp  = fingerprint(key)      in [1, 2^f - 1]   (0 is the EMPTY sentinel)
  i1  = index_hash(key)       mod n_buckets
  i2  = (H(fp) - i1) mod n    additive-complement involution, valid for
                              any bucket count: alt(alt(i)) == i.

Decided once here for the whole package:

  * **Storage.**  Tables, stashes and key halves are ``int32`` tensors
    holding the uint32 bit pattern (``to_i32`` / ``to_u32``); the kernels
    reinterpret them as ``uint32``.
  * **Device.**  Entry points take ``device="cuda"`` by default and raise
    when no card is present (``resolve_device``); running on the CPU is
    something a caller asks for with ``device="cpu"``.
"""
from __future__ import annotations

import numpy as np
import torch

MASK32 = 0xFFFFFFFF

_M3_C1 = 0x85EBCA6B
_M3_C2 = 0xC2B2AE35
_SM_C1 = 0x9E3779B9  # golden-ratio increment (splitmix)
_SM_C2 = 0x7FEB352D
_SM_C3 = 0x846CA68B
_FP_SEED = 0xDEADBEEF
_IDX_SEED = 0x51ED270B


# ---------------------------------------------------------------- device ---


def resolve_device(device="cuda") -> torch.device:
    """The device an entry point runs on; raises rather than fall back.

    ``device="cuda"`` (the default of every entry point) needs a card:
    without one this raises ``RuntimeError`` instead of quietly running the
    plain PyTorch versions on the CPU.  Pass ``device="cpu"`` to run there.
    """
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch: no CUDA device is available; pass device='cpu' "
            "to run the plain PyTorch versions on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {device!r} (cuda | cpu)")
    return dev


# ---------------------------------------------------------------- dtypes ---


def to_u32(x: torch.Tensor) -> torch.Tensor:
    """Any integer tensor -> int64 holding its low 32 bits as unsigned."""
    return x.to(torch.int64) & MASK32


def to_i32(x: torch.Tensor) -> torch.Tensor:
    """int64 values in [0, 2^32) -> int32 holding the same bit pattern."""
    x = x.to(torch.int64) & MASK32
    return torch.where(x >= (1 << 31), x - (1 << 32), x).to(torch.int32)


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """(x * c) mod 2^32 for x in [0, 2^32), without leaving int64."""
    c_lo, c_hi = c & 0xFFFF, c >> 16
    return (x * c_lo + (((x * c_hi) & 0xFFFF) << 16)) & MASK32


# ---------------------------------------------------------------- numpy ----


def murmur3_mix_np(x: np.ndarray) -> np.ndarray:
    """murmur3 32-bit finalizer — a full-avalanche bijection on uint32."""
    x = np.asarray(x, dtype=np.uint32)
    with np.errstate(over="ignore"):
        x = x ^ (x >> np.uint32(16))
        x = (x * np.uint32(_M3_C1)).astype(np.uint32)
        x = x ^ (x >> np.uint32(13))
        x = (x * np.uint32(_M3_C2)).astype(np.uint32)
        x = x ^ (x >> np.uint32(16))
    return x


def splitmix32_np(x: np.ndarray) -> np.ndarray:
    """splitmix-style 32-bit mixer (independent avalanche function)."""
    x = np.asarray(x, dtype=np.uint32)
    with np.errstate(over="ignore"):
        x = (x + np.uint32(_SM_C1)).astype(np.uint32)
        x = x ^ (x >> np.uint32(16))
        x = (x * np.uint32(_SM_C2)).astype(np.uint32)
        x = x ^ (x >> np.uint32(15))
        x = (x * np.uint32(_SM_C3)).astype(np.uint32)
        x = x ^ (x >> np.uint32(16))
    return x


def key_to_u32_pair_np(keys) -> tuple[np.ndarray, np.ndarray]:
    """Split arbitrary integer keys into (hi, lo) uint32 halves."""
    k = np.asarray(keys, dtype=np.uint64)
    lo = (k & np.uint64(MASK32)).astype(np.uint32)
    hi = (k >> np.uint64(32)).astype(np.uint32)
    return hi, lo


def fingerprint_np(hi: np.ndarray, lo: np.ndarray, fp_bits: int) -> np.ndarray:
    """Fingerprint in [1, 2^fp_bits - 1] (0 reserved as EMPTY)."""
    h = murmur3_mix_np(np.asarray(lo, np.uint32)
                       ^ murmur3_mix_np(np.asarray(hi, np.uint32)
                                        ^ np.uint32(_FP_SEED)))
    fp = (h & np.uint32((1 << fp_bits) - 1)).astype(np.uint32)
    return np.where(fp == 0, np.uint32(1), fp)


def index_hash_np(hi: np.ndarray, lo: np.ndarray, n_buckets: int) -> np.ndarray:
    with np.errstate(over="ignore"):
        h = splitmix32_np(lo) ^ murmur3_mix_np(
            (np.asarray(hi, np.uint32) + np.uint32(_IDX_SEED)).astype(np.uint32))
    return (h % np.uint32(n_buckets)).astype(np.uint32)


def alt_index_np(i: np.ndarray, fp: np.ndarray, n_buckets: int) -> np.ndarray:
    """Additive-complement alternate bucket: alt(i) = (H(fp) - i) mod n."""
    hfp = splitmix32_np(fp).astype(np.uint64) % np.uint64(n_buckets)
    i = np.asarray(i, dtype=np.uint64) % np.uint64(n_buckets)
    return ((hfp + np.uint64(n_buckets) - i)
            % np.uint64(n_buckets)).astype(np.uint32)


# ---------------------------------------------------------------- torch ----


def murmur3_mix(x: torch.Tensor) -> torch.Tensor:
    """Torch twin of ``murmur3_mix_np`` -> int64 in [0, 2^32)."""
    x = to_u32(x)
    x = x ^ (x >> 16)
    x = _mul32(x, _M3_C1)
    x = x ^ (x >> 13)
    x = _mul32(x, _M3_C2)
    return x ^ (x >> 16)


def splitmix32(x: torch.Tensor) -> torch.Tensor:
    """Torch twin of ``splitmix32_np`` -> int64 in [0, 2^32)."""
    x = (to_u32(x) + _SM_C1) & MASK32
    x = x ^ (x >> 16)
    x = _mul32(x, _SM_C2)
    x = x ^ (x >> 15)
    x = _mul32(x, _SM_C3)
    return x ^ (x >> 16)


def fingerprint(hi: torch.Tensor, lo: torch.Tensor, fp_bits: int
                ) -> torch.Tensor:
    """Fingerprint in [1, 2^fp_bits - 1] -> int64."""
    h = murmur3_mix(to_u32(lo) ^ murmur3_mix(to_u32(hi) ^ _FP_SEED))
    fp = h & ((1 << fp_bits) - 1)
    return torch.where(fp == 0, torch.ones_like(fp), fp)


def index_hash(hi: torch.Tensor, lo: torch.Tensor, n_buckets: int
               ) -> torch.Tensor:
    """Home bucket in [0, n_buckets) -> int64."""
    h = splitmix32(lo) ^ murmur3_mix((to_u32(hi) + _IDX_SEED) & MASK32)
    return h % int(n_buckets)


def alt_index(i: torch.Tensor, fp: torch.Tensor, n_buckets: int
              ) -> torch.Tensor:
    """(H(fp) - i) mod n -> int64; an involution in ``i`` for fixed fp."""
    n = int(n_buckets)
    hfp = splitmix32(fp) % n
    return (hfp + n - to_u32(i) % n) % n


# The bucket count is always a host int in this package (the reference's
# traced-scalar ``*_dyn`` spellings collapse onto the static ones).
index_hash_dyn = index_hash
alt_index_dyn = alt_index


def key_to_u32_pair(keys: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Split key tensors into (hi, lo) int32 halves (uint32 bit patterns).

    32-bit inputs get ``hi = 0``; 64-bit inputs (the uint64 key bit pattern
    in an ``int64`` tensor) split into their upper and lower words.
    """
    if keys.dtype in (torch.int32, torch.uint32):
        lo = to_i32(keys.to(torch.int64) & MASK32)
        return torch.zeros_like(lo), lo
    k = keys.to(torch.int64)
    return to_i32((k >> 32) & MASK32), to_i32(k & MASK32)
