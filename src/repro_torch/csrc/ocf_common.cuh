// Shared device code of the OCF filter kernels (sm_90a).
//
// One spec of the hash family for every kernel: these functions are the
// uint32 spelling of repro_torch/core/hashing.py (and of the reference's
// repro/core/hashing.py), bit for bit.  The lane helpers below are the
// pieces the one-CTA insert and delete kernels share.
//
// Storage: tables and stashes are int32 tensors holding uint32 bit
// patterns; the kernels take them as uint32_t pointers.  Bool tensors are
// one byte per lane (0 or 1).
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace ocf {

__host__ __device__ __forceinline__ uint32_t murmur3_mix(uint32_t x) {
  x ^= x >> 16;
  x *= 0x85EBCA6Bu;
  x ^= x >> 13;
  x *= 0xC2B2AE35u;
  x ^= x >> 16;
  return x;
}

__host__ __device__ __forceinline__ uint32_t splitmix32(uint32_t x) {
  x += 0x9E3779B9u;
  x ^= x >> 16;
  x *= 0x7FEB352Du;
  x ^= x >> 15;
  x *= 0x846CA68Bu;
  x ^= x >> 16;
  return x;
}

// Fingerprint in [1, 2^fp_bits - 1]; 0 is the EMPTY sentinel.
__host__ __device__ __forceinline__ uint32_t fingerprint(uint32_t hi,
                                                         uint32_t lo,
                                                         int fp_bits) {
  const uint32_t h = murmur3_mix(lo ^ murmur3_mix(hi ^ 0xDEADBEEFu));
  const uint32_t mask =
      fp_bits >= 32 ? 0xFFFFFFFFu : ((1u << fp_bits) - 1u);
  const uint32_t fp = h & mask;
  return fp == 0u ? 1u : fp;
}

__host__ __device__ __forceinline__ uint32_t index_hash(uint32_t hi,
                                                        uint32_t lo,
                                                        uint32_t n) {
  return (splitmix32(lo) ^ murmur3_mix(hi + 0x51ED270Bu)) % n;
}

// (H(fp) - i) mod n.  Both terms are < n <= 2^31, so hfp + n - i fits.
__host__ __device__ __forceinline__ uint32_t alt_index(uint32_t i,
                                                       uint32_t fp,
                                                       uint32_t n) {
  const uint32_t hfp = splitmix32(fp) % n;
  i %= n;
  return (hfp + n - i) % n;
}

// ------------------------------------------------- one-CTA lane helpers --
//
// The insert and delete kernels run ONE thread block that walks the
// logical blocks of a batch in order (the TPU grid's sequential carry).
// A logical block may hold more lanes than the CTA has threads, so every
// per-lane loop strides by blockDim.x.

// #earlier active lanes of the block whose target (and, with a non-null
// ``key``, whose key as well) equals lane i's: the reference's
// rank_among_earlier, an O(block) count per lane.
__device__ __forceinline__ int rank_among_earlier(int i, const uint32_t* tgt,
                                                  const uint8_t* act,
                                                  const uint32_t* key) {
  const uint32_t t = tgt[i];
  int r = 0;
  if (key == nullptr) {
    for (int j = 0; j < i; ++j) r += (act[j] && tgt[j] == t) ? 1 : 0;
  } else {
    const uint32_t k = key[i];
    for (int j = 0; j < i; ++j)
      r += (act[j] && tgt[j] == t && key[j] == k) ? 1 : 0;
  }
  return r;
}

// Position of the rank-th slot of ``row`` equal to ``value`` (or -1).
__device__ __forceinline__ int nth_slot_equal(const uint32_t* row,
                                              int bucket_size,
                                              uint32_t value, int rank) {
  int seen = 0;
  for (int s = 0; s < bucket_size; ++s) {
    if (row[s] == value) {
      if (seen == rank) return s;
      ++seen;
    }
  }
  return -1;
}

}  // namespace ocf
