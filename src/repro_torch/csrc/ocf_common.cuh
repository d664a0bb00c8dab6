// Shared device code of the OCF filter kernels (sm_90a).
//
// One spec of the hash family for every kernel: these functions are the
// uint32 spelling of repro_torch/core/hashing.py (and of the reference's
// repro/core/hashing.py), bit for bit.  The machinery of the staged insert
// and delete kernels is in staged.cuh.
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

// ------------------------------------------- selector family (adaptive) --
//
// Selector s XORs a tweak into the fingerprint's pre-mix seed; tweak 0 is
// the identity, so fingerprint_sel(.., 0, ..) == fingerprint(..).  Bucket
// geometry always comes from the selector-0 member.  The packed selector
// plane keeps slot s of a bucket in bits [2s, 2s+2) of one uint32 word.

__host__ __device__ __forceinline__ uint32_t sel_tweak(uint32_t sel) {
  switch (sel & 3u) {
    case 1u: return 0x7F4A7C15u;
    case 2u: return 0x94D049BBu;
    case 3u: return 0xBF58476Du;
    default: return 0u;
  }
}

__host__ __device__ __forceinline__ uint32_t fingerprint_sel(uint32_t hi,
                                                             uint32_t lo,
                                                             uint32_t sel,
                                                             int fp_bits) {
  const uint32_t h =
      murmur3_mix(lo ^ murmur3_mix(hi ^ (0xDEADBEEFu ^ sel_tweak(sel))));
  const uint32_t mask =
      fp_bits >= 32 ? 0xFFFFFFFFu : ((1u << fp_bits) - 1u);
  const uint32_t fp = h & mask;
  return fp == 0u ? 1u : fp;
}

// Selector of slot s in a packed selector word.
__host__ __device__ __forceinline__ uint32_t sel_of(uint32_t word, int s) {
  return (word >> (2 * s)) & 3u;
}

// The four family fingerprints of a key.
__host__ __device__ __forceinline__ void fp_family(uint32_t hi, uint32_t lo,
                                                   int fp_bits,
                                                   uint32_t fam[4]) {
  for (uint32_t s = 0; s < 4u; ++s) fam[s] = fingerprint_sel(hi, lo, s, fp_bits);
}

// Set slot s's 2-bit field of a packed selector word (in shared or device
// memory).  In one write pass several lanes may set DIFFERENT fields of
// one word (placements of different ranks, rollbacks of different lanes);
// the fields are disjoint, so two atomics per field (clear, then set) keep
// every other field intact in any order, where a plain read-modify-write
// would lose bits.  Their results are unused, so they issue as reductions
// that no thread waits for (reading the field first to skip them made the
// staged insert's write passes slower: tools/staged_probe.py).
__device__ __forceinline__ void set_sel(uint32_t* word, int s, uint32_t v) {
  atomicAnd(word, ~(3u << (2 * s)));
  if (v & 3u) atomicOr(word, (v & 3u) << (2 * s));
}

}  // namespace ocf
