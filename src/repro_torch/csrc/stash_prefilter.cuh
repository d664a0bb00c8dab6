// A stash prefilter in shared memory, shared by probe_multi.cu (the live
// stashes of K generations) and probe_adaptive.cu (one stash).
//
// A stash is int32[2, S]: fingerprints (0 = empty) over home buckets.  A
// key whose buckets did not answer must learn whether some stash entry holds
// its fingerprint at one of its two buckets.  Scanning every slot for every
// such key costs S shared loads a key, almost all of them for nothing: a
// stash is nearly always empty or sparse.  So each CTA stages the stashes
// once into
//
// * a compact list of the live entries (fingerprint, bucket), appended by
//   warp ballots and one atomic a warp and batch, and
// * a 2^16-bit map with one bit a listed entry, indexed by the 16-bit fold
//   of its fingerprint, built from the list after it is complete, and only
//   when the list is not empty (an empty stash costs one staging pass over
//   its slots and no clearing).
//
// A key then reads its fold's bit; only if the bit is set does its whole
// warp walk the list, 32 entries a step, comparing fingerprint and buckets
// exactly (a lane walking alone would be the launch's tail: ~80 cycles an
// entry).  The map only decides who walks, so the answer is exact for any
// fold.  A launch with more than one pass of source entries stages them a
// pass at a time, each pass with its own list and map.
//
// Dynamic shared memory of a launch that stages up to L entries a pass:
// smem_bytes(L), the map then the list's fingerprints and buckets.
#pragma once

#include "ocf_common.cuh"

namespace stash_pf {

constexpr int kList = 1024;        // stash source entries a pass, at most
constexpr int kMapWords = 65536 / 32;
constexpr int kBatch = 4;          // stash entries a thread loads at once

__host__ __device__ constexpr int smem_bytes(int list) {
  return (kMapWords + 2 * list) * 4;
}

// A thread's keys: the fingerprint the stash holds (selector 0), both
// buckets, whether the key is in range and whether it is answered.
template <int kKeys>
struct Keys {
  uint32_t fp[kKeys], i1[kKeys], i2[kKeys];
  bool live[kKeys], h[kKeys];
};

__device__ __forceinline__ uint32_t fold16(uint32_t fp) {
  return (fp ^ (fp >> 16)) & 0xFFFFu;
}

// One staging pass: source entries [base, end) of the stashes, where entry
// e is slot e % S of the stash at ``stashes + slot[e / S] * 2 S``; at most
// ``list_cap`` of them.  Every thread of the CTA calls it, with the same
// arguments; it returns the number of live entries listed.  ``counts`` is
// two ints of shared memory used in turns: pass p appends into
// counts[parity] and zeroes the other for pass p + 1.  Before the first
// pass, counts[0] is 0 and ``slot`` is filled (the barrier this function
// starts with makes both visible).
__device__ __forceinline__ int stage_pass(const uint32_t* __restrict__ stashes,
                                          int stash_slots, const uint8_t* slot,
                                          int base, int end, uint32_t* smem,
                                          int list_cap, int* counts,
                                          int parity) {
  uint32_t* map = smem;
  uint32_t* list_fp = smem + kMapWords;
  uint32_t* list_bkt = list_fp + list_cap;
  int* count = counts + parity;
  const int lane = threadIdx.x & 31;
  const uint32_t lt = (1u << lane) - 1u;
  __syncthreads();  // the last pass's walks are done; slot and count are set
  if (threadIdx.x == 0) counts[parity ^ 1] = 0;
  for (int e0 = base; e0 < end; e0 += kBatch * blockDim.x) {
    uint32_t f[kBatch], b[kBatch];
#pragma unroll
    for (int i = 0; i < kBatch; ++i) {
      const int e = e0 + i * blockDim.x + threadIdx.x;
      f[i] = b[i] = 0;
      if (e < end) {
        const int r = e / stash_slots;
        const int j = e - r * stash_slots;
        const uint32_t* st = stashes + (size_t)slot[r] * 2 * stash_slots;
        f[i] = __ldg(st + j);
        b[i] = __ldg(st + stash_slots + j);
      }
    }
    // One atomic a warp and batch reserves the list positions of all its
    // live entries (an atomic an entry is a chain of kBatch round trips).
    uint32_t live[kBatch];
    int total = 0;
#pragma unroll
    for (int i = 0; i < kBatch; ++i) {
      live[i] = __ballot_sync(~0u, f[i] != 0);
      total += __popc(live[i]);
    }
    int at = 0;
    if (lane == 0 && total) at = atomicAdd(count, total);
    at = __shfl_sync(~0u, at, 0);
#pragma unroll
    for (int i = 0; i < kBatch; ++i) {
      if (f[i]) {
        const int p = at + __popc(live[i] & lt);
        list_fp[p] = f[i];
        list_bkt[p] = b[i];
      }
      at += __popc(live[i]);
    }
  }
  __syncthreads();
  const int c = *count;
  if (c > 0) {
    uint4* m4 = reinterpret_cast<uint4*>(map);
    for (int i = threadIdx.x; i < kMapWords / 4; i += blockDim.x)
      m4[i] = make_uint4(0u, 0u, 0u, 0u);
    __syncthreads();
    for (int i = threadIdx.x; i < c; i += blockDim.x) {
      const uint32_t w = fold16(list_fp[i]);
      atomicOr(map + (w >> 5), 1u << (w & 31));
    }
    __syncthreads();
  }
  return c;
}

// The keys not yet answered read their bits in the map; the warp then walks
// the list of ``count`` entries for each of its lanes whose bit is set and
// marks the lane answered if an entry holds its fingerprint at one of its
// buckets.  Every lane of the warp calls it.
template <int kKeys>
__device__ __forceinline__ void probe_list(const uint32_t* smem, int list_cap,
                                           int count, Keys<kKeys>& ks) {
  const uint32_t* map = smem;
  const uint32_t* list_fp = smem + kMapWords;
  const uint32_t* list_bkt = list_fp + list_cap;
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int q = 0; q < kKeys; ++q) {
    bool want = false;
    if (ks.live[q] && !ks.h[q]) {
      const uint32_t w = fold16(ks.fp[q]);
      want = (map[w >> 5] >> (w & 31)) & 1u;
    }
    for (uint32_t walkers = __ballot_sync(~0u, want); walkers;
         walkers &= walkers - 1) {
      const int src = __ffs(walkers) - 1;
      const uint32_t f = __shfl_sync(~0u, ks.fp[q], src);
      const uint32_t a = __shfl_sync(~0u, ks.i1[q], src);
      const uint32_t b = __shfl_sync(~0u, ks.i2[q], src);
      bool m = false;
#pragma unroll 4
      for (int s = lane; s < count; s += 32)
        m |= (list_fp[s] == f) & ((list_bkt[s] == a) | (list_bkt[s] == b));
      if (__any_sync(~0u, m) && lane == src) ks.h[q] = true;
    }
  }
}

}  // namespace stash_pf
