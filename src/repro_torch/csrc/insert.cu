// insert_bulk: fused hash + bulk insert with bounded eviction rounds, an
// optional overflow-stash spill, and per-lane rollback.
//
// Replaces the TPU kernel repro/kernels/insert.py::_insert_bulk_impl
// (_insert_kernel, _insert_stash_kernel; bodies _insert_body, _place_round,
// _evict_rounds).  Entry points insert_bulk and insert_once
// (evict_rounds = 0).
//
// What the result depends on, and how this kernel keeps it:
//   * Logical blocks run IN ORDER with the table (and stash) carried from
//     block b to block b + 1: on the TPU that is the sequential grid with
//     aliased in->out BlockSpecs.  A CUDA grid has no order, so this kernel
//     is ONE CTA that loops over the logical blocks, with the table in
//     device memory and updated in place.
//   * Every round has simultaneous-write semantics (the reference is a
//     JAX scatter): all reads of a round (free slots, the target row, the
//     victim after phase A) see the table as it was before the round's
//     writes.  Each round is therefore a compute pass, __syncthreads(), a
//     write pass, __syncthreads().  Lanes that lose write nothing.
//   * Ranks are taken within the logical block (rank_among_earlier), so the
//     block size is part of the result; the caller passes the reference's.
//   * The dirty mask (kicked slots that no other lane may kick) lives in a
//     zeroed byte array that persists across blocks and calls (the wrapper
//     keeps one per device and stream); at the end of each block exactly
//     the slots in the block's kick history are cleared again, instead of
//     clearing a table-sized array per block or per call.
//   * Early exits match the reference's while_loop (no active lane left)
//     and its rollback cond (no failed lane); they change no result.
//
// Bound on the H100: the serialized single-CTA loop.  One SM walks the
// blocks and rounds one after another, with two or three CTA-wide barriers
// per round and an O(block) rank count per lane, so the time grows with
// (blocks x rounds) and not with bytes moved.  A block of up to 4096 lanes
// is handled by giving each thread several lanes.  Per-lane state and the
// kick history (width evict_rounds) live in device-memory scratch that the
// wrapper allocates; all of it stays in this SM's L1/L2 working set.
#include "ocf_common.cuh"

namespace {

struct Lanes {
  uint32_t* fp;       // key fingerprint
  uint32_t* i2;       // alternate bucket
  uint32_t* tgt;      // target bucket of the current round
  uint32_t* val;      // value the current round writes
  uint32_t* carried;  // eviction chain: fingerprint carried
  uint32_t* bucket;   // eviction chain: current bucket
  uint32_t* victim;   // phase B: fingerprint kicked out
  int32_t* slot;      // decision of the current round (-1: none)
  int32_t* steps;     // kicks committed so far
  uint8_t* act;       // lanes taking part in the current round
  uint8_t* placed;    // result of the current round
  uint8_t* ok;        // lane has landed (table or stash)
  uint8_t* active;    // eviction residue still carrying a fingerprint
  uint8_t* valid;     // lane is a real key of this block
};

// One placement attempt: each act lane writes val into the rank-th empty
// slot of its tgt bucket, when there is one.
__device__ void place_round(uint32_t* table, int bsz, const Lanes& L,
                            int nl) {
  for (int i = threadIdx.x; i < nl; i += blockDim.x) {
    int slot = -1;
    if (L.act[i]) {
      const int r = ocf::rank_among_earlier(i, L.tgt, L.act, nullptr);
      slot = ocf::nth_slot_equal(table + (size_t)L.tgt[i] * bsz, bsz, 0u, r);
    }
    L.slot[i] = slot;
  }
  __syncthreads();
  for (int i = threadIdx.x; i < nl; i += blockDim.x) {
    const int slot = L.slot[i];
    if (slot >= 0) table[(size_t)L.tgt[i] * bsz + slot] = L.val[i];
    L.placed[i] = slot >= 0 ? 1 : 0;
  }
  __syncthreads();
}

__global__ void insert_kernel(uint32_t* table, int bsz, uint32_t n_buckets,
                              uint32_t* stash, int stash_slots,
                              const uint32_t* hi, const uint32_t* lo,
                              const uint8_t* valid, uint8_t* ok_out, int n,
                              int block, int fp_bits, int rounds, Lanes L,
                              int32_t* hb, int32_t* hs, uint32_t* hw,
                              uint8_t* dirty) {
  for (int base = 0; base < n; base += block) {
    const int nl = min(block, n - base);

    // Two optimistic rounds: home bucket, then alternate bucket.
    for (int i = threadIdx.x; i < nl; i += blockDim.x) {
      const uint32_t h = hi[base + i], l = lo[base + i];
      const uint32_t fp = ocf::fingerprint(h, l, fp_bits);
      const uint32_t i1 = ocf::index_hash(h, l, n_buckets);
      L.fp[i] = fp;
      L.i2[i] = ocf::alt_index(i1, fp, n_buckets);
      L.tgt[i] = i1;
      L.val[i] = fp;
      L.valid[i] = valid[base + i] ? 1 : 0;
      L.act[i] = L.valid[i];
    }
    __syncthreads();
    place_round(table, bsz, L, nl);
    for (int i = threadIdx.x; i < nl; i += blockDim.x) {
      L.ok[i] = L.placed[i];
      L.act[i] = L.valid[i] && !L.placed[i];
      L.tgt[i] = L.i2[i];
    }
    __syncthreads();
    place_round(table, bsz, L, nl);

    // The residue carries its own fingerprint from the alternate bucket,
    // where the sequential chain starts.
    int any = 0;
    for (int i = threadIdx.x; i < nl; i += blockDim.x) {
      L.ok[i] = L.ok[i] || L.placed[i];
      L.active[i] = L.valid[i] && !L.ok[i];
      L.carried[i] = L.fp[i];
      L.bucket[i] = L.i2[i];
      L.steps[i] = 0;
      any |= L.active[i];
    }
    any = __syncthreads_or(any);

    for (int r = 0; r < rounds && any; ++r) {
      // Phase A: the carried fingerprint into an empty slot of its bucket.
      for (int i = threadIdx.x; i < nl; i += blockDim.x) {
        L.tgt[i] = L.bucket[i];
        L.act[i] = L.active[i];
        L.val[i] = L.carried[i];
      }
      __syncthreads();
      place_round(table, bsz, L, nl);
      // A lane that landed never rolls back: release its kicked slots.
      for (int i = threadIdx.x; i < nl; i += blockDim.x) {
        if (!L.placed[i]) continue;
        L.active[i] = 0;
        L.act[i] = 0;
        const int32_t* hbi = hb + (size_t)i * rounds;
        const int32_t* hsi = hs + (size_t)i * rounds;
        for (int t = 0; t < L.steps[i]; ++t)
          dirty[(size_t)hbi[t] * bsz + hsi[t]] = 0;
      }
      __syncthreads();
      // Phase B: the earliest active lane of each bucket kicks the first
      // non-dirty slot, rotating from steps % bucket_size.
      for (int i = threadIdx.x; i < nl; i += blockDim.x) {
        int slot = -1;
        if (L.act[i] &&
            ocf::rank_among_earlier(i, L.tgt, L.act, nullptr) == 0) {
          const size_t row = (size_t)L.bucket[i] * bsz;
          const int start = L.steps[i] % bsz;
          for (int k = 0; k < bsz; ++k) {
            const int pos = (k + start) % bsz;
            if (!dirty[row + pos]) {
              slot = pos;
              break;
            }
          }
          if (slot >= 0) L.victim[i] = table[row + slot];
        }
        L.slot[i] = slot;
      }
      __syncthreads();
      int still = 0;
      for (int i = threadIdx.x; i < nl; i += blockDim.x) {
        const int slot = L.slot[i];
        if (slot >= 0) {
          const uint32_t b = L.bucket[i];
          const size_t at = (size_t)b * bsz + slot;
          const size_t h = (size_t)i * rounds + L.steps[i];
          table[at] = L.carried[i];
          dirty[at] = 1;
          hb[h] = (int32_t)b;
          hs[h] = slot;
          hw[h] = L.carried[i];
          const uint32_t v = L.victim[i];
          L.carried[i] = v;
          L.bucket[i] = ocf::alt_index(b, v, n_buckets);
          L.steps[i] += 1;
        }
        still |= L.active[i];
      }
      any = __syncthreads_or(still);
    }

    // Stash spill: exhausted lanes, in lane order, take the free stash
    // slots in slot order (the reference's lane-order prefix sum).
    if (stash != nullptr) {
      if (threadIdx.x == 0) {
        int s = 0;
        for (int i = 0; i < nl; ++i) {
          if (!L.active[i]) continue;
          while (s < stash_slots && stash[s] != 0u) ++s;
          if (s == stash_slots) break;
          stash[s] = L.carried[i];
          stash[stash_slots + s] = L.bucket[i];
          L.active[i] = 0;
          ++s;
        }
      }
      __syncthreads();
    }

    // Rollback: lanes still carrying restore their kicks newest first (the
    // dirty discipline makes those slots theirs alone); every other residue
    // lane has landed.
    for (int i = threadIdx.x; i < nl; i += blockDim.x) {
      const int32_t* hbi = hb + (size_t)i * rounds;
      const int32_t* hsi = hs + (size_t)i * rounds;
      if (L.active[i]) {
        uint32_t cur = L.carried[i];
        for (int t = L.steps[i] - 1; t >= 0; --t) {
          table[(size_t)hbi[t] * bsz + hsi[t]] = cur;
          cur = hw[(size_t)i * rounds + t];
        }
      } else if (L.valid[i]) {
        L.ok[i] = 1;
      }
      ok_out[base + i] = L.ok[i];
    }
    __syncthreads();
    // Leave the dirty mask all-zero for the next block.
    for (int i = threadIdx.x; i < nl; i += blockDim.x) {
      const int32_t* hbi = hb + (size_t)i * rounds;
      const int32_t* hsi = hs + (size_t)i * rounds;
      for (int t = 0; t < L.steps[i]; ++t)
        dirty[(size_t)hbi[t] * bsz + hsi[t]] = 0;
    }
    __syncthreads();
  }
}

}  // namespace

// lane_u32: uint32[9, block]; lane_u8: uint8[5, block];
// hist: int32[3, block * max(evict_rounds, 1)];
// dirty: uint8[>= buffer_buckets * bucket_size], all zero (left all zero).
extern "C" int ocf_insert_bulk(void* table, int bucket_size,
                               unsigned int n_buckets, void* stash,
                               int stash_slots, const void* hi,
                               const void* lo, const void* valid, void* ok,
                               int n, int block, int fp_bits,
                               int evict_rounds, void* lane_u32,
                               void* lane_u8, void* hist, void* dirty,
                               void* stream) {
  if (n > 0) {
    uint32_t* u = (uint32_t*)lane_u32;
    uint8_t* b = (uint8_t*)lane_u8;
    Lanes L;
    L.fp = u;
    L.i2 = u + block;
    L.tgt = u + 2 * (size_t)block;
    L.val = u + 3 * (size_t)block;
    L.carried = u + 4 * (size_t)block;
    L.bucket = u + 5 * (size_t)block;
    L.victim = u + 6 * (size_t)block;
    L.slot = (int32_t*)(u + 7 * (size_t)block);
    L.steps = (int32_t*)(u + 8 * (size_t)block);
    L.act = b;
    L.placed = b + block;
    L.ok = b + 2 * (size_t)block;
    L.active = b + 3 * (size_t)block;
    L.valid = b + 4 * (size_t)block;
    const size_t width = (size_t)block * (evict_rounds > 0 ? evict_rounds : 1);
    int32_t* h = (int32_t*)hist;
    int threads = ((block + 31) / 32) * 32;
    if (threads > 1024) threads = 1024;
    insert_kernel<<<1, threads, 0, (cudaStream_t)stream>>>(
        (uint32_t*)table, bucket_size, n_buckets, (uint32_t*)stash,
        stash ? stash_slots : 0, (const uint32_t*)hi, (const uint32_t*)lo,
        (const uint8_t*)valid, (uint8_t*)ok, n, block, fp_bits,
        evict_rounds, L, h, h + width, (uint32_t*)(h + 2 * width),
        (uint8_t*)dirty);
  }
  return (int)cudaGetLastError();
}
