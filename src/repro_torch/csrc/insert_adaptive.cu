// insert_bulk_adaptive: fused hash + bulk insert over the four adaptive
// planes (fingerprints, packed selectors, mirror key halves khi/klo), with
// bounded eviction rounds, an optional stash spill and per-lane rollback.
//
// Replaces the TPU kernel repro/kernels/insert.py::_insert_adaptive_impl
// (_insert_adaptive_kernel, _insert_adaptive_stash_kernel; bodies
// _insert_adaptive_body, _place_round_adaptive, _evict_rounds_adaptive).
//
// The schedule is insert.cu's, and so are the reasons for it: ONE CTA
// walks the logical blocks in order with the planes updated in place (the
// TPU's sequential grid with aliased in->out BlockSpecs); each round is a
// compute pass, __syncthreads(), a write pass, __syncthreads() (JAX
// scatter semantics: every read of a round sees the planes as before its
// writes); ranks are taken within the logical block; the dirty mask is a
// zeroed byte array kept across calls and cleared from the kick history at
// the end of each block.  What the adaptive planes add:
//   * Placements and kicks write (fp0 of the carried key, selector 0, the
//     key into khi/klo).
//   * Lanes carry the KEY.  A kicked victim's next bucket is the alternate
//     of its MIRROR key's fp0, never of the stored fingerprint, which may
//     be an adapted family member.
//   * The history is six wide per lane and round (bucket, slot, and the
//     kicked slot's original fp, selector, hi, lo).  A failed lane owns its
//     kicked slots (they stay dirty), so restoring the originals newest
//     first is exact.
//   * Spills park the carried key's fp0, recomputed from the carried key.
//   * The packed selector word is shared by every slot of a bucket, and
//     one write pass can set different slots of one word from different
//     threads (placements of different ranks, rollbacks of different
//     lanes).  Each 2-bit field is therefore written with atomicAnd /
//     atomicOr (ocf::set_sel): the fields are disjoint, so the order of the
//     atomics does not matter.  That keeps the plane packed throughout; an
//     unpacked byte scratch would need a table-sized unpack and repack per
//     call.  Reads of the word happen only in compute passes, after a
//     __syncthreads() that makes the atomics visible.
//
// Bound on the H100: the serialized single-CTA loop, as for insert.cu.
// Per-lane state and the kick history live in device-memory scratch that
// the wrapper allocates.
#include "ocf_common.cuh"

namespace {

struct Planes {
  uint32_t* table;
  uint32_t* sels;  // one packed word per bucket
  uint32_t* khi;
  uint32_t* klo;
  int bsz;
};

struct Lanes {
  uint32_t* fp;      // key fingerprint (fp0)
  uint32_t* i2;      // alternate bucket
  uint32_t* tgt;     // target bucket of the current round
  uint32_t* val;     // fingerprint the current round writes
  uint32_t* chi;     // carried key, high half
  uint32_t* clo;     // carried key, low half
  uint32_t* bucket;  // eviction chain: current bucket
  uint32_t* vfp;     // phase B: the victim's original four planes
  uint32_t* vsel;
  uint32_t* vhi;
  uint32_t* vlo;
  int32_t* slot;     // decision of the current round (-1: none)
  int32_t* steps;    // kicks committed so far
  uint8_t* act;      // lanes taking part in the current round
  uint8_t* placed;   // result of the current round
  uint8_t* ok;       // lane has landed (table or stash)
  uint8_t* active;   // eviction residue still carrying a key
  uint8_t* valid;    // lane is a real key of this block
};

struct History {     // [lane * rounds + step]
  int32_t* b;
  int32_t* s;
  uint32_t* fp;
  uint32_t* sel;
  uint32_t* hi;
  uint32_t* lo;
};

__device__ __forceinline__ void write_slot(const Planes& P, uint32_t b, int s,
                                           uint32_t fp, uint32_t sel,
                                           uint32_t hi, uint32_t lo) {
  const size_t at = (size_t)b * P.bsz + s;
  P.table[at] = fp;
  P.khi[at] = hi;
  P.klo[at] = lo;
  ocf::set_sel(P.sels + b, s, sel);
}

// One placement attempt: each act lane writes (val, sel 0, chi/clo) into
// the rank-th empty slot of its tgt bucket, when there is one.
__device__ void place_round(const Planes& P, const Lanes& L, int nl) {
  for (int i = threadIdx.x; i < nl; i += blockDim.x) {
    int slot = -1;
    if (L.act[i]) {
      const int r = ocf::rank_among_earlier(i, L.tgt, L.act, nullptr);
      slot = ocf::nth_slot_equal(P.table + (size_t)L.tgt[i] * P.bsz, P.bsz,
                                 0u, r);
    }
    L.slot[i] = slot;
  }
  __syncthreads();
  for (int i = threadIdx.x; i < nl; i += blockDim.x) {
    const int slot = L.slot[i];
    if (slot >= 0) write_slot(P, L.tgt[i], slot, L.val[i], 0u, L.chi[i],
                              L.clo[i]);
    L.placed[i] = slot >= 0 ? 1 : 0;
  }
  __syncthreads();
}

__global__ void insert_adaptive_kernel(Planes P, uint32_t n_buckets,
                                       uint32_t* stash, int stash_slots,
                                       const uint32_t* hi, const uint32_t* lo,
                                       const uint8_t* valid, uint8_t* ok_out,
                                       int n, int block, int fp_bits,
                                       int rounds, Lanes L, History H,
                                       uint8_t* dirty) {
  const int bsz = P.bsz;
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
      L.chi[i] = h;
      L.clo[i] = l;
      L.valid[i] = valid[base + i] ? 1 : 0;
      L.act[i] = L.valid[i];
    }
    __syncthreads();
    place_round(P, L, nl);
    for (int i = threadIdx.x; i < nl; i += blockDim.x) {
      L.ok[i] = L.placed[i];
      L.act[i] = L.valid[i] && !L.placed[i];
      L.tgt[i] = L.i2[i];
    }
    __syncthreads();
    place_round(P, L, nl);

    // The residue carries its own key from the alternate bucket.
    int any = 0;
    for (int i = threadIdx.x; i < nl; i += blockDim.x) {
      L.ok[i] = L.ok[i] || L.placed[i];
      L.active[i] = L.valid[i] && !L.ok[i];
      L.bucket[i] = L.i2[i];
      L.steps[i] = 0;
      any |= L.active[i];
    }
    any = __syncthreads_or(any);

    for (int r = 0; r < rounds && any; ++r) {
      // Phase A: the carried key's fp0 into an empty slot of its bucket.
      for (int i = threadIdx.x; i < nl; i += blockDim.x) {
        L.tgt[i] = L.bucket[i];
        L.act[i] = L.active[i];
        L.val[i] = ocf::fingerprint(L.chi[i], L.clo[i], fp_bits);
      }
      __syncthreads();
      place_round(P, L, nl);
      // A lane that landed never rolls back: release its kicked slots.
      for (int i = threadIdx.x; i < nl; i += blockDim.x) {
        if (!L.placed[i]) continue;
        L.active[i] = 0;
        L.act[i] = 0;
        const size_t h0 = (size_t)i * rounds;
        for (int t = 0; t < L.steps[i]; ++t)
          dirty[(size_t)H.b[h0 + t] * bsz + H.s[h0 + t]] = 0;
      }
      __syncthreads();
      // Phase B: the earliest active lane of each bucket kicks the first
      // non-dirty slot, rotating from steps % bucket_size, and reads the
      // victim's four planes before any write of the round.
      for (int i = threadIdx.x; i < nl; i += blockDim.x) {
        int slot = -1;
        if (L.act[i] &&
            ocf::rank_among_earlier(i, L.tgt, L.act, nullptr) == 0) {
          const uint32_t b = L.bucket[i];
          const size_t row = (size_t)b * bsz;
          const int start = L.steps[i] % bsz;
          for (int k = 0; k < bsz; ++k) {
            const int pos = (k + start) % bsz;
            if (!dirty[row + pos]) {
              slot = pos;
              break;
            }
          }
          if (slot >= 0) {
            L.vfp[i] = P.table[row + slot];
            L.vsel[i] = ocf::sel_of(P.sels[b], slot);
            L.vhi[i] = P.khi[row + slot];
            L.vlo[i] = P.klo[row + slot];
          }
        }
        L.slot[i] = slot;
      }
      __syncthreads();
      int still = 0;
      for (int i = threadIdx.x; i < nl; i += blockDim.x) {
        const int slot = L.slot[i];
        if (slot >= 0) {
          const uint32_t b = L.bucket[i];
          const size_t h = (size_t)i * rounds + L.steps[i];
          write_slot(P, b, slot, L.val[i], 0u, L.chi[i], L.clo[i]);
          dirty[(size_t)b * bsz + slot] = 1;
          H.b[h] = (int32_t)b;
          H.s[h] = slot;
          H.fp[h] = L.vfp[i];
          H.sel[h] = L.vsel[i];
          H.hi[h] = L.vhi[i];
          H.lo[h] = L.vlo[i];
          // Chase the victim: selector-0 geometry from its mirror key.
          const uint32_t vfp0 = ocf::fingerprint(L.vhi[i], L.vlo[i], fp_bits);
          L.chi[i] = L.vhi[i];
          L.clo[i] = L.vlo[i];
          L.bucket[i] = ocf::alt_index(b, vfp0, n_buckets);
          L.steps[i] += 1;
        }
        still |= L.active[i];
      }
      any = __syncthreads_or(still);
    }

    // Stash spill: exhausted lanes, in lane order, park the carried key's
    // fp0 in the free stash slots, in slot order.
    if (stash != nullptr) {
      if (threadIdx.x == 0) {
        int s = 0;
        for (int i = 0; i < nl; ++i) {
          if (!L.active[i]) continue;
          while (s < stash_slots && stash[s] != 0u) ++s;
          if (s == stash_slots) break;
          stash[s] = ocf::fingerprint(L.chi[i], L.clo[i], fp_bits);
          stash[stash_slots + s] = L.bucket[i];
          L.active[i] = 0;
          ++s;
        }
      }
      __syncthreads();
    }

    // Rollback: lanes still carrying restore the original four planes of
    // their kicked slots, newest first.
    for (int i = threadIdx.x; i < nl; i += blockDim.x) {
      if (L.active[i]) {
        const size_t h0 = (size_t)i * rounds;
        for (int t = L.steps[i] - 1; t >= 0; --t)
          write_slot(P, (uint32_t)H.b[h0 + t], H.s[h0 + t], H.fp[h0 + t],
                     H.sel[h0 + t], H.hi[h0 + t], H.lo[h0 + t]);
      } else if (L.valid[i]) {
        L.ok[i] = 1;
      }
      ok_out[base + i] = L.ok[i];
    }
    __syncthreads();
    // Leave the dirty mask all-zero for the next block.
    for (int i = threadIdx.x; i < nl; i += blockDim.x) {
      const size_t h0 = (size_t)i * rounds;
      for (int t = 0; t < L.steps[i]; ++t)
        dirty[(size_t)H.b[h0 + t] * bsz + H.s[h0 + t]] = 0;
    }
    __syncthreads();
  }
}

}  // namespace

// lane_u32: uint32[13, block]; lane_u8: uint8[5, block];
// hist: int32[6, block * max(evict_rounds, 1)];
// dirty: uint8[>= buffer_buckets * bucket_size], all zero (left all zero).
extern "C" int ocf_insert_bulk_adaptive(
    void* table, void* sels, void* khi, void* klo, int bucket_size,
    unsigned int n_buckets, void* stash, int stash_slots, const void* hi,
    const void* lo, const void* valid, void* ok, int n, int block,
    int fp_bits, int evict_rounds, void* lane_u32, void* lane_u8, void* hist,
    void* dirty, void* stream) {
  if (n > 0) {
    Planes P{(uint32_t*)table, (uint32_t*)sels, (uint32_t*)khi,
             (uint32_t*)klo, bucket_size};
    uint32_t* u = (uint32_t*)lane_u32;
    uint8_t* b = (uint8_t*)lane_u8;
    const size_t B = (size_t)block;
    Lanes L;
    L.fp = u;
    L.i2 = u + B;
    L.tgt = u + 2 * B;
    L.val = u + 3 * B;
    L.chi = u + 4 * B;
    L.clo = u + 5 * B;
    L.bucket = u + 6 * B;
    L.vfp = u + 7 * B;
    L.vsel = u + 8 * B;
    L.vhi = u + 9 * B;
    L.vlo = u + 10 * B;
    L.slot = (int32_t*)(u + 11 * B);
    L.steps = (int32_t*)(u + 12 * B);
    L.act = b;
    L.placed = b + B;
    L.ok = b + 2 * B;
    L.active = b + 3 * B;
    L.valid = b + 4 * B;
    const size_t width = B * (evict_rounds > 0 ? evict_rounds : 1);
    int32_t* h = (int32_t*)hist;
    History H{h, h + width, (uint32_t*)(h + 2 * width),
              (uint32_t*)(h + 3 * width), (uint32_t*)(h + 4 * width),
              (uint32_t*)(h + 5 * width)};
    int threads = ((block + 31) / 32) * 32;
    if (threads > 1024) threads = 1024;
    insert_adaptive_kernel<<<1, threads, 0, (cudaStream_t)stream>>>(
        P, n_buckets, (uint32_t*)stash, stash ? stash_slots : 0,
        (const uint32_t*)hi, (const uint32_t*)lo, (const uint8_t*)valid,
        (uint8_t*)ok, n, block, fp_bits, evict_rounds, L, H,
        (uint8_t*)dirty);
  }
  return (int)cudaGetLastError();
}
