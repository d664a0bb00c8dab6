// delete_bulk_adaptive: fused family hash + first-match-slot bulk delete
// over the four adaptive planes.
//
// Replaces the TPU kernel repro/kernels/delete.py::_delete_adaptive_impl
// (_delete_adaptive_kernel; bodies _delete_adaptive_body,
// _clear_round_adaptive).
//
// The schedule is delete.cu's: ONE CTA walks the logical blocks in order
// (the TPU's sequential grid); within a block ALL home-bucket attempts run
// before ALL alternate-bucket attempts; each attempt is a round with JAX
// scatter semantics (compute, __syncthreads(), write, __syncthreads()).
// What the adaptive planes change:
//   * a slot matches when row[s] == fam[sel_of(word, s)], the key's family
//     fingerprint under the slot's own selector, so an adapted resident
//     stays deletable by its key;
//   * duplicates are ranked by (bucket, fp0) among earlier active lanes,
//     whatever the residents' selectors are, so the k-th duplicate clears
//     the k-th matching copy;
//   * a hit zeroes all four planes.  The selector field is cleared with
//     atomicAnd (ocf::set_sel): two lanes may clear different slots of one
//     bucket's packed word in the same write pass.
//
// Bound on the H100: the serialized single-CTA loop, as for delete.cu.
#include "ocf_common.cuh"

namespace {

struct Lanes {
  uint32_t* fam;     // [4, block]: f0..f3
  uint32_t* i2;
  uint32_t* tgt;
  int32_t* slot;
  uint8_t* act;
  uint8_t* placed;
  uint8_t* ok;
};

// One clear attempt: each act lane zeroes the rank-th slot of its tgt
// bucket that stores its family fingerprint under the slot's selector.
__device__ void clear_round(uint32_t* table, uint32_t* sels, uint32_t* khi,
                            uint32_t* klo, int bsz, const Lanes& L, int nl,
                            int block) {
  for (int i = threadIdx.x; i < nl; i += blockDim.x) {
    int s = -1;
    if (L.act[i]) {
      const int r = ocf::rank_among_earlier(i, L.tgt, L.act, L.fam);
      const uint32_t b = L.tgt[i];
      const uint32_t w = sels[b];
      const uint32_t* row = table + (size_t)b * bsz;
      int seen = 0;
      for (int k = 0; k < bsz; ++k) {
        if (row[k] == L.fam[(size_t)ocf::sel_of(w, k) * block + i]) {
          if (seen == r) {
            s = k;
            break;
          }
          ++seen;
        }
      }
    }
    L.slot[i] = s;
  }
  __syncthreads();
  for (int i = threadIdx.x; i < nl; i += blockDim.x) {
    const int s = L.slot[i];
    if (s >= 0) {
      const uint32_t b = L.tgt[i];
      const size_t at = (size_t)b * bsz + s;
      table[at] = 0u;
      khi[at] = 0u;
      klo[at] = 0u;
      ocf::set_sel(sels + b, s, 0u);
    }
    L.placed[i] = s >= 0 ? 1 : 0;
  }
  __syncthreads();
}

__global__ void delete_adaptive_kernel(uint32_t* table, uint32_t* sels,
                                       uint32_t* khi, uint32_t* klo, int bsz,
                                       uint32_t n_buckets, const uint32_t* hi,
                                       const uint32_t* lo,
                                       const uint8_t* valid, uint8_t* ok_out,
                                       int n, int block, int fp_bits,
                                       Lanes L) {
  for (int base = 0; base < n; base += block) {
    const int nl = min(block, n - base);
    for (int i = threadIdx.x; i < nl; i += blockDim.x) {
      const uint32_t h = hi[base + i], l = lo[base + i];
      uint32_t fam[4];
      ocf::fp_family(h, l, fp_bits, fam);
      for (int s = 0; s < 4; ++s) L.fam[(size_t)s * block + i] = fam[s];
      const uint32_t i1 = ocf::index_hash(h, l, n_buckets);
      L.i2[i] = ocf::alt_index(i1, fam[0], n_buckets);
      L.tgt[i] = i1;
      L.act[i] = valid[base + i] ? 1 : 0;
    }
    __syncthreads();
    clear_round(table, sels, khi, klo, bsz, L, nl, block);
    for (int i = threadIdx.x; i < nl; i += blockDim.x) {
      L.ok[i] = L.placed[i];
      L.act[i] = L.act[i] && !L.placed[i];
      L.tgt[i] = L.i2[i];
    }
    __syncthreads();
    clear_round(table, sels, khi, klo, bsz, L, nl, block);
    for (int i = threadIdx.x; i < nl; i += blockDim.x)
      ok_out[base + i] = (L.ok[i] || L.placed[i]) ? 1 : 0;
    __syncthreads();
  }
}

}  // namespace

// lane_u32: uint32[7, block] (f0..f3, i2, tgt, slot); lane_u8: uint8[3, block].
extern "C" int ocf_delete_bulk_adaptive(
    void* table, void* sels, void* khi, void* klo, int bucket_size,
    unsigned int n_buckets, const void* hi, const void* lo, const void* valid,
    void* ok, int n, int block, int fp_bits, void* lane_u32, void* lane_u8,
    void* stream) {
  if (n > 0) {
    uint32_t* u = (uint32_t*)lane_u32;
    uint8_t* b = (uint8_t*)lane_u8;
    const size_t B = (size_t)block;
    Lanes L{u, u + 4 * B, u + 5 * B, (int32_t*)(u + 6 * B), b, b + B,
            b + 2 * B};
    int threads = ((block + 31) / 32) * 32;
    if (threads > 1024) threads = 1024;
    delete_adaptive_kernel<<<1, threads, 0, (cudaStream_t)stream>>>(
        (uint32_t*)table, (uint32_t*)sels, (uint32_t*)khi, (uint32_t*)klo,
        bucket_size, n_buckets, (const uint32_t*)hi, (const uint32_t*)lo,
        (const uint8_t*)valid, (uint8_t*)ok, n, block, fp_bits, L);
  }
  return (int)cudaGetLastError();
}
