// delete_bulk: fused hash + first-match-slot bulk delete.
//
// Replaces the TPU kernel repro/kernels/delete.py::_delete_bulk_impl
// (_delete_kernel; body _delete_body, _clear_round).
//
// What the result depends on, and how this kernel keeps it:
//   * Logical blocks run IN ORDER with the table carried between them (the
//     TPU's sequential grid), so this is ONE CTA looping over the blocks.
//   * Within a block, ALL home-bucket attempts run before ALL
//     alternate-bucket attempts (the reference's order; see its "Parity
//     caveat").  Each attempt is a round with simultaneous-write
//     semantics: compute, __syncthreads(), write, __syncthreads().
//   * Duplicates are ranked by (bucket, fingerprint) among earlier active
//     lanes, so the k-th duplicate clears the k-th matching slot and
//     duplicates past the resident count report False.
//
// Bound on the H100: the serialized single-CTA loop (two rounds per
// logical block, each with two CTA-wide barriers and an O(block) rank
// count per lane), not the bytes moved.
#include "ocf_common.cuh"

namespace {

// One clear attempt: each act lane zeroes the rank-th slot of its tgt
// bucket that holds its fingerprint, when there is one.
__device__ void clear_round(uint32_t* table, int bsz, const uint32_t* fp,
                            const uint32_t* tgt, uint8_t* act, int32_t* slot,
                            uint8_t* placed, int nl) {
  for (int i = threadIdx.x; i < nl; i += blockDim.x) {
    int s = -1;
    if (act[i]) {
      const int r = ocf::rank_among_earlier(i, tgt, act, fp);
      s = ocf::nth_slot_equal(table + (size_t)tgt[i] * bsz, bsz, fp[i], r);
    }
    slot[i] = s;
  }
  __syncthreads();
  for (int i = threadIdx.x; i < nl; i += blockDim.x) {
    if (slot[i] >= 0) table[(size_t)tgt[i] * bsz + slot[i]] = 0u;
    placed[i] = slot[i] >= 0 ? 1 : 0;
  }
  __syncthreads();
}

__global__ void delete_kernel(uint32_t* table, int bsz, uint32_t n_buckets,
                              const uint32_t* hi, const uint32_t* lo,
                              const uint8_t* valid, uint8_t* ok_out, int n,
                              int block, int fp_bits, uint32_t* fp,
                              uint32_t* i2, uint32_t* tgt, int32_t* slot,
                              uint8_t* act, uint8_t* placed, uint8_t* ok) {
  for (int base = 0; base < n; base += block) {
    const int nl = min(block, n - base);
    for (int i = threadIdx.x; i < nl; i += blockDim.x) {
      const uint32_t h = hi[base + i], l = lo[base + i];
      const uint32_t f = ocf::fingerprint(h, l, fp_bits);
      const uint32_t i1 = ocf::index_hash(h, l, n_buckets);
      fp[i] = f;
      i2[i] = ocf::alt_index(i1, f, n_buckets);
      tgt[i] = i1;
      act[i] = valid[base + i] ? 1 : 0;
    }
    __syncthreads();
    clear_round(table, bsz, fp, tgt, act, slot, placed, nl);
    for (int i = threadIdx.x; i < nl; i += blockDim.x) {
      ok[i] = placed[i];
      act[i] = act[i] && !placed[i];
      tgt[i] = i2[i];
    }
    __syncthreads();
    clear_round(table, bsz, fp, tgt, act, slot, placed, nl);
    for (int i = threadIdx.x; i < nl; i += blockDim.x)
      ok_out[base + i] = (ok[i] || placed[i]) ? 1 : 0;
    __syncthreads();
  }
}

}  // namespace

// lane_u32: uint32[4, block]; lane_u8: uint8[3, block].
extern "C" int ocf_delete_bulk(void* table, int bucket_size,
                               unsigned int n_buckets, const void* hi,
                               const void* lo, const void* valid, void* ok,
                               int n, int block, int fp_bits,
                               void* lane_u32, void* lane_u8, void* stream) {
  if (n > 0) {
    uint32_t* u = (uint32_t*)lane_u32;
    uint8_t* b = (uint8_t*)lane_u8;
    int threads = ((block + 31) / 32) * 32;
    if (threads > 1024) threads = 1024;
    delete_kernel<<<1, threads, 0, (cudaStream_t)stream>>>(
        (uint32_t*)table, bucket_size, n_buckets, (const uint32_t*)hi,
        (const uint32_t*)lo, (const uint8_t*)valid, (uint8_t*)ok, n, block,
        fp_bits, u, u + block, u + 2 * (size_t)block,
        (int32_t*)(u + 3 * (size_t)block), b, b + block,
        b + 2 * (size_t)block);
  }
  return (int)cudaGetLastError();
}
