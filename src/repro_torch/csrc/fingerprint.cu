// fingerprint_hash: batched (fp, i1, i2) for (hi, lo) uint32 key halves.
//
// Replaces the TPU kernel repro/kernels/fingerprint.py::fingerprint_hash
// (_fingerprint_kernel): pure per-lane uint32 mixing, no carry between
// lanes.
//
// Bound on the H100: bytes.  Each key moves 8 B in and 12 B out and costs
// ~20 integer operations, far below the card's operation rate, so the
// kernel is one thread per key with coalesced 4-byte loads and stores and
// nothing else.
#include "ocf_common.cuh"

namespace {

__global__ void fingerprint_kernel(const uint32_t* __restrict__ hi,
                                   const uint32_t* __restrict__ lo,
                                   uint32_t* __restrict__ fp,
                                   uint32_t* __restrict__ i1,
                                   uint32_t* __restrict__ i2, int n,
                                   int fp_bits, uint32_t n_buckets) {
  const int k = blockIdx.x * blockDim.x + threadIdx.x;
  if (k >= n) return;
  const uint32_t f = ocf::fingerprint(hi[k], lo[k], fp_bits);
  const uint32_t h = ocf::index_hash(hi[k], lo[k], n_buckets);
  fp[k] = f;
  i1[k] = h;
  i2[k] = ocf::alt_index(h, f, n_buckets);
}

}  // namespace

extern "C" int ocf_fingerprint_hash(const void* hi, const void* lo, void* fp,
                                    void* i1, void* i2, int n, int fp_bits,
                                    unsigned int n_buckets, void* stream) {
  if (n > 0) {
    const int threads = 256;
    const int blocks = (n + threads - 1) / threads;
    fingerprint_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
        (const uint32_t*)hi, (const uint32_t*)lo, (uint32_t*)fp,
        (uint32_t*)i1, (uint32_t*)i2, n, fp_bits, n_buckets);
  }
  return (int)cudaGetLastError();
}
