// fingerprint_hash_family: the selector family (f0, f1, f2, f3) and the
// bucket pair (i1, i2) of (hi, lo) uint32 key halves.
//
// Replaces the TPU kernel repro/kernels/fingerprint.py::
// fingerprint_hash_family (_family_kernel; body _family_body): pure
// per-lane uint32 mixing, no carry between lanes.  f0 is fingerprint_hash's
// fp bit for bit, and i1/i2 come from f0.
//
// Bound on the H100: bytes.  Each key moves 8 B in and 24 B out and costs
// about 90 integer operations, far below the card's operation rate, so the
// kernel is one thread per key with coalesced 4-byte loads and stores into
// six rows of one [6, N] output.
#include "ocf_common.cuh"

namespace {

__global__ void family_kernel(const uint32_t* __restrict__ hi,
                              const uint32_t* __restrict__ lo,
                              uint32_t* __restrict__ out, int n, int fp_bits,
                              uint32_t n_buckets) {
  const int k = blockIdx.x * blockDim.x + threadIdx.x;
  if (k >= n) return;
  const uint32_t h = hi[k], l = lo[k];
  uint32_t fam[4];
  ocf::fp_family(h, l, fp_bits, fam);
  const uint32_t i1 = ocf::index_hash(h, l, n_buckets);
  for (int s = 0; s < 4; ++s) out[(size_t)s * n + k] = fam[s];
  out[(size_t)4 * n + k] = i1;
  out[(size_t)5 * n + k] = ocf::alt_index(i1, fam[0], n_buckets);
}

}  // namespace

// out: uint32[6, n] — rows f0, f1, f2, f3, i1, i2.
extern "C" int ocf_fingerprint_hash_family(const void* hi, const void* lo,
                                           void* out, int n, int fp_bits,
                                           unsigned int n_buckets,
                                           void* stream) {
  if (n > 0) {
    const int threads = 256;
    const int blocks = (n + threads - 1) / threads;
    family_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
        (const uint32_t*)hi, (const uint32_t*)lo, (uint32_t*)out, n, fp_bits,
        n_buckets);
  }
  return (int)cudaGetLastError();
}
