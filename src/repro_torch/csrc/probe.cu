// probe: fused hash + two-bucket membership test, with an optional stash.
//
// Replaces the TPU kernel repro/kernels/probe.py::probe (_probe_kernel,
// _probe_stash_kernel; body _probe_body).  The TPU version pins the whole
// table in VMEM; here the table stays in device memory and each key
// gathers its two candidate buckets.
//
// Bound on the H100: bytes, and those are random.  A key reads 8 B of key
// and writes 1 B of answer, but each of its two bucket reads lands in its
// own 32-byte sector.  One thread per key; a bucket of four uint32 slots is
// one 16-byte load.  There is no carry between keys, so the whole grid
// runs in parallel.  With a stash, every CTA stages it through shared
// memory in tiles and each thread scans it (the stash is a few KB).
#include "ocf_common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kStashTile = 1024;  // slots staged per pass: 8 KB of shared

__global__ void probe_kernel(const uint32_t* __restrict__ table,
                             int bucket_size,
                             const uint32_t* __restrict__ stash,
                             int stash_slots,
                             const uint32_t* __restrict__ hi,
                             const uint32_t* __restrict__ lo,
                             uint8_t* __restrict__ hit, int n, int fp_bits,
                             uint32_t n_buckets) {
  __shared__ uint32_t s_fp[kStashTile];
  __shared__ uint32_t s_bkt[kStashTile];
  const int k = blockIdx.x * blockDim.x + threadIdx.x;
  const bool live = k < n;
  uint32_t fp = 0, i1 = 0, i2 = 0;
  bool h = false;
  if (live) {
    fp = ocf::fingerprint(hi[k], lo[k], fp_bits);
    i1 = ocf::index_hash(hi[k], lo[k], n_buckets);
    i2 = ocf::alt_index(i1, fp, n_buckets);
    if (bucket_size == 4) {
      const uint4 b1 = reinterpret_cast<const uint4*>(table)[i1];
      const uint4 b2 = reinterpret_cast<const uint4*>(table)[i2];
      h = b1.x == fp || b1.y == fp || b1.z == fp || b1.w == fp ||
          b2.x == fp || b2.y == fp || b2.z == fp || b2.w == fp;
    } else {
      const uint32_t* r1 = table + (size_t)i1 * bucket_size;
      const uint32_t* r2 = table + (size_t)i2 * bucket_size;
      for (int s = 0; s < bucket_size; ++s)
        h = h || r1[s] == fp || r2[s] == fp;
    }
  }
  // The stash tiles are loaded by every thread of the CTA, so the loop runs
  // to the end even for threads past n.
  for (int base = 0; base < stash_slots; base += kStashTile) {
    const int m = min(kStashTile, stash_slots - base);
    __syncthreads();
    for (int s = threadIdx.x; s < m; s += blockDim.x) {
      s_fp[s] = stash[base + s];
      s_bkt[s] = stash[stash_slots + base + s];
    }
    __syncthreads();
    if (live && !h) {
      for (int s = 0; s < m; ++s)
        h = h || (s_fp[s] == fp && (s_bkt[s] == i1 || s_bkt[s] == i2));
    }
  }
  if (live) hit[k] = h ? 1 : 0;
}

}  // namespace

extern "C" int ocf_probe(const void* table, int bucket_size,
                         const void* stash, int stash_slots, const void* hi,
                         const void* lo, void* hit, int n, int fp_bits,
                         unsigned int n_buckets, void* stream) {
  if (n > 0) {
    const int blocks = (n + kThreads - 1) / kThreads;
    probe_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
        (const uint32_t*)table, bucket_size, (const uint32_t*)stash,
        stash ? stash_slots : 0, (const uint32_t*)hi, (const uint32_t*)lo,
        (uint8_t*)hit, n, fp_bits, n_buckets);
  }
  return (int)cudaGetLastError();
}
