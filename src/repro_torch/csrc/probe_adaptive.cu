// probe_adaptive: fused family hash + selector-aware two-bucket membership
// test, with an optional stash.
//
// Replaces the TPU kernel repro/kernels/probe.py::probe_adaptive
// (_probe_adaptive_kernel, _probe_adaptive_stash_kernel; body
// _probe_adaptive_body).  The TPU version pins the table and the packed
// selector plane in VMEM; here both stay in device memory and each key
// gathers its two candidate buckets and their two selector words.
//
// A slot hits when it equals the key's family fingerprint under the
// slot's own selector: row[s] == fam[(word >> 2s) & 3].  Stash entries hold
// selector-0 fingerprints and match on fp0 and either candidate bucket.
// With an all-zero selector plane this is probe.cu's answer.
//
// Bound on the H100: bytes, and those are random: a key reads 8 B of key
// and writes 1 B, and each of its two bucket reads and two selector-word
// reads lands in its own 32-byte sector.  One thread per key hashes the
// four family members once; a bucket of four slots is one 16-byte load.
// No carry between keys, so the whole grid runs in parallel.  The stash
// is staged through shared memory in tiles, as in probe.cu.
#include "ocf_common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kStashTile = 1024;  // slots staged per pass: 8 KB of shared

__device__ __forceinline__ bool row_hits(const uint32_t* __restrict__ table,
                                         const uint32_t* __restrict__ sels,
                                         int bucket_size, uint32_t b,
                                         const uint32_t fam[4]) {
  const uint32_t w = sels[b];
  if (bucket_size == 4) {
    const uint4 r = reinterpret_cast<const uint4*>(table)[b];
    return r.x == fam[ocf::sel_of(w, 0)] || r.y == fam[ocf::sel_of(w, 1)] ||
           r.z == fam[ocf::sel_of(w, 2)] || r.w == fam[ocf::sel_of(w, 3)];
  }
  const uint32_t* row = table + (size_t)b * bucket_size;
  bool h = false;
  for (int s = 0; s < bucket_size; ++s) h = h || row[s] == fam[ocf::sel_of(w, s)];
  return h;
}

__global__ void probe_adaptive_kernel(const uint32_t* __restrict__ table,
                                      const uint32_t* __restrict__ sels,
                                      int bucket_size,
                                      const uint32_t* __restrict__ stash,
                                      int stash_slots,
                                      const uint32_t* __restrict__ hi,
                                      const uint32_t* __restrict__ lo,
                                      uint8_t* __restrict__ hit, int n,
                                      int fp_bits, uint32_t n_buckets) {
  __shared__ uint32_t s_fp[kStashTile];
  __shared__ uint32_t s_bkt[kStashTile];
  const int k = blockIdx.x * blockDim.x + threadIdx.x;
  const bool live = k < n;
  uint32_t fam[4] = {0u, 0u, 0u, 0u};
  uint32_t i1 = 0, i2 = 0;
  bool h = false;
  if (live) {
    ocf::fp_family(hi[k], lo[k], fp_bits, fam);
    i1 = ocf::index_hash(hi[k], lo[k], n_buckets);
    i2 = ocf::alt_index(i1, fam[0], n_buckets);
    h = row_hits(table, sels, bucket_size, i1, fam) ||
        row_hits(table, sels, bucket_size, i2, fam);
  }
  // Every thread of the CTA loads the stash tiles, so the loop runs to the
  // end even for threads past n.
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
        h = h || (s_fp[s] == fam[0] && (s_bkt[s] == i1 || s_bkt[s] == i2));
    }
  }
  if (live) hit[k] = h ? 1 : 0;
}

}  // namespace

extern "C" int ocf_probe_adaptive(const void* table, const void* sels,
                                  int bucket_size, const void* stash,
                                  int stash_slots, const void* hi,
                                  const void* lo, void* hit, int n,
                                  int fp_bits, unsigned int n_buckets,
                                  void* stream) {
  if (n > 0) {
    const int blocks = (n + kThreads - 1) / kThreads;
    probe_adaptive_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
        (const uint32_t*)table, (const uint32_t*)sels, bucket_size,
        (const uint32_t*)stash, stash ? stash_slots : 0, (const uint32_t*)hi,
        (const uint32_t*)lo, (uint8_t*)hit, n, fp_bits, n_buckets);
  }
  return (int)cudaGetLastError();
}
