// probe_multi: membership across the live ones of K filter generations,
// hashing each key once, with an optional stash per generation.
//
// Replaces the TPU kernel repro/kernels/probe.py::probe_multi
// (_probe_multi_kernel, _probe_multi_stash_kernel).  The TPU version runs
// a (blocks, K) grid and ORs each generation's whole-table probe into a
// revisited output block; here one thread per key hashes once and walks
// the K generations itself, so nothing carries between thread blocks.
//
// Bound on the H100: bytes, and those are random.  A key reads 8 B of key
// and writes 1 B of answer; per generation, in order, it reads its home
// bucket's 32-byte sector and the alternate bucket's only where the home
// misses, and stops at the first hit.  The K stashes (a few KB) are staged
// through shared memory in tiles, each generation's (fp, bucket) rows in
// turn, and scanned by every key the tables did not answer.
//
// The K tables and stashes are the generation ring's pool as it stands:
// bit g of gen_mask says whether slot g holds a live generation.  The
// answer is an OR over generations, so their order does not change it.
#include "ocf_common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kStashTile = 1024;  // entries staged per pass: 8 KB of shared

__device__ __forceinline__ bool bucket_has(const uint32_t* table,
                                           int bucket_size, uint32_t b,
                                           uint32_t fp) {
  if (bucket_size == 4) {
    const uint4 v = reinterpret_cast<const uint4*>(table)[b];
    return v.x == fp || v.y == fp || v.z == fp || v.w == fp;
  }
  const uint32_t* row = table + (size_t)b * bucket_size;
  for (int s = 0; s < bucket_size; ++s)
    if (row[s] == fp) return true;
  return false;
}

// Slot of the r-th live generation (the r-th set bit of mask).
__device__ __forceinline__ int nth_gen(unsigned long long mask, int r) {
  for (int g = 0;; ++g)
    if (((mask >> g) & 1ull) && r-- == 0) return g;
}

__global__ void probe_multi_kernel(const uint32_t* __restrict__ tables,
                                   int k_gens, unsigned long long gen_mask,
                                   int buffer_buckets,
                                   int bucket_size,
                                   const uint32_t* __restrict__ stashes,
                                   int stash_slots,
                                   const uint32_t* __restrict__ hi,
                                   const uint32_t* __restrict__ lo,
                                   uint8_t* __restrict__ hit, int n,
                                   int fp_bits, uint32_t n_buckets) {
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
    const size_t stride = (size_t)buffer_buckets * bucket_size;
    for (int g = 0; g < k_gens && !h; ++g) {
      if (!((gen_mask >> g) & 1ull)) continue;
      const uint32_t* table = tables + g * stride;
      h = bucket_has(table, bucket_size, i1, fp) ||
          bucket_has(table, bucket_size, i2, fp);
    }
  }
  // The live stashes as one run of L * S entries: entry e is slot e % S
  // of the (e / S)-th live generation g, whose fp row starts at
  // stashes + g * 2S and bucket row at + S.  Every thread of the CTA loads
  // the tiles, so the loop runs to the end even for threads past n.
  const int total = __popcll(gen_mask) * stash_slots;
  for (int base = 0; base < total; base += kStashTile) {
    const int m = min(kStashTile, total - base);
    __syncthreads();
    for (int s = threadIdx.x; s < m; s += blockDim.x) {
      const int r = (base + s) / stash_slots;
      const int j = (base + s) - r * stash_slots;
      const int g = nth_gen(gen_mask, r);
      const uint32_t* st = stashes + (size_t)g * 2 * stash_slots;
      s_fp[s] = st[j];
      s_bkt[s] = st[stash_slots + j];
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

extern "C" int ocf_probe_multi(const void* tables, int k_gens,
                               unsigned long long gen_mask,
                               int buffer_buckets, int bucket_size,
                               const void* stashes, int stash_slots,
                               const void* hi, const void* lo, void* hit,
                               int n, int fp_bits, unsigned int n_buckets,
                               void* stream) {
  if (n > 0) {
    const int blocks = (n + kThreads - 1) / kThreads;
    probe_multi_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
        (const uint32_t*)tables, k_gens, gen_mask, buffer_buckets, bucket_size,
        (const uint32_t*)stashes, stashes ? stash_slots : 0,
        (const uint32_t*)hi, (const uint32_t*)lo, (uint8_t*)hit, n, fp_bits,
        n_buckets);
  }
  return (int)cudaGetLastError();
}
