// probe_multi: membership across the live ones of K filter generations,
// hashing each key once, with an optional stash per generation.
//
// Replaces the TPU kernel repro/kernels/probe.py::probe_multi
// (_probe_multi_kernel, _probe_multi_stash_kernel).  The TPU version runs
// a (blocks, K) grid and ORs each generation's whole-table probe into a
// revisited output block; here a thread hashes its key once and walks the
// K generations itself, so nothing carries between thread blocks.
//
// Bound on the H100: bytes, and those are random.  A key reads 8 B of key
// and writes 1 B of answer, and per live generation its home and alternate
// buckets, each in its own 32-byte sector.  The design serves that:
//
// * Tables: one memory round trip.  A thread issues the home and the
//   alternate 16-byte bucket loads of up to kGroup live generations before
//   it compares any of them, so an absent key waits for one random read,
//   not 2 K dependent ones.  More live generations are taken kGroup at a
//   time, skipping the keys already answered.  Bucket sizes other than 4
//   take a row loop.
// * Stashes: the prefilter of stash_prefilter.cuh.  Each CTA stages the
//   live stashes once into a compact list of their live entries and a map
//   of their fingerprints' 16-bit folds; a key the tables did not answer
//   reads its bit, and only if it is set does its warp walk the list.  So
//   most keys pay one shared load instead of a scan of every stash slot.
//   The staging's L2 reads are issued after the bucket loads and overlap
//   them.  A launch admits 64 slots x S entries; more than kList source
//   entries are staged kList at a time, each pass with a fresh map.
//
// The K tables and stashes are the generation ring's pool as it stands:
// bit g of gen_mask says whether slot g holds a live generation.  The
// answer is an OR over generations, so their order does not change it.
// A pool of more than 64 slots is probed 64 slots a launch: with
// ``accumulate`` a launch ORs into ``hit`` and skips the keys already
// answered.
#include "ocf_common.cuh"
#include "stash_prefilter.cuh"

namespace {

// The CTA and keys a thread: 128 x 1 is the fastest on the H100 of the
// shapes tools/probe_multi_probe.py builds (64, 128, 256 threads x 1, 2).
constexpr int kThreads = 128;
constexpr int kKeys = 1;
static_assert(kThreads >= 64 && kThreads % 32 == 0,
              "a CTA fills the 64-entry slot table and runs whole warps");
static_assert(kKeys == 1 || kKeys == 2, "1 or 2 keys a thread");
// Live generations whose bucket loads a thread has in flight at once.
constexpr int kGroup = 8 / kKeys;
constexpr int kList = stash_pf::kList;
using Keys = stash_pf::Keys<kKeys>;

__device__ __forceinline__ bool has4(uint4 v, uint32_t fp) {
  return v.x == fp || v.y == fp || v.z == fp || v.w == fp;
}

__device__ __forceinline__ bool row_has(const uint32_t* row, int bucket_size,
                                        uint32_t fp) {
  for (int s = 0; s < bucket_size; ++s)
    if (row[s] == fp) return true;
  return false;
}

// One group of up to kGroup live generations: their tables and, on the
// bucket-size-4 path, both buckets of every key, loaded before any compare.
struct Group {
  int cnt;
  const uint32_t* tab[kGroup];
  uint4 a[kKeys][kGroup], b[kKeys][kGroup];
};

// Take the next kGroup live slots from ``rest``; with kVec, issue the
// loads of both buckets of every key still unanswered.
template <bool kVec>
__device__ __forceinline__ void issue(Group& gr, unsigned long long& rest,
                                      const uint32_t* tables, size_t stride,
                                      const Keys& ks) {
  gr.cnt = 0;
#pragma unroll
  for (int t = 0; t < kGroup; ++t) {
    if (rest) {
      gr.tab[t] = tables + (size_t)(__ffsll((long long)rest) - 1) * stride;
      rest &= rest - 1;
      gr.cnt = t + 1;
    }
  }
  if (!kVec) return;
#pragma unroll
  for (int q = 0; q < kKeys; ++q) {
#pragma unroll
    for (int t = 0; t < kGroup; ++t) {
      if (t < gr.cnt && ks.live[q] && !ks.h[q]) {
        const uint4* rows = reinterpret_cast<const uint4*>(gr.tab[t]);
        gr.a[q][t] = __ldg(rows + ks.i1[q]);
        gr.b[q][t] = __ldg(rows + ks.i2[q]);
      }
    }
  }
}

template <bool kVec>
__device__ __forceinline__ void compare(const Group& gr, int bucket_size,
                                        Keys& ks) {
#pragma unroll
  for (int q = 0; q < kKeys; ++q) {
    if (!ks.live[q] || ks.h[q]) continue;
    bool h = false;
#pragma unroll
    for (int t = 0; t < kGroup; ++t) {
      if (t >= gr.cnt) break;
      if (kVec) {
        h |= has4(gr.a[q][t], ks.fp[q]) | has4(gr.b[q][t], ks.fp[q]);
      } else if (!h) {
        h = row_has(gr.tab[t] + (size_t)ks.i1[q] * bucket_size, bucket_size,
                    ks.fp[q]) ||
            row_has(gr.tab[t] + (size_t)ks.i2[q] * bucket_size, bucket_size,
                    ks.fp[q]);
      }
    }
    ks.h[q] = h;
  }
}

template <bool kVec>
__global__ void __launch_bounds__(kThreads)
    probe_multi_kernel(const uint32_t* __restrict__ tables,
                       unsigned long long gen_mask, int buffer_buckets,
                       int bucket_size,
                       const uint32_t* __restrict__ stashes, int stash_slots,
                       const uint32_t* __restrict__ hi,
                       const uint32_t* __restrict__ lo,
                       uint8_t* __restrict__ hit, int n, int fp_bits,
                       uint32_t n_buckets, int accumulate) {
  extern __shared__ __align__(16) uint32_t smem[];
  __shared__ uint8_t s_slot[64];
  __shared__ int s_counts[2];

  Keys ks;
  const int k0 = blockIdx.x * (kKeys * kThreads) + threadIdx.x;
#pragma unroll
  for (int q = 0; q < kKeys; ++q) {
    const int k = k0 + q * kThreads;
    ks.live[q] = k < n;
    ks.h[q] = ks.live[q] && accumulate && hit[k] != 0;
    ks.fp[q] = ks.i1[q] = ks.i2[q] = 0;
    if (ks.live[q]) {
      const uint32_t h32 = hi[k], l32 = lo[k];
      ks.fp[q] = ocf::fingerprint(h32, l32, fp_bits);
      ks.i1[q] = ocf::index_hash(h32, l32, n_buckets);
      ks.i2[q] = ocf::alt_index(ks.i1[q], ks.fp[q], n_buckets);
    }
  }
  const size_t stride = (size_t)buffer_buckets * bucket_size;
  unsigned long long rest = gen_mask;
  Group gr;
  issue<kVec>(gr, rest, tables, stride, ks);

  // Stage the first pass of the stashes while the bucket loads are out.
  // Every thread of the CTA stages, so this runs for threads past n too.
  const int total = __popcll(gen_mask) * stash_slots;
  int count = 0;
  if (total > 0) {
    if (threadIdx.x < 64 && ((gen_mask >> threadIdx.x) & 1ull))
      s_slot[__popcll(gen_mask & ((1ull << threadIdx.x) - 1ull))] =
          (uint8_t)threadIdx.x;
    if (threadIdx.x == 0) s_counts[0] = 0;
    count = stash_pf::stage_pass(stashes, stash_slots, s_slot, 0,
                                 min(kList, total), smem, kList, s_counts, 0);
  }

  compare<kVec>(gr, bucket_size, ks);
  for (;;) {
    bool todo = false;
#pragma unroll
    for (int q = 0; q < kKeys; ++q) todo |= ks.live[q] && !ks.h[q];
    if (!rest || !todo) break;
    issue<kVec>(gr, rest, tables, stride, ks);
    compare<kVec>(gr, bucket_size, ks);
  }

  for (int base = 0, pass = 0; base < total; base += kList, ++pass) {
    if (pass > 0)
      count = stash_pf::stage_pass(stashes, stash_slots, s_slot, base,
                                   min(base + kList, total), smem, kList,
                                   s_counts, pass & 1);
    if (count > 0) stash_pf::probe_list(smem, kList, count, ks);
  }

#pragma unroll
  for (int q = 0; q < kKeys; ++q)
    if (ks.live[q]) hit[k0 + q * kThreads] = ks.h[q] ? 1 : 0;
}

}  // namespace

extern "C" int ocf_probe_multi(const void* tables, int k_gens,
                               unsigned long long gen_mask,
                               int buffer_buckets, int bucket_size,
                               const void* stashes, int stash_slots,
                               const void* hi, const void* lo, void* hit,
                               int n, int fp_bits, unsigned int n_buckets,
                               int accumulate, void* stream) {
  if (n <= 0) return (int)cudaGetLastError();
  if (k_gens < 64) gen_mask &= (1ull << k_gens) - 1ull;
  if (!stashes) stash_slots = 0;
  const int blocks = (n + kKeys * kThreads - 1) / (kKeys * kThreads);
  const int smem =
      (gen_mask && stash_slots > 0) ? stash_pf::smem_bytes(kList) : 0;
  cudaStream_t st = (cudaStream_t)stream;
  if (bucket_size == 4) {
    probe_multi_kernel<true><<<blocks, kThreads, smem, st>>>(
        (const uint32_t*)tables, gen_mask, buffer_buckets, bucket_size,
        (const uint32_t*)stashes, stash_slots, (const uint32_t*)hi,
        (const uint32_t*)lo, (uint8_t*)hit, n, fp_bits, n_buckets,
        accumulate);
  } else {
    probe_multi_kernel<false><<<blocks, kThreads, smem, st>>>(
        (const uint32_t*)tables, gen_mask, buffer_buckets, bucket_size,
        (const uint32_t*)stashes, stash_slots, (const uint32_t*)hi,
        (const uint32_t*)lo, (uint8_t*)hit, n, fp_bits, n_buckets,
        accumulate);
  }
  return (int)cudaGetLastError();
}
