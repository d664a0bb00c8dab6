// probe: fused hash + two-bucket membership test, with an optional stash.
//
// Replaces the TPU kernel repro/kernels/probe.py::probe (_probe_kernel,
// _probe_stash_kernel; body _probe_body).  The TPU version pins the whole
// table in VMEM; here the table stays in device memory and each key
// gathers its candidate buckets.
//
// Bound on the H100: bytes, and those are random.  A key reads 8 B of key
// and writes 1 B of answer, and each bucket it reads lands in its own
// 32-byte sector.  Its serving paths launch it with 4096 keys (the OCF's
// chunks, the filter-op waves) and with 2^17-2^19 keys (the SLO
// scenarios' waves, against stashes of 32-128 slots), up to twice the
// 132 x 2048 threads the card holds at once.  The design, from
// tools/probe_probe.py on an H100 80GB HBM3 at 700 W (device times of a
// launch, the 16 MB table warm in L2 unless said otherwise):
//
// * The alternate bucket only for keys the home bucket did not answer, in
//   launches of more than kEagerKeys keys: a member found at home fetches
//   one sector, not two, and from 65536 keys the sectors fetched, not
//   their latency, hold the launch (issuing both loads first cost 10-41%
//   more, 4-10% with the L2 flushed).  Smaller launches, which do not fill
//   the card, issue both loads of a key at once, one round trip for an
//   absent key (5-12% faster at 4096 and 16384 keys, 8% flushed).  The
//   choice is one flag a launch, the same for every thread.
// * The stash through the prefilter of stash_prefilter.cuh, as
//   probe_multi and probe_adaptive check theirs: each CTA lists the live
//   entries and sets their fingerprints' 16-bit folds in a map, and a key
//   the buckets did not answer walks the list, with its warp, only where
//   its bit is set.  No thread scans stash slots.  An empty stash costs
//   each CTA one staging pass over its slots and no clearing of the map;
//   a launch without a stash stages nothing.  A scan of every slot by
//   every key the buckets missed cost 3.1-3.7x with an empty 128-slot
//   stash.
// * One key a thread, one CTA a tile of 128 keys, the same code for every
//   launch size: two keys a thread or 64-thread CTAs were slower, and
//   256-thread CTAs gained only where every stash slot was live (1-3%).
//
// Bucket sizes other than 4 take a row loop.  No carry between keys: the
// answer is per key, and the logical block of the reference only shapes
// the call.
//
// Telemetry (kTm, the twin ocf_probe_tm): the order above already shows
// which stage answered a key (home bucket, alternate bucket, the
// stash, or none), so each of the first n_count keys is counted there,
// summed per warp by ballots, per CTA in shared memory, and added to the
// four-counter plane with one atomicAdd a CTA and counter.  Sums do not
// depend on the order of threads or CTAs, so they are exact.  The
// flag-off instantiation is the kernel without telemetry.
#include "ocf_common.cuh"
#include "stash_prefilter.cuh"

namespace {

// Threads a CTA, one key a thread (tools/probe_probe.py builds the other
// shapes).
constexpr int kThreads = 128;
static_assert(kThreads % 32 == 0, "a CTA runs whole warps");
// Launches of at most kEagerKeys keys load both buckets of a key at once.
constexpr int kEagerKeys = 16384;
using Keys = stash_pf::Keys<1>;

__device__ __forceinline__ bool has4(uint4 v, uint32_t fp) {
  return v.x == fp || v.y == fp || v.z == fp || v.w == fp;
}

// Row b of a table of bucket_size slots holds fp.
__device__ __forceinline__ bool row_has(const uint32_t* __restrict__ table,
                                        int bucket_size, uint32_t b,
                                        uint32_t fp) {
  const uint32_t* row = table + (size_t)b * bucket_size;
  bool h = false;
  for (int s = 0; s < bucket_size; ++s) h |= __ldg(row + s) == fp;
  return h;
}

template <bool kVec, bool kTm>
__global__ void __launch_bounds__(kThreads)
    probe_kernel(const uint32_t* __restrict__ table, int bucket_size,
                 const uint32_t* __restrict__ stash, int stash_slots,
                 const uint32_t* __restrict__ hi,
                 const uint32_t* __restrict__ lo, uint8_t* __restrict__ hit,
                 int n, int fp_bits, uint32_t n_buckets, int list_cap,
                 uint32_t* __restrict__ plane, int n_count) {
  extern __shared__ __align__(16) uint32_t smem[];
  __shared__ uint8_t s_slot[1];
  __shared__ int s_counts[2];
  if (threadIdx.x == 0) {
    s_slot[0] = 0;
    s_counts[0] = 0;
  }
  const uint4* rows = reinterpret_cast<const uint4*>(table);
  const int k = blockIdx.x * kThreads + threadIdx.x;
  const bool eager = n <= kEagerKeys;
  Keys ks;
  ks.live[0] = k < n;
  ks.h[0] = false;
  ks.fp[0] = ks.i1[0] = ks.i2[0] = 0u;
  uint4 home = make_uint4(0u, 0u, 0u, 0u), alt = home;
  if (ks.live[0]) {
    const uint32_t h32 = __ldg(hi + k), l32 = __ldg(lo + k);
    ks.fp[0] = ocf::fingerprint(h32, l32, fp_bits);
    ks.i1[0] = ocf::index_hash(h32, l32, n_buckets);
    ks.i2[0] = ocf::alt_index(ks.i1[0], ks.fp[0], n_buckets);
    // The bucket loads are out while the stash is staged.
    if (kVec) {
      home = __ldg(rows + ks.i1[0]);
      if (eager) alt = __ldg(rows + ks.i2[0]);
    }
  }
  // Every thread of the CTA stages and walks, live key or not: the
  // staging's barriers and the walk's warp votes need them all.
  int count = 0, pass = 0;
  if (stash_slots > 0)
    count = stash_pf::stage_pass(stash, stash_slots, s_slot, 0, list_cap,
                                 smem, list_cap, s_counts, pass++ & 1);
  bool h1 = false;  // answered by the home bucket
  if (ks.live[0]) {
    const uint32_t fp = ks.fp[0];
    h1 = kVec ? has4(home, fp) : row_has(table, bucket_size, ks.i1[0], fp);
    ks.h[0] = h1 || (kVec ? has4(eager ? alt : __ldg(rows + ks.i2[0]), fp)
                          : row_has(table, bucket_size, ks.i2[0], fp));
  }
  const bool hb = ks.h[0];  // answered by a bucket
  if (stash_slots > 0) {
    if (count > 0) stash_pf::probe_list(smem, list_cap, count, ks);
    // More slots than one pass holds: the rest, a pass at a time.
    for (int base = list_cap; base < stash_slots; base += list_cap) {
      count = stash_pf::stage_pass(stash, stash_slots, s_slot, base,
                                   min(base + list_cap, stash_slots), smem,
                                   list_cap, s_counts, pass++ & 1);
      if (count > 0) stash_pf::probe_list(smem, list_cap, count, ks);
    }
  }
  if (ks.live[0]) hit[k] = ks.h[0] ? 1 : 0;
  if constexpr (kTm) {
    // Depth d of a key: 0 home, 1 alternate, 2 stash, 3 miss.
    __shared__ uint32_t s_depth[4];
    if (threadIdx.x < 4) s_depth[threadIdx.x] = 0u;
    __syncthreads();
    const bool counted = k < n_count;
    const int d = h1 ? 0 : hb ? 1 : ks.h[0] ? 2 : 3;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const uint32_t m = __ballot_sync(0xFFFFFFFFu, counted && d == j);
      if ((threadIdx.x & 31) == 0 && m) atomicAdd(&s_depth[j], __popc(m));
    }
    __syncthreads();
    if (threadIdx.x < 4 && s_depth[threadIdx.x])
      atomicAdd(&plane[threadIdx.x], s_depth[threadIdx.x]);
  }
}

template <bool kVec, bool kTm>
void launch(const void* table, int bucket_size, const void* stash,
            int stash_slots, const void* hi, const void* lo, void* hit, int n,
            int fp_bits, unsigned int n_buckets, void* plane, int n_count,
            cudaStream_t stream) {
  const int list_cap = min(stash_slots, stash_pf::kList);
  const int smem = stash_slots > 0 ? stash_pf::smem_bytes(list_cap) : 0;
  probe_kernel<kVec, kTm><<<(n + kThreads - 1) / kThreads, kThreads, smem,
                            stream>>>(
      (const uint32_t*)table, bucket_size, (const uint32_t*)stash,
      stash_slots, (const uint32_t*)hi, (const uint32_t*)lo, (uint8_t*)hit,
      n, fp_bits, n_buckets, list_cap, (uint32_t*)plane, n_count);
}

template <bool kTm>
int dispatch(const void* table, int bucket_size, const void* stash,
             int stash_slots, const void* hi, const void* lo, void* hit,
             int n, int fp_bits, unsigned int n_buckets, void* plane,
             int n_count, void* stream) {
  if (n > 0)
    (bucket_size == 4 ? &launch<true, kTm> : &launch<false, kTm>)(
        table, bucket_size, stash, stash ? stash_slots : 0, hi, lo, hit, n,
        fp_bits, n_buckets, plane, n_count, (cudaStream_t)stream);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int ocf_probe(const void* table, int bucket_size,
                         const void* stash, int stash_slots, const void* hi,
                         const void* lo, void* hit, int n, int fp_bits,
                         unsigned int n_buckets, void* stream) {
  return dispatch<false>(table, bucket_size, stash, stash_slots, hi, lo, hit,
                         n, fp_bits, n_buckets, nullptr, 0, stream);
}

// The telemetry twin: ``plane`` is four zeroed uint32 counters (home,
// alternate, stash, miss) that the launch adds the first n_count keys to.
extern "C" int ocf_probe_tm(const void* table, int bucket_size,
                            const void* stash, int stash_slots,
                            const void* hi, const void* lo, void* hit, int n,
                            int fp_bits, unsigned int n_buckets, void* plane,
                            int n_count, void* stream) {
  return dispatch<true>(table, bucket_size, stash, stash_slots, hi, lo, hit,
                        n, fp_bits, n_buckets, plane, n_count, stream);
}
