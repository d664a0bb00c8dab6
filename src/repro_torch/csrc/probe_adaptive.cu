// probe_adaptive: fused family hash + selector-aware two-bucket membership
// test, with an optional stash.
//
// Replaces the TPU kernel repro/kernels/probe.py::probe_adaptive
// (_probe_adaptive_kernel, _probe_adaptive_stash_kernel; body
// _probe_adaptive_body).  The TPU version pins the table and the packed
// selector plane in VMEM; here both stay in device memory.
//
// A slot hits when it equals the key's family fingerprint under the
// slot's own selector: row[s] == fam[(word >> 2s) & 3].  Stash entries hold
// selector-0 fingerprints and match on fam[0] and either candidate bucket.
// With an all-zero selector plane this is probe.cu's answer.
//
// Bound on the H100: bytes, and those are random.  The adaptive path calls
// it with 9-12M keys a launch on a 2^22-bucket table (64 MB), a 16 MB
// selector plane and a 128-slot stash.  A key reads 8 B of key and writes
// 1 B, and its rows and selector words, each in its own 32-byte sector.
// At that size the launch is held by the number of random sectors it
// fetches (~45-50G a second on the H100, tools/probe_adaptive_probe.py),
// not by their latency: enough keys are in flight at full occupancy.  So
// the kernel fetches as few sectors a key as an exact answer allows:
//
// * Selector words only where they can matter.  Each row's slots are first
//   compared against all four family fingerprints (a 4-bit mask a slot).
//   A slot can hit only where it equals some fam[j], so a row with an
//   empty mask misses whatever its word says: nearly every row of an
//   absent key at fp_bits 16.  Only rows with a nonzero mask load their
//   selector word, and a slot hits where its mask has the bit of its
//   selector.  Loading every row's word cost 1.75x on absent keys.
// * The alternate row only for keys the home row did not answer: a member
//   found at home fetches two sectors (its row and its word), not three,
//   and an absent key two either way.  Issuing both rows before any
//   compare was as fast for absent keys and 1.6x slower for members.
//
// Bucket sizes other than 4 take a row loop.  The stash goes through the
// prefilter of stash_prefilter.cuh: no thread scans slots.  A key the
// buckets did not answer reads one bit of a map of the live entries'
// fingerprint folds; an empty stash costs each CTA one staging pass and no
// walk.  One CTA a tile of kThreads keys: a persistent grid of SMs x
// resident CTAs, each staging the stash once, was 3-4% slower at 10M keys
// (the hardware balances the SMs, and the staging it saves cost nothing
// visible: an empty stash skips the map).
//
// No carry between keys: the answer is per key, and the logical block of
// the reference only shapes the call.
//
// Telemetry (kTm, the twin ocf_probe_adaptive_tm): the lazy order above
// already shows which stage answered a key (home row, alternate row, the
// stash prefilter, or none), so each of the first n_count keys is counted
// there, summed per warp by ballots, per CTA in shared memory, and added
// to the four-counter plane with one atomicAdd a CTA and counter.  The
// flag-off instantiation is the kernel without telemetry.
#include "ocf_common.cuh"
#include "stash_prefilter.cuh"

namespace {

// Threads a CTA, one key each (tools/probe_adaptive_probe.py builds the
// other sizes).
constexpr int kThreads = 128;
static_assert(kThreads % 32 == 0, "a CTA runs whole warps");
using Keys = stash_pf::Keys<1>;

// Bit 4 s + j: slot s of the row equals fam[j].
__device__ __forceinline__ uint32_t match4(uint4 r, const uint32_t fam[4]) {
  uint32_t m = 0;
#pragma unroll
  for (int j = 0; j < 4; ++j)
    m |= (uint32_t)(r.x == fam[j]) << j |
         (uint32_t)(r.y == fam[j]) << (4 + j) |
         (uint32_t)(r.z == fam[j]) << (8 + j) |
         (uint32_t)(r.w == fam[j]) << (12 + j);
  return m;
}

// The same for a row of bucket_size <= 16 slots.
__device__ __forceinline__ unsigned long long match_row(
    const uint32_t* __restrict__ table, int bucket_size, uint32_t b,
    const uint32_t fam[4]) {
  const uint32_t* row = table + (size_t)b * bucket_size;
  unsigned long long m = 0;
  for (int s = 0; s < bucket_size; ++s) {
    const uint32_t v = __ldg(row + s);
#pragma unroll
    for (int j = 0; j < 4; ++j)
      m |= (unsigned long long)(v == fam[j]) << (4 * s + j);
  }
  return m;
}

// Some slot s holds fam[sel(w, s)].
template <typename M>
__device__ __forceinline__ bool resolve(M m, uint32_t w, int bucket_size) {
  bool h = false;
  for (int s = 0; s < bucket_size; ++s)
    h |= (m >> (4 * s + ocf::sel_of(w, s))) & 1u;
  return h;
}

// Whether row b holds the key: its selector word is loaded only if some
// slot equals a family fingerprint.
__device__ __forceinline__ bool in_row4(uint4 r,
                                        const uint32_t* __restrict__ sels,
                                        uint32_t b, const uint32_t fam[4]) {
  const uint32_t m = match4(r, fam);
  return m != 0 && resolve(m, __ldg(sels + b), 4);
}

__device__ __forceinline__ bool in_row(const uint32_t* __restrict__ table,
                                       const uint32_t* __restrict__ sels,
                                       int bucket_size, uint32_t b,
                                       const uint32_t fam[4]) {
  const unsigned long long m = match_row(table, bucket_size, b, fam);
  return m != 0 && resolve(m, __ldg(sels + b), bucket_size);
}

template <bool kVec, bool kTm>
__global__ void __launch_bounds__(kThreads)
    probe_adaptive_kernel(const uint32_t* __restrict__ table,
                          const uint32_t* __restrict__ sels, int bucket_size,
                          const uint32_t* __restrict__ stash, int stash_slots,
                          const uint32_t* __restrict__ hi,
                          const uint32_t* __restrict__ lo,
                          uint8_t* __restrict__ hit, int n, int fp_bits,
                          uint32_t n_buckets, int list_cap,
                          uint32_t* __restrict__ plane, int n_count) {
  extern __shared__ __align__(16) uint32_t smem[];
  __shared__ uint8_t s_slot[1];
  __shared__ int s_counts[2];
  if (threadIdx.x == 0) {
    s_slot[0] = 0;
    s_counts[0] = 0;
  }
  const uint4* rows = reinterpret_cast<const uint4*>(table);
  int count = 0, pass = 0;
  const int k = blockIdx.x * kThreads + threadIdx.x;
  Keys ks;
  uint32_t fam[4] = {0u, 0u, 0u, 0u};
  uint4 home = make_uint4(0u, 0u, 0u, 0u);
  ks.live[0] = k < n;
  ks.h[0] = false;
  ks.i1[0] = ks.i2[0] = 0;
  if (ks.live[0]) {
    const uint32_t h32 = __ldg(hi + k), l32 = __ldg(lo + k);
    ocf::fp_family(h32, l32, fp_bits, fam);
    ks.i1[0] = ocf::index_hash(h32, l32, n_buckets);
    ks.i2[0] = ocf::alt_index(ks.i1[0], fam[0], n_buckets);
    // The home row's load is out while the stash is staged.
    if (kVec) home = __ldg(rows + ks.i1[0]);
  }
  ks.fp[0] = fam[0];
  // Every thread of the CTA stages and walks, live key or not: the
  // staging's barriers and the walk's warp votes need them all.
  if (stash_slots > 0)
    count = stash_pf::stage_pass(stash, stash_slots, s_slot, 0, list_cap,
                                 smem, list_cap, s_counts, pass++ & 1);
  bool h1 = false;  // answered by the home row (telemetry only)
  if (ks.live[0]) {
    const uint32_t i1 = ks.i1[0], i2 = ks.i2[0];
    if constexpr (kTm) {
      h1 = kVec ? in_row4(home, sels, i1, fam)
                : in_row(table, sels, bucket_size, i1, fam);
      ks.h[0] = h1 || (kVec ? in_row4(__ldg(rows + i2), sels, i2, fam)
                            : in_row(table, sels, bucket_size, i2, fam));
    } else if (kVec) {
      ks.h[0] = in_row4(home, sels, i1, fam) ||
                in_row4(__ldg(rows + i2), sels, i2, fam);
    } else {
      ks.h[0] = in_row(table, sels, bucket_size, i1, fam) ||
                in_row(table, sels, bucket_size, i2, fam);
    }
  }
  const bool hb = ks.h[0];  // answered by a row
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
    // Depth d of this key: 0 home, 1 alternate, 2 stash, 3 miss.
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
void launch(const void* table, const void* sels, int bucket_size,
            const void* stash, int stash_slots, const void* hi,
            const void* lo, void* hit, int n, int fp_bits,
            unsigned int n_buckets, void* plane, int n_count,
            cudaStream_t stream) {
  const int list_cap = min(stash_slots, stash_pf::kList);
  const int smem = stash_slots > 0 ? stash_pf::smem_bytes(list_cap) : 0;
  const int blocks = (n + kThreads - 1) / kThreads;
  probe_adaptive_kernel<kVec, kTm><<<blocks, kThreads, smem, stream>>>(
      (const uint32_t*)table, (const uint32_t*)sels, bucket_size,
      (const uint32_t*)stash, stash_slots, (const uint32_t*)hi,
      (const uint32_t*)lo, (uint8_t*)hit, n, fp_bits, n_buckets, list_cap,
      (uint32_t*)plane, n_count);
}

}  // namespace

extern "C" int ocf_probe_adaptive(const void* table, const void* sels,
                                  int bucket_size, const void* stash,
                                  int stash_slots, const void* hi,
                                  const void* lo, void* hit, int n,
                                  int fp_bits, unsigned int n_buckets,
                                  void* stream) {
  if (n > 0)
    (bucket_size == 4 ? &launch<true, false> : &launch<false, false>)(
        table, sels, bucket_size, stash, stash ? stash_slots : 0, hi, lo, hit,
        n, fp_bits, n_buckets, nullptr, 0, (cudaStream_t)stream);
  return (int)cudaGetLastError();
}

// The telemetry twin: ``plane`` is four zeroed uint32 counters (home,
// alternate, stash, miss) that the launch adds the first n_count keys to.
extern "C" int ocf_probe_adaptive_tm(const void* table, const void* sels,
                                     int bucket_size, const void* stash,
                                     int stash_slots, const void* hi,
                                     const void* lo, void* hit, int n,
                                     int fp_bits, unsigned int n_buckets,
                                     void* plane, int n_count,
                                     void* stream) {
  if (n > 0)
    (bucket_size == 4 ? &launch<true, true> : &launch<false, true>)(
        table, sels, bucket_size, stash, stash ? stash_slots : 0, hi, lo, hit,
        n, fp_bits, n_buckets, plane, n_count, (cudaStream_t)stream);
  return (int)cudaGetLastError();
}
