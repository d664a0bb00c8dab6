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
// scatter semantics (rank, decide, barrier, write, barrier).  What the
// adaptive planes change:
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
// Design for the H100: delete.cu's staged design (staged.cuh) over four
// planes.  The kernel it replaces took each rank as an O(block) loop over
// four device-memory arrays per earlier lane and read every row from
// device memory.  A delete reads only its lanes' home and alternate rows
// and their selector words, so once a window's rows are staged in shared
// memory (1792 lanes a window at block 128 and bucket 4), each row with
// its selector word, the window runs on chip between one staged copy and
// one write-back; selector fields are cleared with shared-memory atomics.
// khi / klo are never read: a hit zeroes them straight through in device
// memory.  Ranks by (bucket, fp0) come from staged.cuh's count tables.
// A lane hashes its other three family fingerprints only where its row
// has an adapted slot (rare: only reported false positives adapt).
// The adaptive path deletes 3M keys a call; the wrapper splits a call into
// launches of at most 2^17 keys at logical-block boundaries (the result is
// the same: blocks run in order), so that the launch's L2-warming CTAs do
// not run further ahead than L2 holds.
//
// What it bought, and what bounds it (H100 80GB HBM3, 700 W; PERF.md has
// the runs): 0.104 ms a 4096-key call at block 128 on chip_smoke.py's
// phase-6 state against the old kernel's 0.535 in the same run; the
// adaptive path's 3M deletes 0.089 s of device time against 0.39.  As
// delete.cu, it is held by the serial walk over the logical blocks on one
// SM (two rounds of dependent shared-memory passes each;
// tools/staged_probe.py: ~7800 cycles a logical block), not by the bytes
// (~2e-4 ms).
#include "staged.cuh"

namespace {

enum : uint8_t { kAct = 1, kOk = 2 };

struct Lanes {
  stg::Crowd rank;    // the rounds' rank tables
  uint32_t* tgt;
  uint32_t* rowi;
  int32_t* slot;
  uint8_t* flags;
};

__host__ __device__ inline size_t carve(uint8_t* base, int B, Lanes* L) {
  size_t off = 0;
  const size_t w = (size_t)B * 4;
  L->rank = stg::carve_crowd(base, off, B);
  L->tgt = (uint32_t*)stg::take(base, off, w);
  L->rowi = (uint32_t*)stg::take(base, off, w);
  L->slot = (int32_t*)stg::take(base, off, w);
  L->flags = stg::take(base, off, B);
  return off;
}

struct Args {
  uint32_t* table;
  uint32_t* sels;
  uint32_t* khi;
  uint32_t* klo;
  int bsz;
  uint32_t nb;
  const uint32_t* hi;
  const uint32_t* lo;
  const uint8_t* valid;
  uint8_t* ok;
  int n, block, fp_bits, copy;
  stg::Plan plan;
  uint8_t* spill;
};

// One clear attempt: each act lane zeroes the rank-th slot of its target
// row that holds its family fingerprint under the slot's selector.
// Lane j (key A.hi / A.lo[base + j]) has its fp0 in S.wfp[wb + j];
// L.rowi[j] holds the staged index of its target row.  A row whose slots
// are all on selector 0 (nearly every row: only reported false positives
// adapt a slot) is matched against fp0 alone; the other members are
// hashed only for a row with an adapted slot.
__device__ void clear_round(const Args& A, const stg::Stage& S,
                            const stg::Crowd& C, const Lanes& L, int nl,
                            int base, int wb) {
  const uint32_t* fp = S.wfp + wb;
  auto key = [&](int j, uint64_t& k) {
    k = ((uint64_t)L.tgt[j] << 32) | fp[j];
    return (L.flags[j] & kAct) != 0;
  };
  stg::rank_round(C, nl, A.bsz, key, [&](int j, uint32_t r) {
    const uint32_t b = L.tgt[j], idx = L.rowi[j];
    const uint32_t* row = stg::row_at(S, idx, b);
    const uint32_t w = stg::sel_read(S, idx, b);
    if (w == 0u) {
      L.slot[j] = stg::nth_equal(row, A.bsz, fp[j], r);
      return;
    }
    const uint32_t h = A.hi[base + j], l = A.lo[base + j];
    const uint32_t f0 = fp[j], f1 = ocf::fingerprint_sel(h, l, 1u, A.fp_bits),
                   f2 = ocf::fingerprint_sel(h, l, 2u, A.fp_bits),
                   f3 = ocf::fingerprint_sel(h, l, 3u, A.fp_bits);
    int s = -1;
    uint32_t seen = 0;
    for (int k = 0; k < A.bsz; ++k) {
      const uint32_t sel = ocf::sel_of(w, k);
      const uint32_t want = sel == 0u ? f0 : sel == 1u ? f1 : sel == 2u ? f2
                                                                        : f3;
      if (row[k] == want && seen++ == r) {
        s = k;
        break;
      }
    }
    L.slot[j] = s;
  });
  __syncthreads();
  for (int j = threadIdx.x; j < nl; j += blockDim.x) {
    uint64_t k;
    if (!key(j, k)) continue;
    stg::crowd_clear(C, j);
    const int s = L.slot[j];
    if (s < 0) continue;
    const uint32_t b = L.tgt[j], idx = L.rowi[j];
    stg::row_write(S, stg::row_at(S, idx, b), idx, s, 0u);
    ocf::set_sel(stg::sel_at(S, idx, b), s, 0u);
    const size_t at = (size_t)b * A.bsz + s;
    A.khi[at] = 0u;
    A.klo[at] = 0u;
    L.flags[j] = kOk;
  }
  __syncthreads();
}

// kOnChip: the per-lane region is in shared memory (the compiler then
// addresses it as such); else in the device-memory buffer ``A.spill``.
template <bool kOnChip>
__global__ void __launch_bounds__(stg::kThreads, 1)
    delete_adaptive_kernel(Args A) {
  if (blockIdx.x > 0) {
    stg::warm_l2(A.table, A.bsz, A.hi, A.lo, A.valid, A.n, A.fp_bits, A.nb,
                 A.sels);
    return;
  }
  extern __shared__ __align__(16) uint8_t smem[];
  const stg::Plan& P = A.plan;
  stg::Stage S;
  uint8_t* q = stg::carve_stage(S, smem, P, A.table, A.bsz, A.copy, A.sels);
  Lanes L;
  carve(kOnChip ? q : A.spill, A.block, &L);
  const stg::Crowd& C = L.rank;
  for (int i = threadIdx.x; i < 2 * C.cap; i += blockDim.x) C.cnt[i] = 0u;

  for (int w0 = 0; w0 < A.n; w0 += P.window) {
    const int w1 = min(A.n, w0 + P.window);
    stg::stage_window(S, w0, w1, A.hi, A.lo, A.valid, A.fp_bits, A.nb);
    for (int base = w0; base < w1; base += A.block) {
      const int nl = min(A.block, w1 - base), wb = base - w0;
      for (int j = threadIdx.x; j < nl; j += blockDim.x) {
        L.tgt[j] = S.wi1[wb + j];
        L.rowi[j] = S.wr1[wb + j];
        L.flags[j] = S.wfp[wb + j] ? kAct : 0;
      }
      clear_round(A, S, C, L, nl, base, wb);
      for (int j = threadIdx.x; j < nl; j += blockDim.x) {
        L.tgt[j] = S.wi2[wb + j];
        L.rowi[j] = S.wr2[wb + j];
      }
      clear_round(A, S, C, L, nl, base, wb);
      for (int j = threadIdx.x; j < nl; j += blockDim.x)
        A.ok[base + j] = (L.flags[j] & kOk) ? 1 : 0;
    }
    stg::write_back(S, w1 - w0);
  }
}

stg::Plan plan_for(int n, int block, int bsz) {
  Lanes L;
  return stg::make_plan(n, block, bsz, carve(nullptr, block, &L), true);
}

}  // namespace

// Bytes of device memory a launch needs for its per-lane region (0 when
// that region fits in shared memory, as on the main path).
extern "C" long long ocf_delete_bulk_adaptive_spill_bytes(int bucket_size,
                                                          int n, int block) {
  const stg::Plan p = plan_for(n, block, bucket_size);
  return p.lane_smem ? 0 : (long long)p.lane_bytes;
}

// One launch over n keys (a whole number of logical blocks).
extern "C" int ocf_delete_bulk_adaptive(
    void* table, void* sels, void* khi, void* klo, int bucket_size,
    unsigned int n_buckets, const void* hi, const void* lo, const void* valid,
    void* ok, int n, int block, int fp_bits, void* spill, void* stream) {
  if (n <= 0) return 0;
  Args A;
  A.table = (uint32_t*)table;
  A.sels = (uint32_t*)sels;
  A.khi = (uint32_t*)khi;
  A.klo = (uint32_t*)klo;
  A.bsz = bucket_size;
  A.nb = n_buckets;
  A.hi = (const uint32_t*)hi;
  A.lo = (const uint32_t*)lo;
  A.valid = (const uint8_t*)valid;
  A.ok = (uint8_t*)ok;
  A.n = n;
  A.block = block;
  A.fp_bits = fp_bits;
  A.copy = stg::copy_size(table, bucket_size);
  A.plan = plan_for(n, block, bucket_size);
  A.spill = (uint8_t*)spill;
  if (!A.plan.lane_smem && spill == nullptr) return (int)cudaErrorInvalidValue;
  auto kernel = A.plan.lane_smem ? delete_adaptive_kernel<true>
                                 : delete_adaptive_kernel<false>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)stg::kSmemMax);
  if (err != cudaSuccess) return (int)err;
  kernel<<<stg::launch_ctas(n), stg::kThreads, A.plan.smem,
           (cudaStream_t)stream>>>(A);
  return (int)cudaGetLastError();
}
