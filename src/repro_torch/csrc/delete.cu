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
//     semantics: rank, decide (reads), barrier, write, barrier.
//   * Duplicates are ranked by (bucket, fingerprint) among earlier active
//     lanes, so the k-th duplicate clears the k-th matching slot and
//     duplicates past the resident count report False.
//
// Design for the H100 (staged.cuh): a delete reads and writes only the
// home and alternate rows of its own lanes, so once a window's rows are
// staged in shared memory (1920 lanes a window at block 128 and bucket 4)
// the whole window runs on chip between one staged copy and one
// write-back.  Ranks by (bucket, fingerprint) come from the two count
// tables of staged.cuh.  The old kernel took each rank as an O(block) loop
// over three device-memory arrays (target, active, fingerprint) per
// earlier lane, against two in insert's, which is why it was the slower
// of the two.
//
// What it bought, and what bounds it (H100 80GB HBM3, 700 W; PERF.md has
// the runs): 0.094 ms a 4096-key launch at block 128 on chip_smoke.py's
// phase-6 state against the old kernel's 0.446 in the same run (the first
// staged version, ranking with __match_any_sync and a hash map: 0.220).
// Like insert, it is held by the serial walk over the logical blocks on
// one SM (two rounds of dependent shared-memory passes each), not by the
// bytes (~1e-4 ms).
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
// row that holds its fingerprint, when there is one.
// Lane j's fingerprint is S.wfp[wb + j]; L.rowi[j] holds the staged
// index of its target row.
__device__ void clear_round(const Args& A, const stg::Stage& S,
                            const stg::Crowd& C, const Lanes& L, int nl,
                            int wb) {
  const uint32_t* fp = S.wfp + wb;
  auto key = [&](int j, uint64_t& k) {
    k = ((uint64_t)L.tgt[j] << 32) | fp[j];
    return (L.flags[j] & kAct) != 0;
  };
  stg::rank_round(C, nl, A.bsz, key, [&](int j, uint32_t r) {
    L.slot[j] = stg::nth_equal(stg::row_at(S, L.rowi[j], L.tgt[j]), A.bsz,
                               fp[j], r);
  });
  __syncthreads();
  for (int j = threadIdx.x; j < nl; j += blockDim.x) {
    uint64_t k;
    if (!key(j, k)) continue;
    stg::crowd_clear(C, j);
    const int s = L.slot[j];
    if (s < 0) continue;
    const uint32_t idx = L.rowi[j];
    stg::row_write(S, stg::row_at(S, idx, L.tgt[j]), idx, s, 0u);
    L.flags[j] = kOk;
  }
  __syncthreads();
}

// kOnChip: the per-lane region is in shared memory (the compiler then
// addresses it as such); else in the device-memory buffer ``A.spill``.
template <bool kOnChip>
__global__ void __launch_bounds__(stg::kThreads, 1) delete_kernel(Args A) {
  if (blockIdx.x > 0) {
    stg::warm_l2(A.table, A.bsz, A.hi, A.lo, A.valid, A.n, A.fp_bits, A.nb);
    return;
  }
  extern __shared__ __align__(16) uint8_t smem[];
  const stg::Plan& P = A.plan;
  stg::Stage S;
  uint8_t* q = stg::carve_stage(S, smem, P, A.table, A.bsz, A.copy);
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
      clear_round(A, S, C, L, nl, wb);
      for (int j = threadIdx.x; j < nl; j += blockDim.x) {
        L.tgt[j] = S.wi2[wb + j];
        L.rowi[j] = S.wr2[wb + j];
      }
      clear_round(A, S, C, L, nl, wb);
      for (int j = threadIdx.x; j < nl; j += blockDim.x)
        A.ok[base + j] = (L.flags[j] & kOk) ? 1 : 0;
    }
    stg::write_back(S, w1 - w0);
  }
}

stg::Plan plan_for(int n, int block, int bsz) {
  Lanes L;
  return stg::make_plan(n, block, bsz, carve(nullptr, block, &L));
}

}  // namespace

// Bytes of device memory the launch needs for its per-lane region (0 when
// that region fits in shared memory, as on the main path).
extern "C" long long ocf_delete_bulk_spill_bytes(int bucket_size, int n,
                                                 int block) {
  const stg::Plan p = plan_for(n, block, bucket_size);
  return p.lane_smem ? 0 : (long long)p.lane_bytes;
}

extern "C" int ocf_delete_bulk(void* table, int bucket_size,
                               unsigned int n_buckets, const void* hi,
                               const void* lo, const void* valid, void* ok,
                               int n, int block, int fp_bits, void* spill,
                               void* stream) {
  if (n <= 0) return 0;
  Args A;
  A.table = (uint32_t*)table;
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
  auto kernel = A.plan.lane_smem ? delete_kernel<true> : delete_kernel<false>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)stg::kSmemMax);
  if (err != cudaSuccess) return (int)err;
  kernel<<<stg::launch_ctas(n), stg::kThreads, A.plan.smem,
           (cudaStream_t)stream>>>(A);
  return (int)cudaGetLastError();
}
