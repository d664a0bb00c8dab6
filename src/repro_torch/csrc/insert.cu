// insert_bulk: fused hash + bulk insert with bounded eviction rounds, an
// optional overflow-stash spill, and per-lane rollback.
//
// Replaces the TPU kernel repro/kernels/insert.py::_insert_bulk_impl
// (_insert_kernel, _insert_stash_kernel; bodies _insert_body, _place_round,
// _evict_rounds).  Entry points insert_bulk and insert_once
// (evict_rounds = 0).
//
// What the result depends on, and how this kernel keeps it:
//   * Logical blocks run IN ORDER with the table (and stash) carried from
//     block b to block b + 1 (the TPU's sequential grid with aliased
//     in->out BlockSpecs).  A CUDA grid has no order, so this is ONE CTA
//     that loops over the logical blocks.
//   * Every round has simultaneous-write semantics (the reference is a
//     JAX scatter): all reads of a round see the table as it was before
//     the round's writes.  A round is a ranking pass, a decision pass that
//     reads, a barrier, a write pass, a barrier.
//   * Ranks are taken within the logical block, so the block size is part
//     of the result; the caller passes the reference's.
//   * The dirty set (kicked slots no other lane may kick) is local to a
//     logical block: kicks add to it, a lane that lands releases its
//     chain, and it is empty again when the block ends.
//   * Early exits match the reference's while_loop (no active lane left)
//     and its rollback cond; they change no result.
//
// Design for the H100 (staged.cuh has the shared parts).  The serial
// order stays and its cost goes.  The old kernel kept lane state, the kick
// history and a table-sized dirty byte array in device memory, and took
// each rank as an O(block) loop over those arrays, every round.
//   * Rows: a window of logical blocks (1664 lanes at block 128 and bucket
//     4: a 4096-key call is three windows) has its home and alternate rows
//     staged in shared memory, deduplicated; placements read and write
//     them there until the window's write-back.  Eviction chains reach
//     random rows; those that are not staged are read and written in
//     device memory (L2).
//   * Ranks: two count tables a round (staged.cuh); the lanes whose key is
//     unique, nearly all, get rank 0 after one barrier.
//   * Lane state (target, carried fingerprint, kick count, decision) is a
//     shared-memory word a lane, each lane owned by one thread.  The kick
//     history keeps only the SLOT of each kick (one byte): the chain's
//     buckets are recomputed backwards, b_t = alt(b_{t+1}, carried_{t+1}),
//     since the alternate index is an involution, and a kicked slot still
//     holds the fingerprint the lane wrote (no one else may kick it, and
//     placements only fill empty slots), which is the carried value one
//     step back.  Rollback and release walk that chain.
//   * The dirty set is a hash set of kicked (bucket, slot) in shared
//     memory, cleared at the end of a block that kicked.
//   * Stash spill: exhausted lanes take the free stash slots in lane
//     order by two ballot scans of one warp (free slots, then lanes), on a
//     copy of the stash staged in shared memory.
//
// What it bought, and what bounds it (H100 80GB HBM3, 700 W; PERF.md has
// the runs).  On chip_smoke.py's phase-6 call (4096 keys, block 128, the
// main path's final OCF state) it takes 0.109 ms against the old kernel's
// 0.288 in the same run; one 128-key block 0.0067 ms (a launch's fixed
// cost and one window's staging); the call without eviction rounds 0.095.
// The first staged version, which took ranks with __match_any_sync and a
// shared-memory hash map, hashed each lane twice and claimed rows through
// one shared counter, took 0.232: tools/staged_probe.py puts a 64-bit
// __match_any_sync at ~1070 cycles against 28 for a barrier.  The parts
// that replaced it were not timed one by one.  What bounds it now is the
// serial walk on one SM: per logical block ~7100 cycles (the probe, whose
// marks add barriers), the two rounds' ranking ~2100 and write passes
// ~900 of them, a third of a window's staging ~2500; each pass is a chain
// of dependent shared-memory accesses.  Its bound (the bytes) is ~1e-4 ms.
//
// Telemetry (kTm, the twin ocf_insert_bulk_tm): the same walk, with each
// logical block's lanes counted before its rollback into shared counters
// (stg::count_lanes: the kick histogram of the valid lanes, spills marked
// by stg::spill with kSpilled, rollbacks), which CTA 0 adds to the
// launch's plane after the walk.  The flag-off instantiation is the
// kernel without telemetry.
#include "staged.cuh"

namespace {

// kSpilled: a lane that took a stash slot (telemetry instantiation).
enum : uint8_t { kValid = 1, kAct = 2, kActive = 4, kSpilled = 8 };

struct Lanes {
  stg::Crowd rank;    // the rounds' rank tables
  uint32_t* tgt;      // target bucket of the round (chain's bucket)
  uint32_t* carried;  // fingerprint the lane writes
  uint32_t* victim;   // phase B: fingerprint kicked out
  uint32_t* rowi;     // staged row index of the decision (or kNone)
  uint32_t* steps;    // kicks committed so far
  int32_t* slot;      // decision of the round (-1: none)
  uint8_t* flags;
  uint8_t* hist;      // block x rounds: slot of each kick
  uint32_t* dirty;    // dirty set: (bucket * bsz + slot + 1), 0 empty
  uint32_t* stash;    // 2 x S: the stash's staged copy
  uint32_t* freel;    // S: free stash slots in order
};

// Lay the per-lane region out from ``base`` (null: only count) -> bytes.
__host__ __device__ inline size_t carve(uint8_t* base, int B, int R, int S,
                                        Lanes* L) {
  size_t off = 0;
  const size_t w = (size_t)B * 4;
  L->rank = stg::carve_crowd(base, off, B);
  L->tgt = (uint32_t*)stg::take(base, off, w);
  L->carried = (uint32_t*)stg::take(base, off, w);
  L->victim = (uint32_t*)stg::take(base, off, w);
  L->rowi = (uint32_t*)stg::take(base, off, w);
  L->steps = (uint32_t*)stg::take(base, off, w);
  L->slot = (int32_t*)stg::take(base, off, w);
  L->flags = stg::take(base, off, B);
  L->hist = stg::take(base, off, (size_t)B * R);
  L->dirty =
      (uint32_t*)stg::take(base, off, (size_t)stg::dirty_cap(B, R) * 4);
  L->stash = (uint32_t*)stg::take(base, off, (size_t)S * 8);
  L->freel = (uint32_t*)stg::take(base, off, (size_t)S * 4);
  return off;
}

struct Args {
  uint32_t* table;
  int bsz;
  uint32_t nb;
  uint32_t* stash;
  int S;
  const uint32_t* hi;
  const uint32_t* lo;
  const uint8_t* valid;
  uint8_t* ok;
  int n, block, fp_bits, rounds, copy;
  stg::Plan plan;
  uint8_t* spill;
};

template <bool kTm>
struct Block {
  const Args& A;
  const stg::Stage& S;
  const stg::Crowd& C;
  const Lanes& L;
  const stg::Dirty& D;
  uint32_t* n_dirty;  // kicks added to the dirty set in this block
  int nl;             // lanes of the block
  int wb;             // its first lane's index in the window arrays
  uint32_t* tm;       // kTm: the shared counters (stg::count_lanes)

  // Walk lane j's chain back from its current (bucket, carried); ``undo``
  // restores each kicked slot (rollback), else the slots leave the dirty
  // set (release after landing).
  __device__ void walk_back(int j, bool undo) const {
    uint32_t b = L.tgt[j], c = L.carried[j];
    for (int t = (int)L.steps[j] - 1; t >= 0; --t) {
      const uint32_t bt = ocf::alt_index(b, c, A.nb);
      const int s = L.hist[(size_t)j * A.rounds + t];
      uint32_t idx;
      uint32_t* row = stg::row_of(S, bt, idx);
      const uint32_t w = row[s];
      if (undo)
        stg::row_write(S, row, idx, s, c);
      else
        D.del(bt * (uint32_t)A.bsz + s + 1u);
      c = w;
      b = bt;
    }
  }

  // One placement attempt for the lanes with ``bit`` set: each writes its
  // carried fingerprint into the rank-th empty slot of its target.  Lanes
  // that land lose ``bit``; in an eviction round they also release.
  // The two optimistic rounds (bit kAct) find their rows' staged indices
  // in L.rowi; an eviction round (kActive) looks its rows up.
  __device__ void place_round(uint8_t bit) const {
    stg::rank_round(
        C, nl, A.bsz,
        [&](int j, uint64_t& k) {
          k = L.tgt[j];
          return (L.flags[j] & bit) != 0;
        },
        [&](int j, uint32_t r) {
          uint32_t idx = L.rowi[j];
          if (bit == kActive) {
            stg::row_of(S, L.tgt[j], idx);
            L.rowi[j] = idx;
          }
          L.slot[j] =
              stg::nth_equal(stg::row_at(S, idx, L.tgt[j]), A.bsz, 0u, r);
        });
    __syncthreads();
    for (int j = threadIdx.x; j < nl; j += blockDim.x) {
      if (!(L.flags[j] & bit)) continue;
      stg::crowd_clear(C, j);
      const int s = L.slot[j];
      if (s < 0) continue;
      stg::row_write(S, stg::row_at(S, L.rowi[j], L.tgt[j]), L.rowi[j], s,
                     L.carried[j]);
      L.flags[j] &= ~bit;
      if (bit == kActive) walk_back(j, false);
    }
    __syncthreads();
  }

  // Phase B: the earliest active lane of each bucket kicks the first slot
  // not in the dirty set, rotating from steps % bucket_size, and carries
  // the victim on to its alternate bucket.  -> any lane still active.
  __device__ int kick_round() const {
    stg::rank_round(
        C, nl, 1u,
        [&](int j, uint64_t& k) {
          k = L.tgt[j];
          return (L.flags[j] & kActive) != 0;
        },
        [&](int j, uint32_t r) {
          int slot = -1;
          if (r == 0) {
            const uint32_t b = L.tgt[j];
            const int start = (int)(L.steps[j] % (uint32_t)A.bsz);
            for (int k = 0; k < A.bsz; ++k) {
              const int pos = (k + start) % A.bsz;
              if (*n_dirty == 0u || !D.has(b * (uint32_t)A.bsz + pos + 1u)) {
                slot = pos;
                break;
              }
            }
            if (slot >= 0) {
              uint32_t idx;
              L.victim[j] = stg::row_of(S, b, idx)[slot];
              L.rowi[j] = idx;
            }
          }
          L.slot[j] = slot;
        });
    __syncthreads();
    int still = 0;
    for (int j = threadIdx.x; j < nl; j += blockDim.x) {
      if (!(L.flags[j] & kActive)) continue;
      stg::crowd_clear(C, j);
      still = 1;
      const int s = L.slot[j];
      if (s < 0) continue;
      const uint32_t b = L.tgt[j], v = L.victim[j];
      stg::row_write(S, stg::row_at(S, L.rowi[j], b), L.rowi[j], s,
                     L.carried[j]);
      D.add(b * (uint32_t)A.bsz + s + 1u);
      atomicAdd(n_dirty, 1u);
      L.hist[(size_t)j * A.rounds + L.steps[j]] = (uint8_t)s;
      L.steps[j] += 1;
      L.carried[j] = v;
      L.tgt[j] = ocf::alt_index(b, v, A.nb);
    }
    return __syncthreads_or(still);
  }

  __device__ void run(int base) const {
    for (int j = threadIdx.x; j < nl; j += blockDim.x) {
      const uint32_t fp = S.wfp[wb + j];
      L.tgt[j] = S.wi1[wb + j];
      L.rowi[j] = S.wr1[wb + j];
      L.carried[j] = fp;
      L.steps[j] = 0;
      L.flags[j] = fp ? (kValid | kAct) : 0;
    }
    // Two optimistic rounds: home bucket, then alternate bucket.
    place_round(kAct);
    for (int j = threadIdx.x; j < nl; j += blockDim.x) {
      L.tgt[j] = S.wi2[wb + j];
      L.rowi[j] = S.wr2[wb + j];
    }
    place_round(kAct);
    // The residue carries its own fingerprint from the alternate bucket,
    // where the sequential chain starts.
    int any = 0;
    for (int j = threadIdx.x; j < nl; j += blockDim.x) {
      if (L.flags[j] & kAct) {
        L.flags[j] |= kActive;
        any = 1;
      }
    }
    any = __syncthreads_or(any);
    for (int r = 0; r < A.rounds && any; ++r) {
      place_round(kActive);  // phase A
      any = kick_round();    // phase B
    }
    if (A.stash != nullptr && any) {
      stg::spill<kTm ? kSpilled : 0>(nl, A.S, L.stash, L.freel, L.flags,
                                     kActive, L.carried, L.tgt);
      __syncthreads();
    }
    if constexpr (kTm)
      stg::count_lanes<kValid, kActive, kSpilled>(nl, L.flags, L.steps,
                                                  A.rounds > 0, tm);
    // Rollback: lanes still carrying restore their kicks newest first (the
    // dirty discipline makes those slots theirs alone).
    for (int j = threadIdx.x; j < nl; j += blockDim.x) {
      const uint8_t f = L.flags[j];
      if (f & kActive) walk_back(j, true);
      A.ok[base + j] = (f & kValid) && !(f & kActive);
    }
    const bool clear = *n_dirty != 0u;
    __syncthreads();
    if (clear)
      for (int i = threadIdx.x; i < D.cap; i += blockDim.x) D.d[i] = 0u;
    if (threadIdx.x == 0) *n_dirty = 0u;
    __syncthreads();
  }
};

// kOnChip: the per-lane region is in shared memory (the compiler then
// addresses it as such); else in the device-memory buffer ``A.spill``.
// kTm: the telemetry instantiation; it adds its stg::kTmCounters counts
// to ``plane`` (unused otherwise).
template <bool kOnChip, bool kTm>
__global__ void __launch_bounds__(stg::kThreads, 1)
    insert_kernel(Args A, uint32_t* plane) {
  if (blockIdx.x > 0) {
    stg::warm_l2(A.table, A.bsz, A.hi, A.lo, A.valid, A.n, A.fp_bits, A.nb);
    return;
  }
  extern __shared__ __align__(16) uint8_t smem[];
  __shared__ uint32_t s_dirty;
  const stg::Plan& P = A.plan;
  stg::Stage S;
  uint8_t* q = stg::carve_stage(S, smem, P, A.table, A.bsz, A.copy);
  Lanes L;
  carve(kOnChip ? q : A.spill, A.block, A.rounds, A.S, &L);
  const stg::Crowd& C = L.rank;
  const stg::Dirty D{L.dirty, stg::dirty_cap(A.block, A.rounds)};

  for (int i = threadIdx.x; i < 2 * C.cap; i += blockDim.x) C.cnt[i] = 0u;
  for (int i = threadIdx.x; i < D.cap; i += blockDim.x) D.d[i] = 0u;
  for (int i = threadIdx.x; i < 2 * A.S; i += blockDim.x)
    L.stash[i] = A.stash[i];
  if (threadIdx.x == 0) s_dirty = 0u;
  uint32_t* s_tm = nullptr;
  if constexpr (kTm) {
    __shared__ uint32_t tm_counts[stg::kTmCounters];
    s_tm = tm_counts;
    if (threadIdx.x < stg::kTmCounters) s_tm[threadIdx.x] = 0u;
  }
  __syncthreads();

  for (int w0 = 0; w0 < A.n; w0 += P.window) {
    const int w1 = min(A.n, w0 + P.window);
    stg::stage_window(S, w0, w1, A.hi, A.lo, A.valid, A.fp_bits, A.nb);
    for (int base = w0; base < w1; base += A.block) {
      const Block<kTm> blk{A,       S,   C, L, D, &s_dirty,
                           min(A.block, w1 - base), base - w0, s_tm};
      blk.run(base);
    }
    stg::write_back(S, w1 - w0);
  }
  for (int i = threadIdx.x; i < 2 * A.S; i += blockDim.x)
    A.stash[i] = L.stash[i];
  if constexpr (kTm) {
    __syncthreads();
    if (threadIdx.x < stg::kTmCounters && s_tm[threadIdx.x])
      atomicAdd(&plane[threadIdx.x], s_tm[threadIdx.x]);
  }
}

stg::Plan plan_for(int n, int block, int bsz, int stash_slots, int rounds) {
  Lanes L;
  return stg::make_plan(n, block, bsz,
                        carve(nullptr, block, rounds, stash_slots, &L));
}

}  // namespace

// Bytes of device memory the launch needs for its per-lane region (0 when
// that region fits in shared memory, as on the main path).
extern "C" long long ocf_insert_bulk_spill_bytes(int bucket_size,
                                                 int stash_slots, int n,
                                                 int block,
                                                 int evict_rounds) {
  const stg::Plan p =
      plan_for(n, block, bucket_size, stash_slots, evict_rounds);
  return p.lane_smem ? 0 : (long long)p.lane_bytes;
}

namespace {

template <bool kTm>
int insert_launch(void* table, int bucket_size, unsigned int n_buckets,
                  void* stash, int stash_slots, const void* hi,
                  const void* lo, const void* valid, void* ok, int n,
                  int block, int fp_bits, int evict_rounds, void* spill,
                  void* plane, void* stream) {
  if (n <= 0) return 0;
  Args A;
  A.table = (uint32_t*)table;
  A.bsz = bucket_size;
  A.nb = n_buckets;
  A.stash = (uint32_t*)stash;
  A.S = stash ? stash_slots : 0;
  A.hi = (const uint32_t*)hi;
  A.lo = (const uint32_t*)lo;
  A.valid = (const uint8_t*)valid;
  A.ok = (uint8_t*)ok;
  A.n = n;
  A.block = block;
  A.fp_bits = fp_bits;
  A.rounds = evict_rounds;
  A.copy = stg::copy_size(table, bucket_size);
  A.plan = plan_for(n, block, bucket_size, A.S, evict_rounds);
  A.spill = (uint8_t*)spill;
  if (!A.plan.lane_smem && spill == nullptr) return (int)cudaErrorInvalidValue;
  auto kernel = A.plan.lane_smem ? insert_kernel<true, kTm>
                                 : insert_kernel<false, kTm>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)stg::kSmemMax);
  if (err != cudaSuccess) return (int)err;
  kernel<<<stg::launch_ctas(n), stg::kThreads, A.plan.smem,
           (cudaStream_t)stream>>>(A, (uint32_t*)plane);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int ocf_insert_bulk(void* table, int bucket_size,
                               unsigned int n_buckets, void* stash,
                               int stash_slots, const void* hi,
                               const void* lo, const void* valid, void* ok,
                               int n, int block, int fp_bits,
                               int evict_rounds, void* spill, void* stream) {
  return insert_launch<false>(table, bucket_size, n_buckets, stash,
                              stash_slots, hi, lo, valid, ok, n, block,
                              fp_bits, evict_rounds, spill, nullptr, stream);
}

// The telemetry twin: ``plane`` is stg::kTmCounters uint32 counters (the
// kick histogram's 8 bins, spills, rollbacks) that the launch adds to.
extern "C" int ocf_insert_bulk_tm(void* table, int bucket_size,
                                  unsigned int n_buckets, void* stash,
                                  int stash_slots, const void* hi,
                                  const void* lo, const void* valid, void* ok,
                                  int n, int block, int fp_bits,
                                  int evict_rounds, void* spill, void* plane,
                                  void* stream) {
  return insert_launch<true>(table, bucket_size, n_buckets, stash,
                             stash_slots, hi, lo, valid, ok, n, block,
                             fp_bits, evict_rounds, spill, plane, stream);
}
