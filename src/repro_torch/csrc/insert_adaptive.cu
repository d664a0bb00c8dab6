// insert_bulk_adaptive: fused hash + bulk insert over the four adaptive
// planes (fingerprints, packed selectors, mirror key halves khi/klo), with
// bounded eviction rounds, an optional stash spill and per-lane rollback.
//
// Replaces the TPU kernel repro/kernels/insert.py::_insert_adaptive_impl
// (_insert_adaptive_kernel, _insert_adaptive_stash_kernel; bodies
// _insert_adaptive_body, _place_round_adaptive, _evict_rounds_adaptive).
//
// The schedule is insert.cu's, and so are the reasons for it: ONE CTA
// walks the logical blocks in order with the planes updated in place (the
// TPU's sequential grid with aliased in->out BlockSpecs); each round is a
// ranking pass, a decision pass that reads, a barrier, a write pass, a
// barrier (JAX scatter semantics: every read of a round sees the planes as
// before its writes); ranks are taken within the logical block; the dirty
// set is local to a logical block.  What the adaptive planes add:
//   * Placements and kicks write (fp0 of the carried key, selector 0, the
//     key into khi/klo).
//   * Lanes carry the KEY.  A kicked victim's next bucket is the alternate
//     of its MIRROR key's fp0, never of the stored fingerprint, which may
//     be an adapted family member.  Spills park the carried key's fp0.
//   * A failed lane restores the original four planes of its kicked slots
//     (it owns them: they stay dirty), newest first.
//   * The packed selector word is shared by every slot of a bucket, and
//     one write pass can set different slots of one word from different
//     threads (placements of different ranks, rollbacks of different
//     lanes), so each 2-bit field is written with atomicAnd / atomicOr
//     (ocf::set_sel): the fields are disjoint, so their order does not
//     matter.  The word is read only for a kicked victim.
//
// Design for the H100: insert.cu's staged design (staged.cuh) over four
// planes.  The kernel it replaces kept lane state, a six-wide kick history
// and a table-sized dirty byte array in device memory and took each rank
// as an O(block) loop over device arrays.
//   * Rows: a window of logical blocks (1408 lanes at block 128 and bucket
//     4) has its home and alternate rows' fingerprints staged in shared
//     memory.  The other three planes stay in device memory, written
//     straight through (selector fields by atomics that no thread waits
//     for): a round reads them only for a kicked victim, from L2
//     (ld.global.cg), which the write pass of the round before warms for
//     every lane that missed.  Staging the selector words as well (as the
//     delete does, which reads one a lane) cost more in copies and
//     write-backs than it saved (PERF.md).  The window is smaller
//     than insert.cu's (1664) by the wider history.
//   * Ranks: the two count tables of staged.cuh, keyed by bucket, for the
//     placement rounds only.  A kick round needs no ranks of its own: a
//     lane that missed a placement round with rank r against its row's e
//     empty slots is its bucket's earliest active lane exactly when r ==
//     e (the lanes of ranks below e took the empties).  Eviction round 0
//     has no placement round at all: the alternate round before it left
//     every row a missing lane targets full, so it could place nothing.
//   * Lane state in shared memory, one lane per thread at a time.
//   * History: one byte a kick (slot, and the victim's selector in bits
//     4-5) and the victim's stored fingerprint, 5 bytes against 24.  The
//     rest is recomputed backwards.  A kicked slot keeps what the lane
//     wrote (no one else may kick it, placements fill only empty slots):
//     fp0 of the key c_t carried at step t, and c_t in khi / klo.  The
//     victim's key is the key carried one step later, c_{t+1}, and the
//     chain's buckets follow from b_t = alt(b_{t+1}, fp0(c_{t+1})), alt
//     being an involution.  The victim's fingerprint is kept, not
//     recomputed from its key and selector: the planes may hold anything,
//     and rollback restores them verbatim.
//   * Dirty set: staged.cuh's block-local hash set; no table-sized array.
//   * The per-lane region (~83 KB at block 128, 32 rounds, 128 stash
//     slots) is in shared memory; a call whose worst case does not fit
//     (block 256 at 32 rounds, blocks 1024 and up) gets it in a device
//     buffer from the wrapper.
//   * Large calls: the adaptive path inserts 1M keys a call.  The wrapper
//     splits a call into launches of at most 2^17 keys at logical-block
//     boundaries (blocks run in order and carry the planes and the stash,
//     so the result is the same), so that each launch's L2-warming CTAs
//     bring in no more rows than L2 keeps until CTA 0 reaches them.
//
// What it bought, and what bounds it (H100 80GB HBM3, 700 W; PERF.md has
// the runs): 0.218 ms a 4096-key call at block 128 on chip_smoke.py's
// phase-6 state against the old kernel's 0.585 in the same run; the
// adaptive path's 12M inserts 0.705 s of device time against 2.29.  As
// insert.cu, it is held by the serial walk over the logical blocks on one
// SM, each round a chain of dependent shared-memory passes
// (tools/staged_probe.py: ~12200 cycles a logical block at load 0.5, ~7700
// of them its rounds' passes, against ~3300 for insert.cu's at load 0.3:
// more lanes reach eviction rounds, and a kick reads its victim's key
// from L2), not by the bytes (~2e-4 ms).
//
// Telemetry (kTm, the twin ocf_insert_bulk_adaptive_tm): counted as in
// insert.cu; every launch of a split call adds to the caller's one plane.
#include "staged.cuh"

namespace {

// kSpilled: a lane that took a stash slot (telemetry instantiation).
enum : uint8_t {
  kValid = 1,
  kAct = 2,
  kActive = 4,
  kFirst = 8,
  kSpilled = 16
};

struct Lanes {
  stg::Crowd rank;    // the rounds' rank tables
  uint32_t* tgt;      // target bucket of the round (chain's bucket)
  uint32_t* chi;      // carried key, high half
  uint32_t* clo;      // carried key, low half
  uint32_t* cfp;      // fp0 of the carried key: what the lane writes
  uint32_t* rowi;     // staged row index of the decision (or kNone)
  uint32_t* steps;    // kicks committed so far
  int32_t* slot;      // decision of the round (-1: none)
  uint8_t* flags;
  uint8_t* hist;      // block x rounds: slot | victim's selector << 4
  uint32_t* hfp;      // block x rounds: victim's stored fingerprint
  uint32_t* dirty;    // dirty set
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
  L->chi = (uint32_t*)stg::take(base, off, w);
  L->clo = (uint32_t*)stg::take(base, off, w);
  L->cfp = (uint32_t*)stg::take(base, off, w);
  L->rowi = (uint32_t*)stg::take(base, off, w);
  L->steps = (uint32_t*)stg::take(base, off, w);
  L->slot = (int32_t*)stg::take(base, off, w);
  L->flags = stg::take(base, off, B);
  L->hist = stg::take(base, off, (size_t)B * R);
  L->hfp = (uint32_t*)stg::take(base, off, (size_t)B * R * 4);
  L->dirty =
      (uint32_t*)stg::take(base, off, (size_t)stg::dirty_cap(B, R) * 4);
  L->stash = (uint32_t*)stg::take(base, off, (size_t)S * 8);
  L->freel = (uint32_t*)stg::take(base, off, (size_t)S * 4);
  return off;
}

struct Args {
  uint32_t* table;
  uint32_t* sels;
  uint32_t* khi;
  uint32_t* klo;
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

  // Slot s of bucket b (staged index idx) takes lane j's carried key:
  // fp0, selector 0, the key into khi / klo.
  __device__ void put(int j, uint32_t b, uint32_t idx, int s) const {
    stg::row_write(S, stg::row_at(S, idx, b), idx, s, L.cfp[j]);
    ocf::set_sel(A.sels + b, s, 0u);
    const size_t at = (size_t)b * A.bsz + s;
    A.khi[at] = L.chi[j];
    A.klo[at] = L.clo[j];
  }

  // Walk lane j's chain back from its current (bucket, carried key);
  // ``undo`` restores each kicked slot's four planes (rollback), else the
  // slots leave the dirty set (release after landing).  The fingerprint a
  // kicked slot holds is fp0 of the key the lane carried there, which
  // gives the bucket one step further back.
  __device__ void walk_back(int j, bool undo) const {
    uint32_t b = L.tgt[j], c = L.cfp[j];
    uint32_t khi = L.chi[j], klo = L.clo[j];  // the victim's key (undo)
    const size_t h0 = (size_t)j * A.rounds;
    for (int t = (int)L.steps[j] - 1; t >= 0; --t) {
      const uint32_t bt = ocf::alt_index(b, c, A.nb);
      const uint32_t h = L.hist[h0 + t];
      const int s = (int)(h & 15u);
      uint32_t idx;
      uint32_t* row = stg::row_of(S, bt, idx);
      const uint32_t w = row[s];
      if (undo) {
        const size_t at = (size_t)bt * A.bsz + s;
        const uint32_t whi = __ldcg(A.khi + at), wlo = __ldcg(A.klo + at);
        stg::row_write(S, row, idx, s, L.hfp[h0 + t]);
        ocf::set_sel(A.sels + bt, s, h >> 4);
        A.khi[at] = khi;
        A.klo[at] = klo;
        khi = whi;
        klo = wlo;
      } else {
        D.del(bt * (uint32_t)A.bsz + s + 1u);
      }
      c = w;
      b = bt;
    }
  }

  // One placement attempt for the lanes with ``bit`` set: each writes its
  // carried key into the rank-th empty slot of its target.  Lanes that
  // land lose ``bit``; in an eviction round they also release.  The two
  // optimistic rounds (bit kAct) find their rows' staged indices in
  // L.rowi; an eviction round (kActive) looks its rows up.
  //
  // A lane that misses had rank r >= e, its row's e empty slots, and the
  // lanes of ranks below e took them all; so among the lanes still
  // active, its rank is r - e, and it is its bucket's earliest (the one
  // that kicks in the phase B that follows) exactly when r == e.  It
  // notes that in kFirst (ranks are exact up to bsz + 1 for it), and with
  // ``warm`` brings that bucket's khi / klo rows into L2, where the kick
  // reads its victim's key.
  __device__ void place_round(uint8_t bit, bool warm) const {
    stg::rank_round(
        C, nl, A.bsz + 1u,
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
          const uint32_t* row = stg::row_at(S, idx, L.tgt[j]);
          int slot = -1;
          uint32_t empty = 0;
          for (int k = 0; k < A.bsz; ++k)
            if (row[k] == 0u && empty++ == r) slot = k;
          L.slot[j] = slot >= 0 ? slot : r == empty ? -2 : -1;
        });
    __syncthreads();
    for (int j = threadIdx.x; j < nl; j += blockDim.x) {
      if (!(L.flags[j] & bit)) continue;
      stg::crowd_clear(C, j);
      const int s = L.slot[j];
      if (s < 0) {
        if (s == -2) {
          L.flags[j] |= kFirst;
          if (warm) {
            stg::prefetch_l2(A.khi + (size_t)L.tgt[j] * A.bsz);
            stg::prefetch_l2(A.klo + (size_t)L.tgt[j] * A.bsz);
          }
        } else {
          L.flags[j] &= ~kFirst;
        }
        continue;
      }
      put(j, L.tgt[j], L.rowi[j], s);
      L.flags[j] &= ~bit;
      if (bit == kActive) walk_back(j, false);
    }
    __syncthreads();
  }

  // Phase B: the earliest active lane of each bucket (kFirst, from the
  // placement round before) kicks the first slot not in the dirty set,
  // rotating from steps % bucket_size, and carries the victim's key on to
  // the alternate of its fp0.  One lane a bucket kicks, so it reads the
  // victim's planes in the write pass before it writes them.  -> any lane
  // still active.
  __device__ int kick_round() const {
    for (int j = threadIdx.x; j < nl; j += blockDim.x) {
      if (!(L.flags[j] & kActive)) continue;
      int slot = -1;
      if (L.flags[j] & kFirst) {
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
          stg::row_of(S, b, idx);
          L.rowi[j] = idx;
        }
      }
      L.slot[j] = slot;
    }
    __syncthreads();
    int still = 0;
    for (int j = threadIdx.x; j < nl; j += blockDim.x) {
      if (!(L.flags[j] & kActive)) continue;
      still = 1;
      const int s = L.slot[j];
      if (s < 0) continue;
      const uint32_t b = L.tgt[j], idx = L.rowi[j];
      const size_t at = (size_t)b * A.bsz + s;
      const uint32_t vfp = stg::row_at(S, idx, b)[s];
      const uint32_t vsel = ocf::sel_of(__ldcg(A.sels + b), s);
      const uint32_t vhi = __ldcg(A.khi + at), vlo = __ldcg(A.klo + at);
      put(j, b, idx, s);
      D.add(b * (uint32_t)A.bsz + s + 1u);
      atomicAdd(n_dirty, 1u);
      const size_t h = (size_t)j * A.rounds + L.steps[j];
      L.hist[h] = (uint8_t)(s | (vsel << 4));
      L.hfp[h] = vfp;
      L.steps[j] += 1;
      const uint32_t vfp0 = ocf::fingerprint(vhi, vlo, A.fp_bits);
      L.chi[j] = vhi;
      L.clo[j] = vlo;
      L.cfp[j] = vfp0;
      L.tgt[j] = ocf::alt_index(b, vfp0, A.nb);
    }
    return __syncthreads_or(still);
  }

  __device__ void run(int base) const {
    for (int j = threadIdx.x; j < nl; j += blockDim.x) {
      const uint32_t fp = S.wfp[wb + j];
      L.tgt[j] = S.wi1[wb + j];
      L.rowi[j] = S.wr1[wb + j];
      L.chi[j] = A.hi[base + j];
      L.clo[j] = A.lo[base + j];
      L.cfp[j] = fp;
      L.steps[j] = 0;
      L.flags[j] = fp ? (kValid | kAct) : 0;
    }
    // Two optimistic rounds: home bucket, then alternate bucket.
    place_round(kAct, false);
    for (int j = threadIdx.x; j < nl; j += blockDim.x) {
      L.tgt[j] = S.wi2[wb + j];
      L.rowi[j] = S.wr2[wb + j];
    }
    place_round(kAct, A.rounds > 0);
    // The residue carries its own key from the alternate bucket, where
    // the sequential chain starts.
    int any = 0;
    for (int j = threadIdx.x; j < nl; j += blockDim.x) {
      if (L.flags[j] & kAct) {
        L.flags[j] |= kActive;
        any = 1;
      }
    }
    any = __syncthreads_or(any);
    // Round 0's phase A could place nothing: the alternate round left
    // every row a missing lane targets full.  So round 0 only kicks.
    for (int r = 0; r < A.rounds && any; ++r) {
      if (r > 0) place_round(kActive, true);  // phase A
      any = kick_round();                     // phase B
    }
    if (A.stash != nullptr && any) {
      stg::spill<kTm ? kSpilled : 0>(nl, A.S, L.stash, L.freel, L.flags,
                                     kActive, L.cfp, L.tgt);
      __syncthreads();
    }
    if constexpr (kTm)
      stg::count_lanes<kValid, kActive, kSpilled>(nl, L.flags, L.steps,
                                                  A.rounds > 0, tm);
    // Rollback: lanes still carrying restore their kicks newest first.
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
    insert_adaptive_kernel(Args A, uint32_t* plane) {
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

// Bytes of device memory a launch needs for its per-lane region (0 when
// that region fits in shared memory, as on the main path).
extern "C" long long ocf_insert_bulk_adaptive_spill_bytes(int bucket_size,
                                                          int stash_slots,
                                                          int n, int block,
                                                          int evict_rounds) {
  const stg::Plan p =
      plan_for(n, block, bucket_size, stash_slots, evict_rounds);
  return p.lane_smem ? 0 : (long long)p.lane_bytes;
}

namespace {

template <bool kTm>
int insert_launch(void* table, void* sels, void* khi, void* klo,
                  int bucket_size, unsigned int n_buckets, void* stash,
                  int stash_slots, const void* hi, const void* lo,
                  const void* valid, void* ok, int n, int block, int fp_bits,
                  int evict_rounds, void* spill, void* plane, void* stream) {
  if (n <= 0) return 0;
  Args A;
  A.table = (uint32_t*)table;
  A.sels = (uint32_t*)sels;
  A.khi = (uint32_t*)khi;
  A.klo = (uint32_t*)klo;
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
  auto kernel = A.plan.lane_smem ? insert_adaptive_kernel<true, kTm>
                                 : insert_adaptive_kernel<false, kTm>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)stg::kSmemMax);
  if (err != cudaSuccess) return (int)err;
  kernel<<<stg::launch_ctas(n), stg::kThreads, A.plan.smem,
           (cudaStream_t)stream>>>(A, (uint32_t*)plane);
  return (int)cudaGetLastError();
}

}  // namespace

// One launch over n keys (a whole number of logical blocks).
extern "C" int ocf_insert_bulk_adaptive(
    void* table, void* sels, void* khi, void* klo, int bucket_size,
    unsigned int n_buckets, void* stash, int stash_slots, const void* hi,
    const void* lo, const void* valid, void* ok, int n, int block,
    int fp_bits, int evict_rounds, void* spill, void* stream) {
  return insert_launch<false>(table, sels, khi, klo, bucket_size, n_buckets,
                              stash, stash_slots, hi, lo, valid, ok, n, block,
                              fp_bits, evict_rounds, spill, nullptr, stream);
}

// The telemetry twin: ``plane`` is stg::kTmCounters uint32 counters (the
// kick histogram's 8 bins, spills, rollbacks) that the launch adds to.
extern "C" int ocf_insert_bulk_adaptive_tm(
    void* table, void* sels, void* khi, void* klo, int bucket_size,
    unsigned int n_buckets, void* stash, int stash_slots, const void* hi,
    const void* lo, const void* valid, void* ok, int n, int block,
    int fp_bits, int evict_rounds, void* spill, void* plane, void* stream) {
  return insert_launch<true>(table, sels, khi, klo, bucket_size, n_buckets,
                             stash, stash_slots, hi, lo, valid, ok, n, block,
                             fp_bits, evict_rounds, spill, plane, stream);
}
