// Shared machinery of the staged insert and delete kernels (sm_90a): the
// static ones (insert.cu, delete.cu) and the adaptive ones over four
// planes (insert_adaptive.cu, delete_adaptive.cu).
//
// Every kernel runs ONE CTA that walks the logical blocks of a call in
// order (the TPU grid's sequential carry).  What they share:
//
//   * A staging area in shared memory.  A window of whole logical blocks
//     has its lanes hashed once (fingerprint, home and alternate bucket,
//     the staged index of each of the two rows) and the home and
//     alternate rows of its valid lanes copied in once with cp.async,
//     deduplicated through an open-addressing map (bucket -> staged row),
//     so that a row shared by two lanes or two logical blocks is one copy
//     and every later read sees every earlier write.  A row that is not
//     staged (an eviction chain's random bucket, or a row that did not
//     fit) is read and written in device memory.  Membership is fixed for
//     the window, so each row has one authoritative copy, and the staged
//     rows that were written go back at the end of the window.
//   * Four planes (the adaptive kernels): the delete, which reads a
//     selector word for every lane, stages each row's ``bsz``
//     fingerprints plus, in a parallel array (``sels`` given), its packed
//     selector word, kept apart so that the fingerprints stay 16-byte
//     aligned for cp.async; its 2-bit fields are set with shared-memory
//     atomics (ocf::set_sel).  The insert reads a selector only for a
//     kicked victim and stages fingerprints alone.  The mirror key planes
//     khi / klo are never staged: they are read only for a kicked victim
//     and in rollback, and are written straight through to device memory.
//   * The launch's other CTAs (one a 256 keys, up to 131) only hash the
//     call's keys and prefetch their two rows (and selector words) into
//     L2, so that the staging copies of CTA 0, which does all the work,
//     hit L2.
//   * The conflict ranks of a round (``rank_round``): two count tables
//     find the lanes whose key no other lane has (rank 0) with one
//     barrier; only the rest count their earlier lanes.
//   * The inserts' dirty set (kicked slots, local to a logical block) and
//     stash spill.
//   * The per-call plan: window, capacities, and whether the per-lane
//     region (lane state, rank tables, kick history, dirty set, stash
//     copy) fits in shared memory beside the staging area.  It does on
//     the main path (block 128, 32 rounds); a call whose worst case does
//     not fit gets the same region in a device-memory buffer that the
//     wrapper allocates (a second instantiation of the same kernel).
#pragma once

#include "ocf_common.cuh"

namespace stg {

constexpr int kThreads = 256;
constexpr uint32_t kFull = 0xFFFFFFFFu;
constexpr uint32_t kNone = 0xFFFFFFFFu;       // row index: not staged
constexpr uint16_t kNone16 = 0xFFFFu;         // ... as a map value
constexpr uint32_t kPending = 0xFFFFFFFEu;    // row index: to look up
constexpr int kStageProbes = 64;              // staging map probe limit
// 227 KB a CTA on the H100 (232448 B, static and dynamic together); 1 KB
// is left for the kernels' static shared memory.
constexpr size_t kSmemMax = 232448 - 1024;
constexpr size_t kLaneSmemMax = 96 * 1024;    // per-lane region on chip

__host__ __device__ inline size_t align16(size_t x) {
  return (x + 15) & ~size_t(15);
}

// Lay one array of a region out: its address from ``base`` (null: only
// count) and the offset advanced past it, 16-byte aligned.
__host__ __device__ inline uint8_t* take(uint8_t* base, size_t& off,
                                         size_t bytes) {
  uint8_t* p = base ? base + off : nullptr;
  off += align16(bytes);
  return p;
}


struct Plan {
  int window;        // lanes staged at once (a multiple of the block)
  int cap_m;         // staging map entries
  int row_cap;       // staged rows
  int lane_smem;     // 1: the per-lane region lives in shared memory
  size_t lane_bytes; // bytes of the per-lane region
  size_t smem;       // dynamic shared memory of the launch
};

// Staged bytes per lane: its hash and row indices (20 bytes), two rows
// with their bucket and written flag (and selector word, ``sel_rows``),
// six map entries (key, 16-bit value) per two rows (load <= 1/3: a warp
// waits for its longest linear probe, so the tail matters, not the mean).
inline Plan make_plan(int n, int block, int bsz, size_t lane_bytes,
                      bool sel_rows = false) {
  Plan p;
  p.lane_bytes = align16(lane_bytes);
  p.lane_smem = p.lane_bytes <= kLaneSmemMax;
  const size_t avail = kSmemMax - (p.lane_smem ? p.lane_bytes : 0) - 64;
  const size_t row_bytes = (size_t)bsz * 4;
  const size_t sel_bytes = sel_rows ? 4 : 0;
  const size_t per_lane = 20 + 2 * (row_bytes + sel_bytes + 5) + 6 * 6;
  size_t fit = avail / per_lane / (size_t)block * (size_t)block;
  if (fit >= (size_t)block) {
    p.window = (int)(fit < (size_t)n ? fit : (size_t)n);
    p.cap_m = 6 * p.window + 1;
    p.row_cap = 2 * p.window;
  } else {
    // One logical block's rows do not all fit: stage what does; the rest
    // of the block's rows stay in device memory.
    p.window = block;
    const size_t rest = avail - 5 * align16((size_t)block * 4);
    p.cap_m = (int)(rest / 3 / 6);
    p.row_cap = (int)((rest - (size_t)p.cap_m * 6) /
                      (row_bytes + sel_bytes + 5) - 8);
    if (p.row_cap > 65535) p.row_cap = 65535;
  }
  p.smem = 5 * align16((size_t)p.window * 4) +
           align16((size_t)p.row_cap * row_bytes) + align16(p.row_cap) +
           align16((size_t)p.row_cap * 4) + align16((size_t)p.cap_m * 4) +
           align16((size_t)p.cap_m * 2) +
           (sel_rows ? align16((size_t)p.row_cap * 4) : 0) +
           (p.lane_smem ? p.lane_bytes : 0);
  return p;
}

__device__ __forceinline__ uint32_t lanemask_lt() {
  uint32_t m;
  asm("mov.u32 %0, %%lanemask_lt;" : "=r"(m));
  return m;
}

__device__ __forceinline__ uint32_t slot_of(uint32_t h, int cap) {
  return __umulhi(h, (uint32_t)cap);
}

// ------------------------------------------------------------ staging --

struct Stage {
  uint32_t* table;   // device memory, [buffer, bsz]
  uint32_t* sels;    // device memory, [buffer]: packed selectors (or null)
  int bsz;
  uint32_t* rows;    // shared: row_cap x bsz
  uint32_t* rsel;    // shared: each staged row's selector word (with sels)
  uint8_t* mod;      // shared: row written since staged
  uint32_t* rb;      // shared: bucket of each staged row
  uint32_t* keys;    // shared: bucket + 1, 0 = empty
  uint16_t* vals;    // shared: staged row index or kNone16
  uint32_t* wfp;     // shared: the window's lanes: fingerprint (0: invalid)
  uint32_t* wi1;     //   home bucket
  uint32_t* wi2;     //   alternate bucket
  uint32_t* wr1;     //   staged index of the home row (or kNone)
  uint32_t* wr2;     //   ... of the alternate row
  int cap_m, row_cap;
  int copy;          // cp.async size: 16, 8 or 4 bytes
};

// The staging area at the start of dynamic shared memory -> the per-lane
// region's place there (used when the plan keeps it on chip).
__device__ inline uint8_t* carve_stage(Stage& S, uint8_t* smem, const Plan& P,
                                       uint32_t* table, int bsz, int copy,
                                       uint32_t* sels = nullptr) {
  size_t off = 0;
  S.table = table;
  S.sels = sels;
  S.bsz = bsz;
  S.cap_m = P.cap_m;
  S.row_cap = P.row_cap;
  S.copy = copy;
  S.rows = (uint32_t*)take(smem, off, (size_t)P.row_cap * bsz * 4);
  S.wfp = (uint32_t*)take(smem, off, (size_t)P.window * 4);
  S.wi1 = (uint32_t*)take(smem, off, (size_t)P.window * 4);
  S.wi2 = (uint32_t*)take(smem, off, (size_t)P.window * 4);
  S.wr1 = (uint32_t*)take(smem, off, (size_t)P.window * 4);
  S.wr2 = (uint32_t*)take(smem, off, (size_t)P.window * 4);
  S.mod = take(smem, off, P.row_cap);
  S.rb = (uint32_t*)take(smem, off, (size_t)P.row_cap * 4);
  S.keys = (uint32_t*)take(smem, off, (size_t)P.cap_m * 4);
  S.vals = (uint16_t*)take(smem, off, (size_t)P.cap_m * 2);
  S.rsel = sels ? (uint32_t*)take(smem, off, (size_t)P.row_cap * 4) : nullptr;
  return smem + off;
}

// cp.async size for a table's rows: 16, 8 or 4 bytes, as row size and
// alignment allow.
inline int copy_size(const void* table, int bsz) {
  const size_t row_bytes = (size_t)bsz * 4;
  const uintptr_t t = (uintptr_t)table;
  if (row_bytes % 16 == 0 && t % 16 == 0) return 16;
  if (row_bytes % 8 == 0 && t % 8 == 0) return 8;
  return 4;
}

__device__ __forceinline__ void cp_async(void* dst, const void* src, int size) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  const size_t s = __cvta_generic_to_global(src);
  if (size == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
                 ::"r"(d), "l"(s));
  else if (size == 8)
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(d), "l"(s));
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d), "l"(s));
}

__device__ __forceinline__ void prefetch_l2(const void* p) {
  asm volatile("prefetch.global.L2 [%0];\n" ::"l"(__cvta_generic_to_global(p)));
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::: "memory");
}

// Claim row b's map entry -> true for the one thread that inserted it
// (its entry at ``pos``); false when it was there already, or when the
// probe limit is reached (the row then stays in device memory).
__device__ inline bool claim_row(const Stage& S, uint32_t b, uint32_t& pos) {
  const uint32_t key = b + 1u;
  pos = slot_of(ocf::murmur3_mix(key), S.cap_m);
  for (int probe = 0; probe < kStageProbes; ++probe) {
    uint32_t k = S.keys[pos];
    if (k == 0u) k = atomicCAS(&S.keys[pos], 0u, key);
    if (k == 0u) return true;
    if (k == key) return false;
    pos = pos + 1 == (uint32_t)S.cap_m ? 0 : pos + 1;
  }
  return false;
}

// Row b's copy given the staged index row_of found for it.
__device__ __forceinline__ uint32_t* row_at(const Stage& S, uint32_t idx,
                                            uint32_t b) {
  return idx == kNone ? S.table + (size_t)b * S.bsz
                      : S.rows + (size_t)idx * S.bsz;
}

// The authoritative copy of row b: a staged row (idx set) or device memory.
__device__ inline uint32_t* row_of(const Stage& S, uint32_t b, uint32_t& idx) {
  const uint32_t key = b + 1u;
  uint32_t pos = slot_of(ocf::murmur3_mix(key), S.cap_m);
  idx = kNone;
  for (int probe = 0; probe < kStageProbes; ++probe) {
    const uint32_t k = S.keys[pos];
    if (k == key) {
      if (S.vals[pos] != kNone16) idx = S.vals[pos];
      break;
    }
    if (k == 0u) break;
    pos = pos + 1 == (uint32_t)S.cap_m ? 0 : pos + 1;
  }
  return row_at(S, idx, b);
}

__device__ __forceinline__ void row_write(const Stage& S, uint32_t* row,
                                          uint32_t idx, int slot, uint32_t v) {
  row[slot] = v;
  if (idx != kNone) S.mod[idx] = 1;
}

// Row b's packed selector word, beside the copy that row_at gives.
__device__ __forceinline__ uint32_t* sel_at(const Stage& S, uint32_t idx,
                                            uint32_t b) {
  return idx == kNone ? S.sels + b : S.rsel + idx;
}

// ... its value.  A word in device memory is read from L2 (ld.global.cg):
// its fields are set with atomics, which L2 performs, so an L1 line
// loaded before them would be stale.
__device__ __forceinline__ uint32_t sel_read(const Stage& S, uint32_t idx,
                                             uint32_t b) {
  return idx == kNone ? __ldcg(S.sels + b) : S.rsel[idx];
}

// Start a window of lanes [w0, w1): hash each lane once into the window
// arrays, claim the distinct home and alternate rows of the valid lanes
// (lane w's h-th row, when it claims it, takes staged row 2 w + h: no
// counter) and copy them in, noting each lane's two staged row indices (a
// lane whose row another lane claimed looks it up once the claims are
// done).
__device__ void stage_window(const Stage& S, int w0, int w1,
                             const uint32_t* hi, const uint32_t* lo,
                             const uint8_t* valid, int fp_bits, uint32_t nb) {
  const int nw = w1 - w0;
  for (int i = threadIdx.x; i < S.cap_m; i += blockDim.x) S.keys[i] = 0u;
  for (int r = threadIdx.x; r < min(2 * nw, S.row_cap); r += blockDim.x)
    S.mod[r] = 0;
#pragma unroll 4
  for (int i = w0 + threadIdx.x; i < w1; i += blockDim.x) {
    uint32_t fp = 0u, b1 = 0u, b2 = 0u;
    if (valid[i]) {
      const uint32_t h = hi[i], l = lo[i];
      fp = ocf::fingerprint(h, l, fp_bits);
      b1 = ocf::index_hash(h, l, nb);
      b2 = ocf::alt_index(b1, fp, nb);
    }
    S.wfp[i - w0] = fp;
    S.wi1[i - w0] = b1;
    S.wi2[i - w0] = b2;
  }
  __syncthreads();
  for (int w = threadIdx.x; w < nw; w += blockDim.x) {
    if (S.wfp[w] == 0u) continue;
    for (int h = 0; h < 2; ++h) {
      uint32_t* wr = h ? S.wr2 : S.wr1;
      const uint32_t b = h ? S.wi2[w] : S.wi1[w];
      const uint32_t idx = 2u * w + h;
      uint32_t pos;
      if (!claim_row(S, b, pos)) {
        wr[w] = kPending;  // resolved below
      } else if (idx < (uint32_t)S.row_cap) {
        S.vals[pos] = (uint16_t)idx;
        S.rb[idx] = b;
        wr[w] = idx;
      } else {
        S.vals[pos] = kNone16;
        wr[w] = kNone;
      }
    }
  }
  __syncthreads();
  // The claimed rows' copies, all issued before any is waited for.
  for (int w = threadIdx.x; w < nw; w += blockDim.x) {
    if (S.wfp[w] == 0u) continue;
    for (int h = 0; h < 2; ++h) {
      const uint32_t idx = 2u * w + h;
      if ((h ? S.wr2[w] : S.wr1[w]) != idx) continue;
      uint8_t* dst = reinterpret_cast<uint8_t*>(S.rows + (size_t)idx * S.bsz);
      const uint8_t* src = reinterpret_cast<const uint8_t*>(
          S.table + (size_t)(h ? S.wi2[w] : S.wi1[w]) * S.bsz);
      for (int o = 0; o < S.bsz * 4; o += S.copy)
        cp_async(dst + o, src + o, S.copy);
      if (S.sels)
        cp_async(S.rsel + idx, S.sels + (h ? S.wi2[w] : S.wi1[w]), 4);
    }
  }
  cp_async_wait_all();
  __syncthreads();
  // Lanes whose row another lane claimed (or past the probe limit).
  for (int w = threadIdx.x; w < nw; w += blockDim.x) {
    uint32_t idx;
    if (S.wfp[w] != 0u && S.wr1[w] == kPending) {
      row_of(S, S.wi1[w], idx);
      S.wr1[w] = idx;
    }
    if (S.wfp[w] != 0u && S.wr2[w] == kPending) {
      row_of(S, S.wi2[w], idx);
      S.wr2[w] = idx;
    }
  }
  __syncthreads();
}

// CTAs 1.. of the launch: warm L2 with the keys and the home and
// alternate rows (and selector words, with ``sels``) of the call's valid
// lanes, in lane order, so that CTA 0's staging copies hit L2 instead of
// device memory.  They write nothing.
__device__ void warm_l2(const uint32_t* table, int bsz, const uint32_t* hi,
                        const uint32_t* lo, const uint8_t* valid, int n,
                        int fp_bits, uint32_t nb,
                        const uint32_t* sels = nullptr) {
  const int stride = (gridDim.x - 1) * blockDim.x;
  for (int i = (blockIdx.x - 1) * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    if (!valid[i]) continue;
    const uint32_t fp = ocf::fingerprint(hi[i], lo[i], fp_bits);
    const uint32_t b1 = ocf::index_hash(hi[i], lo[i], nb);
    const uint32_t b2 = ocf::alt_index(b1, fp, nb);
    prefetch_l2(table + (size_t)b1 * bsz);
    prefetch_l2(table + (size_t)b2 * bsz);
    if (sels) {
      prefetch_l2(sels + b1);
      prefetch_l2(sels + b2);
    }
  }
}

// CTAs of a launch over n keys: CTA 0 and up to one L2-warming CTA a 256
// keys, within the card's 132 SMs (one CTA fits an SM).
inline int launch_ctas(int n) {
  const int warm = (n + kThreads - 1) / kThreads;
  return 1 + (warm < 131 ? warm : 131);
}

// End a window of ``nw`` lanes: written staged rows back to device memory.
__device__ void write_back(const Stage& S, int nw) {
  const int n = min(2 * nw, S.row_cap);
  for (int r = threadIdx.x; r < n; r += blockDim.x) {
    if (!S.mod[r]) continue;
    const uint32_t* src = S.rows + (size_t)r * S.bsz;
    uint32_t* dst = S.table + (size_t)S.rb[r] * S.bsz;
    if (S.bsz == 4 && S.copy == 16)
      *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(src);
    else
      for (int s = 0; s < S.bsz; ++s) dst[s] = src[s];
    if (S.sels) S.sels[S.rb[r]] = S.rsel[r];
  }
  __syncthreads();
}

// -------------------------------------------------------------- ranks --
//
// rank(j) = #earlier lanes of the round with lane j's key (bucket, or
// (bucket, fingerprint) for delete), the reference's rank_among_earlier.
// Nearly every key of a round is unique, so a round first finds the lanes
// that are alone: each lane adds one to a slot of each of two count
// tables (two hashes of its key).  A lane whose slot counts 1 in either
// table shares its key with no other lane (equal keys land in the same
// slots), so its rank is 0.  The rest count the earlier lanes with their
// key exactly, saturated at a bound the caller gives (a rank past the
// bucket size never places or clears anything).

struct Crowd {
  uint32_t* cnt;    // 2 x cap: lanes of the round in each slot
  uint32_t* slots;  // 2 x block: each lane's two slots this round
  int cap;
};

// Slots per table: at least 32 a lane of the block, a power of two.  A
// lane shares both slots with others with odds ~(block / cap)^2, ~1e-3.
__host__ __device__ inline int crowd_cap(int block) {
  int c = 1024;
  while (c < 32 * block && c < 65536) c <<= 1;
  return c;
}

__host__ __device__ inline Crowd carve_crowd(uint8_t* base, size_t& off,
                                             int block) {
  Crowd C;
  C.cap = crowd_cap(block);
  C.cnt = (uint32_t*)take(base, off, 8 * (size_t)C.cap);
  C.slots = (uint32_t*)take(base, off, 8 * (size_t)block);
  return C;
}

// The ranks of one round over lanes [0, nl), exact below ``sat``.
// ``key(j, k)`` says whether lane j takes part and its key; ``then(j,
// rank)`` runs for each lane that does (it may read the table: nothing
// writes it during the ranking).  The caller runs crowd_clear for those
// lanes in its write pass; the counts start at zero.
template <class Key, class Then>
__device__ void rank_round(const Crowd& C, int nl, uint32_t sat, Key key,
                           Then then) {
  for (int j = threadIdx.x; j < nl; j += blockDim.x) {
    uint64_t k;
    if (!key(j, k)) continue;
    const uint32_t h = ocf::murmur3_mix(
        (uint32_t)k ^ ocf::murmur3_mix((uint32_t)(k >> 32) + 0x9E3779B9u));
    const uint32_t s0 = slot_of(h, C.cap);
    const uint32_t s1 = C.cap + slot_of(ocf::murmur3_mix(h ^ 0x5BD1E995u),
                                        C.cap);
    C.slots[2 * j] = s0;
    C.slots[2 * j + 1] = s1;
    atomicAdd(&C.cnt[s0], 1u);
    atomicAdd(&C.cnt[s1], 1u);
  }
  __syncthreads();
  for (int j = threadIdx.x; j < nl; j += blockDim.x) {
    uint64_t k;
    if (!key(j, k)) continue;
    uint32_t r = 0;
    if (C.cnt[C.slots[2 * j]] > 1u && C.cnt[C.slots[2 * j + 1]] > 1u) {
      // Branch-free, so the loads pipeline; saturated afterwards.
#pragma unroll 8
      for (int i = 0; i < j; ++i) {
        uint64_t ki;
        r += (key(i, ki) && ki == k) ? 1u : 0u;
      }
      r = min(r, sat);
    }
    then(j, r);
  }
}

__device__ __forceinline__ void crowd_clear(const Crowd& C, int j) {
  C.cnt[C.slots[2 * j]] = 0u;
  C.cnt[C.slots[2 * j + 1]] = 0u;
}

// Position of the rank-th slot of ``row`` equal to ``value`` (or -1).
__device__ __forceinline__ int nth_equal(const uint32_t* row, int bsz,
                                         uint32_t value, uint32_t rank) {
  if (bsz == 4 && ((uintptr_t)row & 15) == 0) {
    const uint4 v = *reinterpret_cast<const uint4*>(row);
    const uint32_t w[4] = {v.x, v.y, v.z, v.w};
    uint32_t seen = 0;
#pragma unroll
    for (int s = 0; s < 4; ++s)
      if (w[s] == value && seen++ == rank) return s;
    return -1;
  }
  uint32_t seen = 0;
  for (int s = 0; s < bsz; ++s)
    if (row[s] == value && seen++ == rank) return s;
  return -1;
}

// ------------------------------------------- inserts: dirty set, spill --
//
// The dirty set holds the kicked slots of a logical block, (bucket *
// bsz + slot + 1), 0 empty, kFull a tombstone: kicks add to it, a lane
// that lands releases its chain, and it is cleared when a block that
// kicked ends.  At most block x rounds kicks a block: capacity 3/2 of it.

__host__ __device__ inline int dirty_cap(int block, int rounds) {
  return rounds > 0 ? (int)(3 * (long long)block * rounds / 2 + 1) : 1;
}

struct Dirty {
  uint32_t* d;
  int cap;
  __device__ bool has(uint32_t key) const {
    uint32_t p = slot_of(ocf::murmur3_mix(key), cap);
    for (;;) {
      const uint32_t k = d[p];
      if (k == key) return true;
      if (k == 0u) return false;
      p = p + 1 == (uint32_t)cap ? 0 : p + 1;
    }
  }
  __device__ void add(uint32_t key) const {
    uint32_t p = slot_of(ocf::murmur3_mix(key), cap);
    while (atomicCAS(&d[p], 0u, key) != 0u)
      p = p + 1 == (uint32_t)cap ? 0 : p + 1;
  }
  __device__ void del(uint32_t key) const {  // leaves a tombstone
    uint32_t p = slot_of(ocf::murmur3_mix(key), cap);
    while (d[p] != key) p = p + 1 == (uint32_t)cap ? 0 : p + 1;
    d[p] = kFull;
  }
};

// Exhausted lanes (``bit`` set in ``flags``), in lane order, take the
// free slots of the stash's staged copy (2 x S) in slot order (the
// reference's lane-order prefix sum): lane j parks (fp[j], tgt[j]), loses
// ``bit`` and gains ``kMark`` (a telemetry instantiation's spill mark; 0
// leaves no trace).  Two ballot scans of one warp (free slots into
// ``freel``, then lanes); the other warps return at once.
template <uint8_t kMark = 0>
__device__ void spill(int nl, int S, uint32_t* stash, uint32_t* freel,
                      uint8_t* flags, uint8_t bit, const uint32_t* fp,
                      const uint32_t* tgt) {
  if (threadIdx.x >= 32) return;
  const int ln = threadIdx.x;
  const uint32_t lt = lanemask_lt();
  int nfree = 0;
  for (int s0 = 0; s0 < S; s0 += 32) {
    const int s = s0 + ln;
    const bool f = s < S && stash[s] == 0u;
    const uint32_t m = __ballot_sync(kFull, f);
    if (f) freel[nfree + __popc(m & lt)] = s;
    nfree += __popc(m);
  }
  __syncwarp();
  int taken = 0;
  for (int j0 = 0; j0 < nl && taken < nfree; j0 += 32) {
    const int j = j0 + ln;
    const bool a = j < nl && (flags[j] & bit);
    const uint32_t m = __ballot_sync(kFull, a);
    const int k = taken + __popc(m & lt);
    if (a && k < nfree) {
      const uint32_t s = freel[k];
      stash[s] = fp[j];
      stash[S + s] = tgt[j];
      flags[j] = (flags[j] & ~bit) | kMark;
    }
    taken += __popc(m);
  }
}

// ------------------------------------------------- inserts: telemetry --
//
// An insert's telemetry instantiation counts, per logical block, into
// kTmCounters shared counters that last across the serial walk: the
// kick-depth histogram of the valid lanes (bins of the chain's kicks:
// 0, 1, 2, 3-4, 5-8, 9-16, 17-32, 33+), the lanes that spilled to the
// stash, the lanes that rolled back.  CTA 0 adds them to the launch's
// plane once, after the walk.  Sums do not depend on thread order.

constexpr int kTmCounters = 10;

__device__ __forceinline__ int kick_bin(uint32_t steps) {
  return steps <= 2u ? (int)steps : min(7, 33 - __clz(steps - 1u));
}

// Count the block's nl lanes, after the spill and before the rollback:
// lanes with ``kValidBit`` by kicks, lanes with ``kSpillBit``, and, when
// the call has eviction rounds, lanes still carrying (``kActiveBit``: the
// reference counts no rollback without rounds).  Lane j is read by the
// thread that owns it in the walk's loops.  Most valid lanes place without
// a kick: one ballot a warp counts those; the few others add one apiece.
template <uint8_t kValidBit, uint8_t kActiveBit, uint8_t kSpillBit>
__device__ void count_lanes(int nl, const uint8_t* flags,
                            const uint32_t* steps, bool rollbacks,
                            uint32_t* tm) {
  const int nw = (nl + 31) & ~31;  // whole warps run the ballot
  for (int j = threadIdx.x; j < nw; j += blockDim.x) {
    const bool in = j < nl;
    const uint8_t f = in ? flags[j] : 0;
    const uint32_t st = in ? steps[j] : 0u;
    const bool valid = (f & kValidBit) != 0;
    const uint32_t m = __ballot_sync(kFull, valid && st == 0u);
    if ((threadIdx.x & 31) == 0 && m) atomicAdd(&tm[0], (uint32_t)__popc(m));
    if (valid && st != 0u) atomicAdd(&tm[kick_bin(st)], 1u);
    if (f & kSpillBit) atomicAdd(&tm[8], 1u);
    if (rollbacks && (f & kActiveBit)) atomicAdd(&tm[9], 1u);
  }
}

}  // namespace stg
