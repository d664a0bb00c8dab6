// scan_insert / scan_delete: the sequential insert and delete walks of the
// scan backend, redesigned for the H100 so that independent lanes overlap
// while every result stays the sequential walk's, bit for bit.
//
// Replaces the reference's lax.scan cores, not a pallas_call:
// repro/core/filter.py::_insert_one (walked by bulk_insert, :146, and by
// repro/distributed/elastic.py::insert_pairs, :125) and the per-key body
// of repro/core/filter.py::bulk_delete (:240).  Semantics are in
// repro_torch/kernels/scan.py; the plain versions there (the sequential
// host walks) are held against these kernels bit for bit.
//
// ---------------------------------------------------------------- insert --
// One CTA a shard, every shard in one launch, kThreads threads a CTA.  The
// wrapper has compacted each shard's valid lanes (order kept); the CTA
// takes them in windows of at most W lanes.  For each window:
//
//   1. Speculate (every thread, the table only read).  A lane loads rows
//      i1 and i2 and records which of their slots are empty (two masks).
//      A lane whose two rows are full walks its eviction chain against the
//      same table through a private overlay of its own writes, for at most
//      kChainSteps steps (and within max_disp), recording every row it
//      visits and the value it leaves there (a chain record in shared
//      memory, kChainPool a window); a longer or unrecorded chain is
//      marked for the serial walk.
//   2. Decide (every warp, a 32-lane chunk at a time): for each lane, from
//      its neighbours within 31 lanes on either side (all pairs by
//      __shfl_sync), its rank among the earlier ones with its i1, the
//      placement that rank gives (the rank-th empty slot of i1, else the
//      first of i2, else none), and whether its i2 is a neighbour's i1 or
//      i2 ("cross").  A lane left with none (the earlier lanes of its i1
//      fill it, and i2 is full) speculates its chain from i2 into a
//      record as in step 1.
//   3. Commit in lane order (warp 0).  The dirty set holds the rows
//      written so far in this window.  The warp takes 32 lanes at a time.
//      Its eligible prefix is the lanes up to the first one that is not
//      direct or has a dirty row.  If no lane of the prefix is cross, the
//      prefix takes its decided placements all at once; otherwise it is
//      placed lane by lane from the masks, each placement broadcast and
//      taken out of the later lanes' masks for that row.  Either stops
//      before a lane whose rows have filled.  A run of one i1 that goes on
//      past the 32 lanes is left whole to the next step (the pair mode's
//      lanes come a source bucket at a time).  The lane that ends the
//      prefix is committed by one thread: a chain record whose rows are
//      all clean is applied as recorded if i1 is full (clean, for a lane
//      whose rows were both full in the snapshot; else read from the live
//      table); any other lane walks from the live table exactly as the
//      sequential walk does (eviction, history in shared memory,
//      rollback, stash spill), marking every row it writes.  The stash is
//      touched only here, in lane order.
//   4. A window that had more chains than records makes the next one
//      smaller (to fit them), one with few grows it back towards W.
//
// Why the result is the sequential walk's.  Claim: when the commit of
// window w begins, the table is the sequential walk's after the lanes
// before w, and every lane of w is committed to the sequential walk's
// effect.  Induction on w.  Window 0's speculation reads the input table;
// window w+1's speculation starts after the __syncthreads() that ends
// window w's commit, which orders the committer's global writes before
// every later read of the CTA, so each window's snapshot is the table
// after all earlier windows (the hypothesis).  Within a window, induction
// on the lanes: before lane k commits, the live table is the sequential
// one after lanes < k.  A lane's speculation is a function of the rows it
// read in the snapshot only (for a direct lane i1 and i2; for a chain, i1
// and every row it visited).  A row not in the dirty set was not written
// since the snapshot, so if all of the lane's rows are clean, the live
// rows equal the snapshot's and the speculated effect is the sequential
// one; a chain record also holds when i1 is full in the live table, since
// the walk then starts at i2 (full: clean) and reads only the record's
// rows.  Lanes of one prefix commit together: an earlier lane of the
// prefix writes only the one slot it takes, so a later lane's rows hold
// the snapshot's values less the slots earlier lanes took there, which is
// what the lane-by-lane masks hold, and the slots the prefix takes are
// distinct.  In the all-at-once case no prefix lane's i2 is another's
// row, so a lane's rows are written before it only by the earlier prefix
// lanes of its i1, each taking i1's next empty slot while it had room (a
// lane past the room takes its private i2).  Its rank counts them: a
// neighbour before the prefix with the same i1 was committed earlier in
// the window and, had i1 had room, took a slot there and made it dirty;
// so for a clean lane whose i1 has room every neighbour it counts is in
// the prefix, and the rank-th empty slot is the first one left.  A lane with
// a dirty row walks the live table serially, which is the sequential walk by
// the hypothesis.  Marking every written row keeps the dirty set a superset
// of the rows written since the snapshot; the set is a bitmap indexed by row
// mod its size, so rows that alias only cost a serial walk.
//
// ---------------------------------------------------------------- delete --
// A delete lane reads and clears only slots of its two buckets that hold
// its own fingerprint.  Lanes with different fingerprints never read a
// slot's value the other writes (a cleared slot holds 0, and a fingerprint
// is never 0), and lanes with one fingerprint but no shared bucket touch
// different slots.  alt is an involution, alt(alt(i, f), f) = i, so two
// lanes with the same fingerprint that share a bucket have the same
// unordered pair {i1, i2} = {min, alt(min, f)}.  So lanes commute unless
// they share (shard, fp, min(i1, i2)), the conflict key.  The wrapper sorts
// the compacted lanes by a 64-bit function of that key, stably, so lanes
// of one key are adjacent and in lane order (keys that collide in the
// function only merge groups, which keeps the order and costs
// parallelism).  One thread walks each group in that order; groups run in
// parallel over the grid.  A self-pair (i1 == i2) has the key (fp, i1) and
// looks in the one bucket twice, as the sequential walk does; a second
// delete of one key is in the first one's group, after it, and finds the
// slot cleared, exactly as in the sequential walk.
#include "ocf_common.cuh"

namespace {

// The CTA, the window's chain records and their length were set from H100
// runs (tools/scan_probe.py).
constexpr int kThreads = 1024;
constexpr int kChainSteps = 8;    // longest speculated chain
constexpr int kChainPool = 256;   // chain records a window
constexpr int kRec = kChainSteps + 1;  // rows of a record
constexpr unsigned kFull = 0xFFFFFFFFu;
constexpr unsigned kMaxDirtyBits = 1u << 20;  // 128 KB of bitmap

// First empty slot of a row -> its index, or -1.
__device__ __forceinline__ int first_empty(const uint32_t* row, int bs) {
  for (int j = 0; j < bs; ++j)
    if (row[j] == 0u) return j;
  return -1;
}

// The window's dirty set: one bit a row, indexed by row mod 32 * words.
struct Dirty {
  uint32_t* bits;
  uint32_t mask;  // bits in the map - 1 (a power of two)
  __device__ __forceinline__ bool test(uint32_t row) const {
    const uint32_t b = row & mask;
    return (bits[b >> 5] >> (b & 31u)) & 1u;
  }
  __device__ __forceinline__ void mark(uint32_t row) const {
    const uint32_t b = row & mask;
    atomicOr(bits + (b >> 5), 1u << (b & 31u));
  }
};

__device__ __forceinline__ bool place(uint32_t* t, uint32_t row, int bs,
                                      uint32_t f, const Dirty& d) {
  uint32_t* r = t + (size_t)row * bs;
  const int j = first_empty(r, bs);
  if (j < 0) return false;
  r[j] = f;
  d.mark(row);
  return true;
}

// The sequential walk of one lane on the live table (scan.py's
// _insert_one, then the stash spill), marking every row it writes.
__device__ bool walk_lane(uint32_t* t, int bs, uint32_t n, uint32_t f,
                          uint32_t i1, uint32_t i2, uint32_t* st, int slots,
                          uint32_t* hist, int max_disp, const Dirty& d) {
  if (place(t, i1, bs, f, d) || place(t, i2, bs, f, d)) return true;
  uint32_t i = i2, cur = f;
  int step = 0;
  bool done = false;
  while (!done && step < max_disp) {
    const int j = step % bs;
    const uint32_t old = t[(size_t)i * bs + j];
    t[(size_t)i * bs + j] = cur;
    d.mark(i);
    hist[step] = i;
    cur = old;
    i = ocf::alt_index(i, cur, n);
    done = place(t, i, bs, cur, d);
    ++step;
  }
  if (done) return true;
  for (int idx = step - 1; idx >= 0; --idx) {
    uint32_t* slot = t + (size_t)hist[idx] * bs + idx % bs;
    const uint32_t old = *slot;
    *slot = cur;
    cur = old;
  }
  if (st) {
    for (int e = 0; e < slots; ++e) {
      if (st[e] == 0u) {
        st[e] = f;
        st[slots + e] = i2;
        return true;
      }
    }
  }
  return false;
}

// A slot as a speculated chain sees it: its own latest write there (step q
// wrote slot q % bs of rows[q]), else the window's snapshot.
__device__ __forceinline__ uint32_t chain_view(const uint32_t* t, int bs,
                                               const uint32_t* rows,
                                               const uint32_t* vals,
                                               int count, uint32_t r, int j) {
  for (int q = count - 1; q >= 0; --q)
    if (rows[q] == r && q % bs == j) return vals[q];
  return t[(size_t)r * bs + j];
}

// Speculate the eviction chain of a lane whose rows are both full, on the
// snapshot, writing nothing to the table -> its record's meta (steps |
// final slot << 16), or -1 if it does not end within `limit` steps
// (kChainSteps, or max_disp if that is smaller: the walk's own budget).
// rows[q] / vals[q] for q < steps: step q writes vals[q] into slot q % bs
// of rows[q]; rows[steps] / vals[steps]: the final placement.
__device__ int speculate_chain(const uint32_t* t, int bs, uint32_t n,
                               uint32_t f, uint32_t i2, int limit,
                               uint32_t* rows, uint32_t* vals) {
  uint32_t i = i2, cur = f;
  for (int step = 0; step < limit; ++step) {
    const uint32_t old = chain_view(t, bs, rows, vals, step, i, step % bs);
    rows[step] = i;
    vals[step] = cur;
    cur = old;
    i = ocf::alt_index(i, cur, n);
    for (int j = 0; j < bs; ++j) {
      if (chain_view(t, bs, rows, vals, step + 1, i, j) == 0u) {
        rows[step + 1] = i;
        vals[step + 1] = cur;
        return (step + 1) | (j << 16);
      }
    }
  }
  return -1;
}

// Empty-slot masks of a lane's two rows, both loaded before either is
// compared (one 16-byte load each where vec: bucket_size 4 on a 16-byte
// aligned table) -> the lane's direct code: bit j of the low kMaskBits
// set if slot j of i1 is empty, bit j above them if slot j of i2 is; 0 if
// both rows are full.  Rows wider than kMaskBits slots give -1 (the serial
// walk) unless both are full.
constexpr int kMaskBits = 15;
constexpr uint32_t kMaskLow = (1u << kMaskBits) - 1u;

__device__ __forceinline__ int direct_code(const uint32_t* t, int bs,
                                           bool vec, uint32_t i1,
                                           uint32_t i2) {
  uint32_t m1, m2;
  if (vec) {
    const uint4 r1 = *reinterpret_cast<const uint4*>(t + (size_t)i1 * 4);
    const uint4 r2 = *reinterpret_cast<const uint4*>(t + (size_t)i2 * 4);
    m1 = (r1.x == 0u) | (r1.y == 0u) << 1 | (r1.z == 0u) << 2 |
         (r1.w == 0u) << 3;
    m2 = (r2.x == 0u) | (r2.y == 0u) << 1 | (r2.z == 0u) << 2 |
         (r2.w == 0u) << 3;
  } else {
    bool any1 = false, any2 = false;
    m1 = m2 = 0u;
    for (int j = 0; j < bs; ++j) {
      const bool e1 = t[(size_t)i1 * bs + j] == 0u;
      const bool e2 = t[(size_t)i2 * bs + j] == 0u;
      any1 |= e1;
      any2 |= e2;
      if (j < kMaskBits) {
        m1 |= (uint32_t)e1 << j;
        m2 |= (uint32_t)e2 << j;
      }
    }
    if (bs > kMaskBits) return any1 || any2 ? -1 : 0;
  }
  return (int)(m1 | m2 << kMaskBits);
}

// Index of the (r+1)-th lowest set bit of m (r < popc(m)).
__device__ __forceinline__ int nth_set(uint32_t m, int r) {
  for (; r > 0; --r) m &= m - 1u;
  return __ffs(m) - 1;
}

// Dynamic shared memory of the insert kernel, in 32-bit words.
struct Layout {
  int dirty_words, window, max_disp;
  bool vec;
  __host__ __device__ size_t words() const {
    return (size_t)dirty_words + 4 * (size_t)window + (window + 1) / 2 +
           (size_t)kChainPool * (2 * kRec + 1) + (max_disp > 0 ? max_disp : 1);
  }
};

constexpr int kMinWindow = 32;  // the adaptive window's floor
// s_pre codes (16 bits a lane): a slot of i1, kPreI2 | a slot of i2, or
// kPreStuck (both rows fill first); | kPreCross if the lane's i2 is a
// neighbour's row; and above kPreRec, 1 + the chain record of a stuck lane.
constexpr int kPreI2 = 0x10, kPreStuck = 0x1F, kPreCross = 0x20;
constexpr int kPreRec = 6;
static_assert(kChainPool < (1 << (16 - kPreRec)), "record index overflow");

// The window's chain records (c_rows, c_vals, c_meta; see speculate_chain)
// and the count of lanes that asked for one.
struct Records {
  uint32_t* rows;
  uint32_t* vals;
  int* meta;
  int* next;
  // A record for the chain of a lane from i2 -> its index, or -1.
  __device__ int speculate(const uint32_t* t, int bs, uint32_t n, uint32_t f,
                           uint32_t i2, int max_disp) const {
    const int r = atomicAdd(next, 1);
    if (r >= kChainPool) return -1;
    meta[r] = speculate_chain(t, bs, n, f, i2, min(kChainSteps, max_disp),
                              rows + r * kRec, vals + r * kRec);
    return meta[r] >= 0 ? r : -1;
  }
};

// One warp: the placements of a window's 32-lane chunk c for the commit's
// all-at-once case, from each lane's neighbours within 31 lanes on either
// side (every prefix of the commit that holds the lane lies among them):
// its rank among the earlier ones with its i1 picks the rank-th empty slot
// of i1, else the first of i2; a neighbour that has the lane's i2 as its
// i1 or i2 marks it kPreCross (its commit then goes lane by lane).
__device__ void decide_chunk(int c, int lane, int cnt, const uint32_t* t,
                             int bs, uint32_t n, int max_disp,
                             const uint32_t* s_f, const uint32_t* s_i1,
                             const uint32_t* s_i2, const int* s_spec,
                             uint16_t* s_pre, const Records& rec) {
  const int x = 32 * c + lane;
  auto at = [cnt](const uint32_t* v, int y) {
    return y >= 0 && y < cnt ? v[y] : kFull;
  };
  const uint32_t i1 = at(s_i1, x), i2 = at(s_i2, x);
  const uint32_t p1 = at(s_i1, x - 32), p2 = at(s_i2, x - 32);
  const uint32_t n1 = at(s_i1, x + 32), n2 = at(s_i2, x + 32);
  int rank = 0;
  bool cross = false;
#pragma unroll
  for (int y = 0; y < 32; ++y) {
    const uint32_t a1 = __shfl_sync(kFull, i1, y);
    const uint32_t a2 = __shfl_sync(kFull, i2, y);
    const uint32_t b1 = __shfl_sync(kFull, p1, y);
    const uint32_t b2 = __shfl_sync(kFull, p2, y);
    const uint32_t c1 = __shfl_sync(kFull, n1, y);
    const uint32_t c2 = __shfl_sync(kFull, n2, y);
    rank += (y < lane && a1 == i1) + (y > lane && b1 == i1);
    cross |= (y != lane && (a1 == i2 || a2 == i2)) ||
             (y > lane && (b1 == i2 || b2 == i2)) ||
             (y < lane && (c1 == i2 || c2 == i2));
  }
  if (x >= cnt) return;
  const int spec = s_spec[x];
  int pre = kPreStuck;
  if (spec > 0) {
    const uint32_t m1 = (uint32_t)spec & kMaskLow;
    const uint32_t m2 = (uint32_t)spec >> kMaskBits;
    if (rank < __popc(m1)) {
      pre = nth_set(m1, rank);
    } else if (m2) {
      pre = kPreI2 | (__ffs(m2) - 1);
    } else {
      // Earlier lanes of its i1 fill it and i2 is full: the lane will walk
      // a chain from i2, which nothing in this window wrote yet.
      const int r = rec.speculate(t, bs, n, s_f[x], i2, max_disp);
      pre |= (r + 1) << kPreRec;
    }
  }
  s_pre[x] = (uint16_t)(pre | (cross ? kPreCross : 0));
}

// One window's commit by warp 0, in lane order (see the header); `ok` is
// the window's first lane.  Counts lanes into the four schedule counters.
__device__ void commit_window(uint32_t* t, int bs, uint32_t n, uint32_t* st,
                              int slots, uint32_t* hist, int max_disp,
                              const Dirty& d, const uint32_t* s_f,
                              const uint32_t* s_i1, const uint32_t* s_i2,
                              const int* s_spec, const uint16_t* s_pre,
                              const Records& rec, uint8_t* ok, int cnt,
                              int lane,
                              unsigned long long& n_direct,
                              unsigned long long& n_chain,
                              unsigned long long& n_dirty,
                              unsigned long long& n_walk) {
  int pos = 0;
  while (pos < cnt) {
    const int w = pos + lane;
    uint32_t i1 = kFull, i2 = kFull, f = 0u, m1 = 0u, m2 = 0u;
    bool direct = false;
    if (w < cnt) {
      const int spec = s_spec[w];
      i1 = s_i1[w];
      i2 = s_i2[w];
      f = s_f[w];
      if (spec > 0) {
        m1 = (uint32_t)spec & kMaskLow;
        m2 = (uint32_t)spec >> kMaskBits;
        direct = !d.test(i1) && !d.test(i2);
      }
    }
    // The eligible prefix: direct lanes whose rows nothing wrote since the
    // snapshot.  Its lanes place in order; a lane's masks are the
    // snapshot's less the slots earlier lanes of the prefix take.
    const unsigned bad = __ballot_sync(kFull, !direct);
    const int elig = bad ? __ffs(bad) - 1 : 32;
    const int pre = w < cnt ? s_pre[w] & ((1 << kPreRec) - 1) : kPreStuck;
    const bool cross = (pre & kPreCross) != 0;
    uint32_t row = kFull;
    int slot = 0, take = elig;
    bool filled = false;  // the prefix stopped at a lane whose i1 it filled
    if (!__any_sync(kFull, cross && lane < elig)) {
      // Every i2 is private, so only lanes of one i1 write each other's
      // rows: each lane's placement is the one decide_chunk made.
      const int dec = pre & ~kPreCross;
      bool stuck = false;
      if (lane < elig) {
        if (dec == kPreStuck) {
          stuck = true;
        } else {
          row = dec & kPreI2 ? i2 : i1;
          slot = dec & (kPreI2 - 1);
        }
      }
      const unsigned stop = __ballot_sync(kFull, stuck);
      if (stop) {
        take = __ffs(stop) - 1;
        filled = true;
      }
    } else {
      // Lane by lane: each placement is broadcast and taken out of the
      // later lanes' masks for that row, up to a lane whose rows filled.
      for (int y = 0; y < elig; ++y) {
        uint32_t cr = kFull;
        int cs = 0;
        if (m1) {
          cr = i1;
          cs = __ffs(m1) - 1;
        } else if (m2) {
          cr = i2;
          cs = __ffs(m2) - 1;
        }
        const uint32_t ry = __shfl_sync(kFull, cr, y);
        const int sy = __shfl_sync(kFull, cs, y);
        if (ry == kFull) {
          take = y;
          break;
        }
        if (lane == y) {
          row = ry;
          slot = sy;
        } else if (lane > y) {
          if (i1 == ry) m1 &= ~(1u << sy);
          if (i2 == ry) m2 &= ~(1u << sy);
        }
      }
    }
    // A run of one i1 that goes on past the 32 lanes waits for the next
    // step whole: its later lanes would otherwise find their row dirty.
    bool cut = false;
    if (take == 32 && pos + 32 < cnt) {
      const unsigned run = __ballot_sync(kFull, i1 == s_i1[pos + 32]);
      const int from = 32 - __clz(~run);  // first lane of the last run
      if (run >> 31 && from > 0) {
        take = from;
        cut = true;
      }
    }
    if (lane < take) {
      t[(size_t)row * bs + slot] = f;
      d.mark(row);
      ok[w] = 1;
    }
    n_direct += take;
    pos += take;
    __syncwarp();
    if (cut || take == 32 || pos >= cnt) continue;
    // The lane that ends the prefix: its chain record if every row the
    // record read is clean and i1 is still full (known when the prefix
    // filled it, or when it is clean and was full in the snapshot; else
    // read live), else the sequential walk on the live table.
    if (lane == 0) {
      const int spec = s_spec[pos];
      const uint32_t f0 = s_f[pos], a1 = s_i1[pos], a2 = s_i2[pos];
      const int r = spec <= -2 ? -2 - spec : (s_pre[pos] >> kPreRec) - 1;
      bool applied = false;
      if (r >= 0) {
        const int meta = rec.meta[r];
        const int steps = meta & 0xFFFF, jf = meta >> 16;
        const uint32_t* rows = rec.rows + r * kRec;
        const uint32_t* vals = rec.vals + r * kRec;
        bool clean = true;
        for (int q = 0; q <= steps && clean; ++q) clean = !d.test(rows[q]);
        const bool full = filled || (spec <= -2 && !d.test(a1));
        if (clean && !full) clean = first_empty(t + (size_t)a1 * bs, bs) < 0;
        if (clean) {
          for (int q = 0; q < steps; ++q) {
            t[(size_t)rows[q] * bs + q % bs] = vals[q];
            d.mark(rows[q]);
          }
          t[(size_t)rows[steps] * bs + jf] = vals[steps];
          d.mark(rows[steps]);
          ok[pos] = 1;
          applied = true;
          ++n_chain;
        }
      }
      if (!applied) {
        if (spec == -1) ++n_walk; else ++n_dirty;
        ok[pos] = walk_lane(t, bs, n, f0, a1, a2, st, slots, hist, max_disp,
                            d) ? 1 : 0;
      }
    }
    __syncwarp();
    pos += 1;
  }
}

// Per-lane speculation codes (s_spec): > 0 direct (direct_code's empty
// masks); -1 the serial walk; <= -2 chain record -2 - code.
__global__ void __launch_bounds__(kThreads)
scan_insert_kernel(uint32_t* tables, int buffer, int bs, uint32_t n,
                   uint32_t* stashes, int slots,
                   const uint32_t* __restrict__ a,
                   const uint32_t* __restrict__ b,
                   const long long* __restrict__ offsets,
                   uint8_t* __restrict__ ok, int pair_mode, int fp_bits,
                   int max_disp, Layout lay,
                   unsigned long long* __restrict__ stats) {
  extern __shared__ __align__(16) uint32_t smem[];
  __shared__ int chain_next, window;
  const int W = lay.window;
  uint32_t* dirty_bits = smem;
  uint32_t* s_f = dirty_bits + lay.dirty_words;
  uint32_t* s_i1 = s_f + W;
  uint32_t* s_i2 = s_i1 + W;
  int* s_spec = reinterpret_cast<int*>(s_i2 + W);
  uint32_t* c_rows = reinterpret_cast<uint32_t*>(s_spec + W);
  uint32_t* c_vals = c_rows + kChainPool * kRec;
  int* c_meta = reinterpret_cast<int*>(c_vals + kChainPool * kRec);
  uint32_t* hist = reinterpret_cast<uint32_t*>(c_meta + kChainPool);
  uint16_t* s_pre = reinterpret_cast<uint16_t*>(hist + max(max_disp, 1));
  const Records rec{c_rows, c_vals, c_meta, &chain_next};
  const Dirty d{dirty_bits, (uint32_t)lay.dirty_words * 32u - 1u};

  const int s = blockIdx.x, tid = threadIdx.x, lane = tid & 31;
  uint32_t* t = tables + (size_t)s * buffer * bs;
  uint32_t* st = stashes ? stashes + (size_t)s * 2 * slots : nullptr;
  const long long first = offsets[s], last = offsets[s + 1];
  // taken direct, taken as a chain record, walked dirty, walked as a chain
  unsigned long long n_direct = 0, n_chain = 0, n_dirty = 0, n_walk = 0;
  if (tid == 0) {
    chain_next = 0;
    window = W;
  }

  for (long long base = first; base < last;) {
    __syncthreads();  // the last commit's writes before this snapshot
    const int cnt = (int)min((long long)window, last - base);
    // -- speculate (and clear the dirty set; nothing reads it here) --
    for (int q = tid; q < lay.dirty_words / 4; q += kThreads)
      reinterpret_cast<uint4*>(dirty_bits)[q] = make_uint4(0u, 0u, 0u, 0u);
    if (tid < lay.dirty_words % 4) dirty_bits[lay.dirty_words - 1 - tid] = 0u;
    for (int w = tid; w < cnt; w += kThreads) {
      const long long k = base + w;
      uint32_t f, i1;
      if (pair_mode) {
        f = b[k];
        i1 = a[k] % n;
      } else {
        f = ocf::fingerprint(a[k], b[k], fp_bits);
        i1 = ocf::index_hash(a[k], b[k], n);
      }
      const uint32_t i2 = ocf::alt_index(i1, f, n);
      int spec = direct_code(t, bs, lay.vec, i1, i2);
      if (spec == 0) {  // both rows full: a chain
        const int r = rec.speculate(t, bs, n, f, i2, max_disp);
        spec = r >= 0 ? -2 - r : -1;
      }
      s_f[w] = f;
      s_i1[w] = i1;
      s_i2[w] = i2;
      s_spec[w] = spec;
    }
    __syncthreads();
    for (int c = tid >> 5; 32 * c < cnt; c += kThreads / 32)
      decide_chunk(c, lane, cnt, t, bs, n, max_disp, s_f, s_i1, s_i2, s_spec,
                   s_pre, rec);
    __syncthreads();
    if (tid < 32) {
      commit_window(t, bs, n, st, slots, hist, max_disp, d, s_f, s_i1, s_i2,
                    s_spec, s_pre, rec, ok + base, cnt, lane,
                    n_direct, n_chain, n_dirty, n_walk);
      if (lane == 0) {
        // More chains than records: shrink the window so that the next
        // one's chains fit; few: grow it back towards W.
        const int chains = chain_next;
        if (chains > kChainPool)
          window = max(min(W, kMinWindow),
                       (int)((long long)cnt * kChainPool / chains));
        else if (2 * chains <= kChainPool)
          window = min(W, 2 * window);
        chain_next = 0;
      }
    }
    base += cnt;
  }
  if (stats && tid == 0) {
    atomicAdd(stats + 0, n_direct);
    atomicAdd(stats + 1, n_chain);
    atomicAdd(stats + 2, n_dirty);
    atomicAdd(stats + 3, n_walk);
  }
}

// One thread a position of the sorted lanes; the first position of each
// group walks the group in order.
__global__ void scan_delete_kernel(uint32_t* tables, int buffer, int bs,
                                   uint32_t n,
                                   const uint32_t* __restrict__ hi,
                                   const uint32_t* __restrict__ lo,
                                   const long long* __restrict__ offsets,
                                   int n_shards,
                                   const long long* __restrict__ keys,
                                   const long long* __restrict__ perm,
                                   long long m, uint8_t* __restrict__ ok,
                                   int fp_bits) {
  const long long g = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (g >= m) return;
  const long long key = keys[g];
  if (g > 0 && keys[g - 1] == key) return;
  for (long long q = g; q < m && keys[q] == key; ++q) {
    const long long k = perm[q];
    int lo_s = 0, hi_s = n_shards - 1;  // the shard: offsets[s] <= k
    while (lo_s < hi_s) {
      const int mid = (lo_s + hi_s + 1) / 2;
      if (offsets[mid] <= k) lo_s = mid; else hi_s = mid - 1;
    }
    uint32_t* t = tables + (size_t)lo_s * buffer * bs;
    const uint32_t f = ocf::fingerprint(hi[k], lo[k], fp_bits);
    const uint32_t i1 = ocf::index_hash(hi[k], lo[k], n);
    const uint32_t i2 = ocf::alt_index(i1, f, n);
    bool done = false;
    for (int c = 0; c < 2 && !done; ++c) {
      uint32_t* row = t + (size_t)(c ? i2 : i1) * bs;
      for (int j = 0; j < bs; ++j) {
        if (row[j] == f) {
          row[j] = 0u;
          done = true;
          break;
        }
      }
    }
    ok[k] = done ? 1 : 0;
  }
}

}  // namespace

// window: lanes a window (>= 1); stats: null, or uint64[4] that the launch
// adds its lanes to (taken direct, taken as a chain record, walked because
// a row was dirty, walked as a chain).
extern "C" int ocf_scan_insert(void* tables, int buffer, int bucket_size,
                               unsigned int n_buckets, void* stashes,
                               int slots, const void* a, const void* b,
                               const void* offsets, void* ok, int n_shards,
                               int pair_mode, int fp_bits, int max_disp,
                               int window, void* stats, void* stream) {
  if (window < 1 || bucket_size < 1) return (int)cudaErrorInvalidValue;
  if (n_shards <= 0) return (int)cudaGetLastError();
  int dev = 0, optin = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                         dev);
  cudaFuncAttributes fa;
  cudaError_t err = cudaFuncGetAttributes(&fa, scan_insert_kernel);
  if (err != cudaSuccess) return (int)err;
  Layout lay{0, window, max_disp,
             bucket_size == 4 && ((uintptr_t)tables & 15u) == 0};
  const long long budget = (long long)optin - (long long)fa.sharedSizeBytes -
                           4 * (long long)lay.words();
  // The dirty set: one bit a row up to 2^20 rows, as large as fits.
  unsigned bits = 32;
  while (bits < kMaxDirtyBits && bits < n_buckets &&
         (long long)(bits * 2 / 8) <= budget)
    bits *= 2;
  lay.dirty_words = (int)(bits / 32);
  const size_t smem = 4 * lay.words();
  if ((long long)smem + (long long)fa.sharedSizeBytes > optin)
    return (int)cudaErrorInvalidValue;
  err = cudaFuncSetAttribute(scan_insert_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err != cudaSuccess) return (int)err;
  scan_insert_kernel<<<n_shards, kThreads, smem, (cudaStream_t)stream>>>(
      (uint32_t*)tables, buffer, bucket_size, n_buckets, (uint32_t*)stashes,
      slots, (const uint32_t*)a, (const uint32_t*)b,
      (const long long*)offsets, (uint8_t*)ok, pair_mode, fp_bits, max_disp,
      lay, (unsigned long long*)stats);
  return (int)cudaGetLastError();
}

// keys / perm: the compacted lanes' conflict keys sorted stably and the
// compacted index of each sorted position (m of each).
extern "C" int ocf_scan_delete(void* tables, int buffer, int bucket_size,
                               unsigned int n_buckets, const void* hi,
                               const void* lo, const void* offsets,
                               int n_shards, const void* keys,
                               const void* perm, long long m, void* ok,
                               int fp_bits, void* stream) {
  if (n_shards > 0 && m > 0) {
    const int threads = 256;
    const long long blocks = (m + threads - 1) / threads;
    scan_delete_kernel<<<(unsigned)blocks, threads, 0,
                         (cudaStream_t)stream>>>(
        (uint32_t*)tables, buffer, bucket_size, n_buckets,
        (const uint32_t*)hi, (const uint32_t*)lo, (const long long*)offsets,
        n_shards, (const long long*)keys, (const long long*)perm, m,
        (uint8_t*)ok, fp_bits);
  }
  return (int)cudaGetLastError();
}
