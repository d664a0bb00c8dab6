// flash_attention: online-softmax attention for the LM stack (kernel 10).
//
// Replaces the TPU kernel repro/kernels/flash_attention.py::flash_attention
// (body _flash_kernel).  Same function: q [B, Hq, Sq, D], k and v
// [B, Hkv, Skv, D]; q head h reads kv head h / (Hq / Hkv); queries sit
// right-aligned to keys (query i at position Skv - Sq + i); the causal mask
// keeps keys at or before the query, the window keeps keys less than
// `window` positions back; the optional soft-cap c * tanh(s / c) acts before
// the mask, which is applied to p after the exp; float32 running max,
// denominator and accumulator; a row with no live key gives 0
// (acc / max(l, 1e-30)); the output has q's type (float or bfloat16).
// Optionally (a non-null `lse`) each row's float32 log-sum-exp of its
// scaled, soft-capped scores, m + log(l), or -1e30 for a row with no live
// key, [B, Hq, Sq]: what the backward kernels (flash_attention_bwd.cu)
// recompute p from.  A null `lse` is the inference path, unchanged.
// q, k and v may be strided views: their last dimension is contiguous and
// every other stride is a multiple of 16 bytes; the output is contiguous.
// Any Sq and Skv: the last q and kv tiles may be ragged.  Rows past S
// load as zero (TMA's out-of-bounds fill; the float32 kernel's staging),
// keys at or past Skv are masked to -inf on the tiles that reach Skv (a
// zero key would score 0, not -inf), and no row at or past Sq is stored.
//
// The TPU kernel walks a grid (B * Hq, Sq / BQ, Skv / BK) in order and
// carries its online-softmax state in VMEM scratch across the kv axis.  A
// CUDA grid has no order, so here one CTA owns one (batch x q head, q tile)
// and loops over the kv tiles itself.  The loop bounds cover only the tiles
// that the causal and window masks leave live for some row of the q tile:
// the TPU kernel's block_live early-out, without visiting the dead tiles.
//
// What bounds it on the H100: the operations.  A global layer of gemma3-1b
// at S = 8192 does 4 * D operations per live (query, key) pair, 137 GFLOP
// per launch against 42 MB of q, k, v and o in bfloat16 (0.139 ms at 989
// TFLOP/s); a window of 512 keys cuts the pairs by 8, and the ratio stays
// far above the card's balance point of ~295 operations per byte.  So the
// tensor cores set the pace, and the design follows them where the type
// allows:
//
// * bfloat16 (the model's activations): flash_wgmma_kernel, built on
//   Hopper's warpgroup MMA (wgmma) and tensor memory accelerator (TMA).
//   A CTA is three warpgroups over a 128-row q tile.  Warpgroup 0 is the
//   producer: one thread issues TMA loads (the q tile once, then 64-key K
//   and V tiles into a two-stage ring, with a full and an empty mbarrier
//   per stage for K and for V, so a stage's K is refilled as soon as the
//   scores are out, before its P V is done), and the warpgroup gives its
//   registers back (setmaxnreg.dec).  Warpgroups 1 and 2 are consumers of
//   64 q rows each (setmaxnreg.inc: at D = 256 the output accumulator
//   alone is 128 float32 registers a thread).  Per kv tile a consumer runs
//   S = Q K^T as D / 16 wgmma m64n64k16 with both operands K-major in
//   shared memory, the online softmax on the accumulator fragments (a
//   row's values sit in the four threads of a quad: two shuffles; exp2
//   with the scale folded in; masks only on tiles that cross a causal or
//   window edge or the end of the keys), then O += P V as one wgmma
//   m64n(D)k16 a 16-key step, with p re-packed in registers as the
//   bfloat16 A operand (the m64nNk16 accumulator layout is the
//   register-A fragment layout) and V read MN-major through the
//   descriptor's transpose bit.  The loop is software-pipelined: the
//   scores of tile t go to the tensor cores ahead of P V of tile t - 1,
//   and the softmax of tile t runs while that P V does.  Tiles sit in
//   shared memory in the swizzled layout TMA writes and the wgmma
//   descriptors read (128-byte swizzle for D >= 64, 64-byte for D = 32,
//   32-byte for D = 16; a row of D > 64 is loaded as D / 64 boxes of 64
//   columns).  The tensor maps are 4-D (D, S, H, B) over the caller's
//   strides, so rows past S read as zero, never as the next head's rows.
//   The output is written into the consumer's own rows of the q tile,
//   then stored by TMA, which clips it at Sq.  q tiles run heaviest
//   (latest) first across all heads, one CTA per SM.  p is rounded to
//   bfloat16 for P V, as every tensor-core flash kernel does; the
//   denominator sums the float32 p.
// * float32 (the serving consistency check, the tests): flash_f32_kernel
//   on the CUDA cores, 256 threads; the pre-scaled q tile, the K and V
//   tiles and the score tile sit in shared memory (rows padded by 4 floats
//   for conflict-free 16-byte loads), each thread computes a 4 x 2 block
//   of scores and a 4-row slice of the accumulator, which stays in
//   registers.  TF32 would lose the reference's float32 tolerance.
//
// What holds the bfloat16 kernel back (H100 80GB HBM3 at 700 W,
// chip_smoke.py phase 6, gemma3-1b heads at S = 8192): a global layer
// takes 0.280 ms, 2.0x its 0.139 ms bound, below scaled_dot_product_
// attention's 0.312 ms; a 512-window layer 0.060 ms, 3.6x its bound.
// Under wgmma each K and V tile is read from shared memory once per
// warpgroup of 64 rows.  A hypothesis, from a count and not from a
// profile: the shared memory sets the ceiling.  Per 64-key tile the two
// consumers read 96 KB each (Q, K and V: the scores take both operands
// from shared memory) and TMA writes 64 KB, which at the tensor cores'
// full rate (2048 clocks a tile) would be ~125 bytes a clock of the SM's
// ~128.  How the factor of 2 splits (that traffic, waits on wgmma groups
// and barriers, the softmax work the pipeline does not hide) is not
// measured: no hardware profiler runs on that machine.  A local layer
// adds each CTA's fixed cost (the q tile's load before the first
// product, the pipeline's fill and drain, the store) to ~10 tiles of
// work.
#include "hopper.cuh"

namespace {

// Element strides of a [B, H, S, D] operand (D contiguous).
struct HeadStrides {
  long long b, h;
  int s;
};

constexpr int kThreads = 256;
constexpr int kBQ = 64;     // q rows per CTA
constexpr int kBK = 32;     // keys per kv tile
constexpr int kSS = kBK + 1;  // padded row stride of the score tile
constexpr float kNegInf = -1e30f;

// Thread layout of the accumulator: kTR row groups x kTD column groups;
// a thread owns kRPT rows and kF4 float4 columns (strided by kTD).
template <int D>
struct Layout {
  static constexpr int kTD = (D / 4 < 16) ? D / 4 : 16;
  static constexpr int kTR = kThreads / kTD;
  static constexpr int kRPT = kBQ / kTR;
  static constexpr int kF4 = D / 4 / kTD;
  static constexpr int kRow = D + 4;  // padded row stride of Qs and Ks
  static constexpr size_t kSmemFloats =
      (size_t)kBQ * kRow + (size_t)kBK * kRow + (size_t)kBK * D +
      (size_t)kBQ * kSS + 2 * kBQ;
  static_assert(kRPT >= 1 && kF4 >= 1, "unsupported head dim");
};

__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ void store4(float* p, float4 v) {
  *reinterpret_cast<float4*>(p) = v;
}

// rows [row0, row0 + rows) of a head slice (row stride `src_stride`) ->
// smem (row stride `stride`), times `mul`; rows at or past `limit` are
// zero.
template <int D>
__device__ __forceinline__ void stage(float* dst, int stride, const float* src,
                                      int src_stride, int row0, int rows,
                                      int limit, float mul) {
  constexpr int kF = D / 4;
  for (int e = threadIdx.x; e < rows * kF; e += kThreads) {
    const int r = e / kF, c = (e % kF) * 4;
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (row0 + r < limit) {
      v = load4(src + (long long)(row0 + r) * src_stride + c);
      v.x *= mul; v.y *= mul; v.z *= mul; v.w *= mul;
    }
    store4(dst + r * stride + c, v);
  }
}

// One CTA a block at least: left to its own heuristics ptxas holds D = 32
// and 64 to 64 registers and spills.
template <int D>
__global__ void __launch_bounds__(kThreads, 1)
flash_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, float* __restrict__ o,
                 float* __restrict__ lse, HeadStrides qst, HeadStrides kst,
                 HeadStrides vst, int hq, int hkv, int sq, int skv,
                 int causal, int window, float softcap, float scale) {
  using L = Layout<D>;
  extern __shared__ float smem[];
  float* Qs = smem;                      // [kBQ][kRow], pre-scaled
  float* Ks = Qs + kBQ * L::kRow;        // [kBK][kRow]
  float* Vs = Ks + kBK * L::kRow;        // [kBK][D]
  float* Ss = Vs + kBK * D;              // [kBQ][kSS]: scores, then p
  float* alpha_s = Ss + kBQ * kSS;       // [kBQ]
  float* l_s = alpha_s + kBQ;            // [kBQ]

  const int t = threadIdx.x;
  const int bh = blockIdx.y;             // batch * hq + q head
  const int bi = bh / hq, h = bh % hq, kvh = h / (hq / hkv);
  const int q0 = blockIdx.x * kBQ;
  const float* qh = q + bi * qst.b + h * qst.h;
  const float* kh = k + bi * kst.b + kvh * kst.h;
  const float* vh = v + bi * vst.b + kvh * vst.h;

  stage<D>(Qs, L::kRow, qh, qst.s, q0, kBQ, sq, scale);

  // The live kv range of this q tile.
  const int qpos0 = skv - sq + q0;       // position of the tile's row 0
  const int qlast = skv - sq + min(q0 + kBQ, sq) - 1;
  const int kv_hi = causal ? min(skv, qlast + 1) : skv;
  const int kv_lo = window > 0 ? max(0, qpos0 - window + 1) : 0;
  const int tile_lo = kv_lo / kBK;
  const int tile_hi = kv_hi > kv_lo ? (kv_hi + kBK - 1) / kBK : tile_lo;

  // Score phase: rows sr + 16 i, columns sc + 16 j.
  const int sc = t % 16, sr = t / 16;
  // Softmax phase: 4 threads per row, 8 columns each.
  const int xr = t / 4, xs = t % 4;
  const int qpos = qpos0 + xr;
  const bool row_live = q0 + xr < sq;
  float m_run = kNegInf, l_run = 0.f;
  // Accumulator phase.
  const int ad = t % L::kTD, ar = (t / L::kTD) * L::kRPT;
  float4 acc[L::kRPT][L::kF4];
#pragma unroll
  for (int i = 0; i < L::kRPT; ++i)
#pragma unroll
    for (int f = 0; f < L::kF4; ++f)
      acc[i][f] = make_float4(0.f, 0.f, 0.f, 0.f);

  for (int tile = tile_lo; tile < tile_hi; ++tile) {
    const int kv0 = tile * kBK;
    __syncthreads();                     // previous tile fully consumed
    stage<D>(Ks, L::kRow, kh, kst.s, kv0, kBK, skv, 1.f);
    stage<D>(Vs, D, vh, vst.s, kv0, kBK, skv, 1.f);
    __syncthreads();

    // s = q k^T over the tile.
    float s[4][2];
#pragma unroll
    for (int i = 0; i < 4; ++i) s[i][0] = s[i][1] = 0.f;
#pragma unroll 4
    for (int c = 0; c < D; c += 4) {
      float4 qv[4], kv[2];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        qv[i] = load4(Qs + (sr + 16 * i) * L::kRow + c);
#pragma unroll
      for (int j = 0; j < 2; ++j)
        kv[j] = load4(Ks + (sc + 16 * j) * L::kRow + c);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j)
          s[i][j] += qv[i].x * kv[j].x + qv[i].y * kv[j].y +
                     qv[i].z * kv[j].z + qv[i].w * kv[j].w;
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j)
        Ss[(sr + 16 * i) * kSS + sc + 16 * j] = s[i][j];
    __syncthreads();

    // Online softmax of row xr over columns xs * 8 .. + 8.
    float p[8];
    bool live[8];
    float mx = kNegInf;
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      const int col = xs * 8 + c;
      const int kpos = kv0 + col;
      bool ok = row_live && kpos < skv;
      if (causal) ok = ok && kpos <= qpos;
      if (window > 0) ok = ok && kpos > qpos - window;
      float x = Ss[xr * kSS + col];
      if (softcap > 0.f) x = softcap * tanhf(x / softcap);
      x = ok ? x : kNegInf;
      live[c] = ok;
      p[c] = x;
      mx = fmaxf(mx, x);
    }
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    const float m_cur = fmaxf(m_run, mx);
    const float alpha = expf(m_run - m_cur);
    float sum = 0.f;
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      p[c] = live[c] ? expf(p[c] - m_cur) : 0.f;
      sum += p[c];
      Ss[xr * kSS + xs * 8 + c] = p[c];
    }
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    sum += __shfl_xor_sync(0xffffffffu, sum, 2);
    l_run = l_run * alpha + sum;
    m_run = m_cur;
    if (xs == 0) alpha_s[xr] = alpha;
    __syncthreads();

    // acc = acc * alpha + p v.
#pragma unroll
    for (int i = 0; i < L::kRPT; ++i) {
      const float a = alpha_s[ar + i];
#pragma unroll
      for (int f = 0; f < L::kF4; ++f) {
        acc[i][f].x *= a; acc[i][f].y *= a; acc[i][f].z *= a; acc[i][f].w *= a;
      }
    }
#pragma unroll 4
    for (int kk = 0; kk < kBK; ++kk) {
      float4 vv[L::kF4];
#pragma unroll
      for (int f = 0; f < L::kF4; ++f)
        vv[f] = load4(Vs + kk * D + (ad + L::kTD * f) * 4);
#pragma unroll
      for (int i = 0; i < L::kRPT; ++i) {
        const float pk = Ss[(ar + i) * kSS + kk];
#pragma unroll
        for (int f = 0; f < L::kF4; ++f) {
          acc[i][f].x += pk * vv[f].x;
          acc[i][f].y += pk * vv[f].y;
          acc[i][f].z += pk * vv[f].z;
          acc[i][f].w += pk * vv[f].w;
        }
      }
    }
  }

  if (xs == 0) l_s[xr] = l_run;
  if (lse != nullptr && xs == 0 && row_live)
    lse[(size_t)bh * sq + q0 + xr] =
        l_run > 0.f ? m_run + logf(l_run) : kNegInf;
  __syncthreads();
  float* oh = o + (size_t)bh * sq * D;
#pragma unroll
  for (int i = 0; i < L::kRPT; ++i) {
    const int r = ar + i;
    if (q0 + r >= sq) continue;
    const float inv = 1.f / fmaxf(l_s[r], 1e-30f);
#pragma unroll
    for (int f = 0; f < L::kF4; ++f) {
      float4 a = acc[i][f];
      a.x *= inv; a.y *= inv; a.z *= inv; a.w *= inv;
      store4(oh + (size_t)(q0 + r) * D + (ad + L::kTD * f) * 4, a);
    }
  }
}

// ------------------------------- bfloat16: wgmma, TMA, warp-specialised --

constexpr int kWBQ = 128;      // q rows per CTA: two consumer warpgroups
constexpr int kWBK = 64;       // keys per kv tile
constexpr int kStages = 2;     // K and V ring depth
constexpr int kWThreads = 384; // producer + two consumer warpgroups
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

// Shared memory of one CTA: the q tile, then kStages K tiles, then kStages
// V tiles, then the mbarriers (q full; for K, then for V, kStages full and
// kStages empty).  Each tile is D / kBC column blocks of rows kRB bytes
// wide (the swizzle's width), every block 1024-byte aligned.
template <int D>
struct WgLayout {
  static constexpr int kBC = D < 64 ? D : 64;  // columns of a block
  static constexpr int kRB = 2 * kBC;          // bytes of a block's row
  static constexpr int kCB = D / kBC;          // column blocks
  static constexpr int kKPB = kRB / 32;        // k-steps of 16 in a block
  // wgmma descriptor layout type: 1 = 128-byte, 2 = 64-byte, 3 = 32-byte
  static constexpr uint32_t kDescLayout = kRB == 128 ? 1 : kRB == 64 ? 2 : 3;
  static constexpr uint32_t kSwzMask = kRB / 16 - 1;  // row bits XORed in
  static constexpr int kQBytes = kWBQ * D * 2;
  static constexpr int kKVBytes = kWBK * D * 2;        // one K or V tile
  static constexpr int kBarOff = kQBytes + 2 * kStages * kKVBytes;
  // + up to 1023 bytes to align the base to the swizzle pattern
  static constexpr size_t kSmemBytes = 1024 + kBarOff + 8 * (1 + 4 * kStages);
  static_assert(kBC % 16 == 0 && D % kBC == 0, "unsupported head dim");
};


// One CTA: 128 q rows of one (batch, q head).  See the header note.
template <int D>
__global__ void __launch_bounds__(kWThreads, 1)
flash_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                   const __grid_constant__ CUtensorMap tk,
                   const __grid_constant__ CUtensorMap tv,
                   const __grid_constant__ CUtensorMap to,
                   float* __restrict__ lse, int hq, int hkv, int sq, int skv,
                   int causal, int window, float softcap, float scale) {
  using L = WgLayout<D>;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t sQ = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t sK = sQ + L::kQBytes;
  const uint32_t sV = sK + kStages * L::kKVBytes;
  // mbarriers: q full, then K full, K empty, V full, V empty per stage.
  const uint32_t q_full = sQ + L::kBarOff;
  const uint32_t k_full = q_full + 8, k_empty = k_full + 8 * kStages;
  const uint32_t v_full = k_empty + 8 * kStages;
  const uint32_t v_empty = v_full + 8 * kStages;

  const int bh = blockIdx.x;
  const int bi = bh / hq, h = bh % hq, kvh = h / (hq / hkv);
  // The heaviest (latest) q tiles of every head first.
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kWBQ;
  const int qpos0 = skv - sq + q0;
  const int qlast = skv - sq + min(q0 + kWBQ, sq) - 1;
  const int kv_hi = causal ? min(skv, qlast + 1) : skv;
  const int kv_lo = window > 0 ? max(0, qpos0 - window + 1) : 0;
  const int tile_lo = kv_lo / kWBK;
  const int tile_hi = kv_hi > kv_lo ? (kv_hi + kWBK - 1) / kWBK : tile_lo;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(k_full + 8 * s, 1);
      mbar_init(v_full + 8 * s, 1);
      mbar_init(k_empty + 8 * s, 2 * 128);  // every consumer thread
      mbar_init(v_empty + 8 * s, 2 * 128);
    }
    fence_barrier_init();
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 0) {
    // ---- producer: one thread issues every copy.  A stage's K is freed
    // as soon as both consumers have their scores, its V only after their
    // P V, so each waits on its own empty barrier.
    setmaxnreg_dec<24>();
    if (threadIdx.x == 0) {
      mbar_expect_tx(q_full, L::kQBytes);
      for (int c = 0; c < L::kCB; ++c)
        tma_load(sQ + c * kWBQ * L::kRB, &tq, q_full, c * L::kBC, q0, h, bi);
      for (int t = tile_lo; t < tile_hi; ++t) {
        const int i = t - tile_lo, s = i % kStages;
        // Round i / kStages of this stage; round 0 finds it empty.
        const uint32_t parity = ((i / kStages) & 1) ^ 1;
        mbar_wait(k_empty + 8 * s, parity);
        mbar_expect_tx(k_full + 8 * s, L::kKVBytes);
        for (int c = 0; c < L::kCB; ++c)
          tma_load(sK + s * L::kKVBytes + c * kWBK * L::kRB, &tk,
                   k_full + 8 * s, c * L::kBC, t * kWBK, kvh, bi);
        mbar_wait(v_empty + 8 * s, parity);
        mbar_expect_tx(v_full + 8 * s, L::kKVBytes);
        for (int c = 0; c < L::kCB; ++c)
          tma_load(sV + s * L::kKVBytes + c * kWBK * L::kRB, &tv,
                   v_full + 8 * s, c * L::kBC, t * kWBK, kvh, bi);
      }
    }
  } else {
    // ---- consumers: warpgroup w owns q rows [64 w, 64 w + 64).
    setmaxnreg_inc<240>();
    const int w = wg - 1;
    const int tid = threadIdx.x - 128 * wg;
    const int warp = tid / 32, lane = tid % 32;
    const int g = lane / 4, tq4 = lane % 4;  // quad group, thread in quad
    const int r0 = 64 * w + 16 * warp + g;   // this thread's rows r0, r0 + 8
    const int qp[2] = {qpos0 + r0, qpos0 + r0 + 8};
    const bool rlive[2] = {q0 + r0 < sq, q0 + r0 + 8 < sq};
    // This warpgroup's rows and the positions of its first and last.
    const int wrow0 = q0 + 64 * w;
    const bool wg_live = wrow0 < sq;
    const bool wg_rows_full = wrow0 + 64 <= sq;
    const int wq_first = skv - sq + wrow0;
    const int wq_last = skv - sq + min(wrow0 + 64, sq) - 1;
    // Scores are taken to the log2 domain: x = s * scale * log2(e), or
    // with the soft-cap c * log2(e) * tanh(s * scale / c).
    const bool capped = softcap > 0.f;
    const float mul = capped ? scale / softcap : scale * kLog2e;
    const float cap2 = softcap * kLog2e;

    constexpr uint32_t kSbo = 8 * L::kRB;  // 8-row groups
    const uint64_t dq = wg_desc(sQ + 64 * w * L::kRB, 16, kSbo,
                                L::kDescLayout);
    const uint64_t dk = wg_desc(sK, 16, kSbo, L::kDescLayout);
    const uint64_t dv = wg_desc(sV, kWBK * L::kRB, kSbo, L::kDescLayout);

    // The live tiles of this warpgroup are [wlo, whi): a window leaves the
    // first tiles of the CTA's range dead for warpgroup 1, the causal mask
    // the last for warpgroup 0.  Dead tiles are waited for and released
    // unread (an early release would count towards the stage's next round).
    auto dead = [&](int t) {
      return !wg_live || (causal && t * kWBK > wq_last) ||
             (window > 0 && t * kWBK + kWBK - 1 <= wq_first - window);
    };
    int wlo = tile_lo, whi = tile_hi;
    while (wlo < whi && dead(wlo)) ++wlo;
    while (whi > wlo && dead(whi - 1)) --whi;
    auto stage = [&](int t) { return (t - tile_lo) % kStages; };
    auto parity = [&](int t) { return ((t - tile_lo) / kStages) & 1; };
    auto skip = [&](int t) {
      mbar_wait(k_full + 8 * stage(t), parity(t));
      mbar_arrive(k_empty + 8 * stage(t));
      mbar_wait(v_full + 8 * stage(t), parity(t));
      mbar_arrive(v_empty + 8 * stage(t));
    };

    float m_run[2] = {kNegInf, kNegInf}, l_run[2] = {0.f, 0.f};
    float o[D / 2];  // o[4 j + e]: row r0 + 8 (e / 2), column 8 j + 2 tq4 + e % 2
#pragma unroll
    for (int e = 0; e < D / 2; ++e) o[e] = 0.f;
    float sacc[32];  // the same layout over the tile's 64 keys
    uint32_t pa[4][4];  // p as the A operand of P V, 16 keys a k-step

    // S = Q K^T of tile t: issued, not waited for.
    auto issue_scores = [&](int t) {
      const uint64_t dks = dk + ((stage(t) * L::kKVBytes) >> 4);
      reg_fence(sacc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const uint32_t cb = kk / L::kKPB;         // column block
        const uint32_t in = (kk % L::kKPB) * 32;  // bytes into the row
        wgmma_ss(sacc, dq + ((cb * kWBQ * L::kRB + in) >> 4),
                 dks + ((cb * kWBK * L::kRB + in) >> 4), kk > 0);
      }
      wgmma_commit();
    };
    // O += P V of tile t: issued, not waited for.
    auto issue_pv = [&](int t) {
      const uint64_t dvs = dv + ((stage(t) * L::kKVBytes) >> 4);
      reg_fence(o);
      reg_fence(pa);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_rs(o, pa[kk], dvs + ((kk * 16 * L::kRB) >> 4));
      wgmma_commit();
    };
    // Scale, soft-cap and mask the scores of tile t, and take the online
    // softmax a step: p into sacc, the running max and this thread's share
    // of the denominator updated; returns each row's rescale factor.
    auto softmax = [&](int t, float (&alpha)[2]) {
      const int kv0 = t * kWBK;
      const bool full = wg_rows_full && kv0 + kWBK <= skv &&
                        (!causal || kv0 + kWBK - 1 <= wq_first) &&
                        (window <= 0 || kv0 > wq_last - window);
      float mx[2] = {kNegInf, kNegInf};
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int hh = e / 2;
          float x = sacc[4 * j + e] * mul;
          if (capped) x = cap2 * tanhf(x);
          if (!full) {
            const int kpos = kv0 + 8 * j + 2 * tq4 + (e & 1);
            bool ok = rlive[hh] && kpos < skv;
            if (causal) ok = ok && kpos <= qp[hh];
            if (window > 0) ok = ok && kpos > qp[hh] - window;
            // -inf marks a masked score: its p is 0, it never sets the max
            x = ok ? x : -INFINITY;
          }
          sacc[4 * j + e] = x;
          mx[hh] = fmaxf(mx[hh], x);
        }
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        mx[hh] = fmaxf(mx[hh], __shfl_xor_sync(0xffffffffu, mx[hh], 1));
        mx[hh] = fmaxf(mx[hh], __shfl_xor_sync(0xffffffffu, mx[hh], 2));
        const float m_cur = fmaxf(m_run[hh], mx[hh]);
        alpha[hh] = exp2f(m_run[hh] - m_cur);
        m_run[hh] = m_cur;
        l_run[hh] *= alpha[hh];  // this thread's share; summed at the end
      }
#pragma unroll
      for (int e = 0; e < 32; ++e) {
        sacc[e] = exp2f(sacc[e] - m_run[(e / 2) % 2]);
        l_run[(e / 2) % 2] += sacc[e];
      }
    };
    auto pack_p = [&] {
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int r = 0; r < 4; ++r)
          pa[kk][r] = pack_bf16(sacc[8 * kk + 2 * r], sacc[8 * kk + 2 * r + 1]);
    };

    mbar_wait(q_full, 0);
    for (int t = tile_lo; t < wlo; ++t) skip(t);
    if (wlo < whi) {
      // Software pipeline: the scores of tile t go to the tensor cores
      // ahead of P V of tile t - 1, and the softmax of tile t runs while
      // P V of tile t - 1 does.
      float alpha[2];
      mbar_wait(k_full + 8 * stage(wlo), parity(wlo));
      issue_scores(wlo);
      wgmma_wait<0>();
      reg_fence(sacc);
      mbar_arrive(k_empty + 8 * stage(wlo));
      softmax(wlo, alpha);  // o is still 0: no rescale
      pack_p();
      for (int t = wlo + 1; t < whi; ++t) {
        mbar_wait(k_full + 8 * stage(t), parity(t));
        issue_scores(t);
        mbar_wait(v_full + 8 * stage(t - 1), parity(t - 1));
        issue_pv(t - 1);
        wgmma_wait<1>();  // the scores of tile t
        reg_fence(sacc);
        mbar_arrive(k_empty + 8 * stage(t));
        softmax(t, alpha);
        wgmma_wait<0>();  // P V of tile t - 1
        reg_fence(o);
        reg_fence(pa);
        mbar_arrive(v_empty + 8 * stage(t - 1));
#pragma unroll
        for (int e = 0; e < D / 2; ++e) o[e] *= alpha[(e / 2) % 2];
        pack_p();
      }
      mbar_wait(v_full + 8 * stage(whi - 1), parity(whi - 1));
      issue_pv(whi - 1);
      wgmma_wait<0>();
      reg_fence(o);
      reg_fence(pa);
      mbar_arrive(v_empty + 8 * stage(whi - 1));
    }
    for (int t = whi; t < tile_hi; ++t) skip(t);

    // Epilogue: o / l as bfloat16 into this warpgroup's rows of the q tile
    // (its wgmmas are done with them), in the swizzled layout the output
    // map reads, then one TMA store per column block; TMA clips at Sq.
    float inv[2];
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      float l = l_run[hh];
      l += __shfl_xor_sync(0xffffffffu, l, 1);
      l += __shfl_xor_sync(0xffffffffu, l, 2);
      inv[hh] = 1.f / fmaxf(l, 1e-30f);
      // m_run is in the log2 domain of the scaled (capped) scores
      if (lse != nullptr && tq4 == 0 && rlive[hh])
        lse[(size_t)bh * sq + q0 + r0 + 8 * hh] =
            l > 0.f ? (m_run[hh] + log2f(l)) * kLn2 : kNegInf;
    }
#pragma unroll
    for (int jj = 0; jj < D / 8; ++jj)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int c = jj / (L::kBC / 8), j = jj % (L::kBC / 8);
        const uint32_t off = c * kWBQ * L::kRB + (r0 + 8 * hh) * L::kRB +
                             j * 16 + tq4 * 4;
        const uint32_t swz = off ^ (((off >> 7) & L::kSwzMask) << 4);
        st_shared(sQ + swz, pack_bf16(o[4 * jj + 2 * hh] * inv[hh],
                                      o[4 * jj + 2 * hh + 1] * inv[hh]));
      }
    fence_proxy_async();  // the stores above, before TMA reads them
    sync_warpgroup(1 + w);
    if (tid == 0 && wg_live) {
      for (int c = 0; c < L::kCB; ++c)
        tma_store(&to, sQ + c * kWBQ * L::kRB + 64 * w * L::kRB,
                  c * L::kBC, wrow0, h, bi);
      tma_store_wait();
    }
  }
}

// ------------------------------------------------------------- launch --

// A 4-D bfloat16 map (D, rows, heads, batch) with the given byte strides
// (rows, heads, batch) and a box of kBC columns by `box_rows` rows.
template <int D>
bool encode_map(CUtensorMap* map, const void* base, int rows, int heads,
                int batch, const long long* bstrides, int box_rows) {
  return encode_bf16_map(map, base, D, rows, heads, batch, bstrides,
                         WgLayout<D>::kBC, box_rows);
}

// bstrides: byte strides (batch, head, row) of q, then k, then v.
template <int D>
int launch_f32(const void* q, const void* k, const void* v, void* o,
               float* lse, int b, int hq, int hkv, int sq, int skv,
               int causal, int window, float softcap, float scale,
               const long long* bstrides, cudaStream_t stream) {
  const size_t smem = Layout<D>::kSmemFloats * sizeof(float);
  static unsigned long long attr = 0;  // a bit a card
  const cudaError_t err = allow_smem(flash_f32_kernel<D>, smem, attr);
  if (err != cudaSuccess) return (int)err;
  HeadStrides st[3];
  for (int i = 0; i < 3; ++i) {
    if (bstrides[3 * i + 2] / 4 > 0x7fffffff)
      return (int)cudaErrorInvalidValue;
    st[i] = {bstrides[3 * i] / 4, bstrides[3 * i + 1] / 4,
             (int)(bstrides[3 * i + 2] / 4)};
  }
  const dim3 grid((sq + kBQ - 1) / kBQ, b * hq);
  flash_f32_kernel<D><<<grid, kThreads, smem, stream>>>(
      (const float*)q, (const float*)k, (const float*)v, (float*)o, lse, st[0],
      st[1], st[2], hq, hkv, sq, skv, causal, window, softcap, scale);
  return (int)cudaGetLastError();
}

template <int D>
int launch_bf16(const void* q, const void* k, const void* v, void* o,
                float* lse, int b, int hq, int hkv, int sq, int skv,
                int causal, int window, float softcap, float scale,
                const long long* bstrides, cudaStream_t stream) {
  const size_t smem = WgLayout<D>::kSmemBytes;
  static unsigned long long attr = 0;  // a bit a card
  const cudaError_t err = allow_smem(flash_wgmma_kernel<D>, smem, attr);
  if (err != cudaSuccess) return (int)err;
  const long long ost[3] = {(long long)hq * sq * D * 2, (long long)sq * D * 2,
                            (long long)D * 2};
  CUtensorMap mq, mk, mv, mo;
  if (!encode_map<D>(&mq, q, sq, hq, b, bstrides, kWBQ) ||
      !encode_map<D>(&mk, k, skv, hkv, b, bstrides + 3, kWBK) ||
      !encode_map<D>(&mv, v, skv, hkv, b, bstrides + 6, kWBK) ||
      !encode_map<D>(&mo, o, sq, hq, b, ost, kWBQ / 2))
    return (int)cudaErrorInvalidValue;
  const dim3 grid(b * hq, (sq + kWBQ - 1) / kWBQ);
  flash_wgmma_kernel<D><<<grid, kWThreads, smem, stream>>>(
      mq, mk, mv, mo, lse, hq, hkv, sq, skv, causal, window, softcap, scale);
  return (int)cudaGetLastError();
}

template <int D>
int launch(int dtype, const void* q, const void* k, const void* v, void* o,
           float* lse, int b, int hq, int hkv, int sq, int skv, int causal,
           int window, float softcap, float scale, const long long* bstrides,
           cudaStream_t stream) {
  if (dtype == 0)
    return launch_f32<D>(q, k, v, o, lse, b, hq, hkv, sq, skv, causal, window,
                         softcap, scale, bstrides, stream);
  if (dtype == 1)
    return launch_bf16<D>(q, k, v, o, lse, b, hq, hkv, sq, skv, causal, window,
                          softcap, scale, bstrides, stream);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// Dynamic shared memory of one CTA of flash_wgmma_kernel<d>; -1 for an
// unsupported d.
extern "C" int lm_flash_wgmma_smem_bytes(int d) {
  switch (d) {
#define SMEM_CASE(D) \
  case D:            \
    return (int)WgLayout<D>::kSmemBytes;
    SMEM_CASE(16)
    SMEM_CASE(32)
    SMEM_CASE(64)
    SMEM_CASE(128)
    SMEM_CASE(256)
#undef SMEM_CASE
    default:
      return -1;
  }
}

// dtype: 0 float32 (CUDA cores), 1 bfloat16 (tensor cores).  window <= 0:
// no window; softcap <= 0: none.  strides: 9 byte strides, (batch, head,
// row) of q, k and v, each a positive multiple of 16; o is contiguous.
// lse: null, or float32 [B, Hq, Sq] for each row's log-sum-exp.
extern "C" int lm_flash_attention(const void* q, const void* k,
                                  const void* v, void* o, void* lse, int b,
                                  int hq,
                                  int hkv, int sq, int skv, int d, int dtype,
                                  int causal, int window, float softcap,
                                  float scale, const long long* strides,
                                  void* stream) {
  if (hkv <= 0 || hq % hkv != 0) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  switch (d) {
#define FLASH_CASE(D)                                                        \
  case D:                                                                    \
    return launch<D>(dtype, q, k, v, o, (float*)lse, b, hq, hkv, sq, skv,   \
                     causal, window, softcap, scale, strides, st);
    FLASH_CASE(16)
    FLASH_CASE(32)
    FLASH_CASE(64)
    FLASH_CASE(128)
    FLASH_CASE(256)
#undef FLASH_CASE
    default:
      return (int)cudaErrorInvalidValue;
  }
}
