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
//
// The TPU kernel walks a grid (B * Hq, Sq / BQ, Skv / BK) in order and
// carries its online-softmax state in VMEM scratch across the kv axis.  A
// CUDA grid has no order, so here one CTA owns one (batch x q head, 64-row
// q tile) and loops over the kv tiles itself.  The loop bounds cover only
// the tiles that the causal and window masks leave live for some row of the
// q tile: the TPU kernel's block_live early-out, without visiting the dead
// tiles at all.
//
// What bounds it on the H100: the operations.  A global layer of gemma3-1b
// at S = 8192 does 4 * D operations per live (query, key) pair, 137 GFLOP
// per launch against 42 MB of q, k, v and o in bfloat16; a window of 512
// keys cuts the pairs by 8, and the ratio stays far above the card's
// balance point of ~295 operations per byte.  So the tensor cores set the
// pace, and the design follows them where the type allows:
//
// * bfloat16 (the model's activations): flash_bf16_kernel, 8 warps of 16
//   q rows each (128 rows, the reference's bq), 64-key tiles, m16n8k16
//   mma.sync with float32 accumulators, fragments by ldmatrix.  The
//   scores never leave registers: the online softmax works on the
//   accumulator fragments (a row's values sit in the four threads of a
//   quad, reduced by two shuffles; masks only on tiles that cross a mask
//   edge) and p is re-packed in place as the bfloat16 A operand of P V,
//   whose V fragments come from a transposing ldmatrix.  The output
//   accumulator (D / 2 floats a thread) stays in registers.  K and V are
//   double-buffered: cp.async brings the next tile while the current one
//   is computed.  Tiles are staged row-major with rows padded by 8
//   elements, so the eight 16-byte rows an ldmatrix reads fall in
//   distinct banks.  q tiles are issued heaviest (latest) first to even
//   out the causal triangle.  p is rounded to bfloat16 for P V, as every
//   tensor-core flash kernel does; the denominator sums the float32 p.
// * float32 (the serving consistency check, the tests): flash_f32_kernel
//   on the CUDA cores, 256 threads; the pre-scaled q tile, the K and V
//   tiles and the score tile sit in shared memory (rows padded by 4 floats
//   for conflict-free 16-byte loads), each thread computes a 4 x 2 block
//   of scores and a 4-row slice of the accumulator, which stays in
//   registers.  TF32 would lose the reference's float32 tolerance.
//
// Not yet done (later work): wgmma and TMA.  Under mma.sync at D = 256 each
// warp re-reads the K and V fragments for its own 16 rows, so the shared
// memory's bandwidth, not the tensor cores, sets the pace; wgmma reads B
// from shared memory once per warpgroup of 64 rows.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

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

// rows [row0, row0 + rows) of a [*, D] head slice -> smem (row stride
// `stride`), times `mul`; rows at or past `limit` are zero.
template <int D>
__device__ __forceinline__ void stage(float* dst, int stride, const float* src,
                                      int row0, int rows, int limit,
                                      float mul) {
  constexpr int kF = D / 4;
  for (int e = threadIdx.x; e < rows * kF; e += kThreads) {
    const int r = e / kF, c = (e % kF) * 4;
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (row0 + r < limit) {
      v = load4(src + (size_t)(row0 + r) * D + c);
      v.x *= mul; v.y *= mul; v.z *= mul; v.w *= mul;
    }
    store4(dst + r * stride + c, v);
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads)
flash_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, float* __restrict__ o, int hq,
                 int hkv, int sq, int skv, int causal, int window,
                 float softcap, float scale) {
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
  const int kvh = (bh / hq) * hkv + (bh % hq) / (hq / hkv);
  const int q0 = blockIdx.x * kBQ;
  const float* qh = q + (size_t)bh * sq * D;
  const float* kh = k + (size_t)kvh * skv * D;
  const float* vh = v + (size_t)kvh * skv * D;

  stage<D>(Qs, L::kRow, qh, q0, kBQ, sq, scale);

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
    stage<D>(Ks, L::kRow, kh, kv0, kBK, skv, 1.f);
    stage<D>(Vs, D, vh, kv0, kBK, skv, 1.f);
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

// ---------------------------------------------------- bfloat16: mma.sync --

// 8 warps of 16 q rows each, 64-key tiles, K and V double-buffered.  Rows
// are padded by 8 bf16 elements, so the eight 16-byte rows an ldmatrix
// reads fall in distinct banks.
constexpr int kMWarps = 8;
constexpr int kMThreads = 32 * kMWarps;
constexpr int kMBQ = 16 * kMWarps;
constexpr int kMBK = 64;
constexpr float kLog2e = 1.4426950408889634f;

template <int D>
struct MmaLayout {
  static constexpr int kRow = D + 8;         // row stride of every tile
  static constexpr int kTile = kMBK * kRow;  // one K or V tile
  static constexpr size_t kSmemBytes =
      sizeof(__nv_bfloat16) * ((size_t)kMBQ * kRow + 4 * (size_t)kTile);
};

// c += a b for one m16n8k16 tile: bf16 inputs, float32 accumulation.
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Four 8x8 bf16 matrices from shared memory, one row address a lane
// (lanes 8i..8i+7 give the rows of matrix i); ``_t`` transposes each.
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4],
                                        const __nv_bfloat16* p) {
  const uint32_t a = (uint32_t)__cvta_generic_to_shared(p);
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a));
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4],
                                          const __nv_bfloat16* p) {
  const uint32_t a = (uint32_t)__cvta_generic_to_shared(p);
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// 16 bytes global -> shared without a register round trip; `bytes` 0
// writes zeros.
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int bytes) {
  const uint32_t d = (uint32_t)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(d), "l"(src), "r"(bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// Wait until at most `pending` committed groups are still in flight.
template <int pending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(pending));
}

// rows [row0, row0 + rows) of a [*, D] bf16 head slice -> smem (row
// stride D + 8), 16 bytes a copy, asynchronously; rows at or past `limit`
// are zero.
template <int D>
__device__ __forceinline__ void stage_bf16(__nv_bfloat16* dst,
                                           const __nv_bfloat16* src,
                                           int row0, int rows, int limit) {
  constexpr int kC = D / 8;  // 16-byte chunks per row
  for (int e = threadIdx.x; e < rows * kC; e += kMThreads) {
    const int r = e / kC, c = (e % kC) * 8;
    const bool in = row0 + r < limit;
    cp_async16(dst + r * MmaLayout<D>::kRow + c,
               src + (in ? (size_t)(row0 + r) * D + c : 0), in ? 16 : 0);
  }
}

// One CTA: 128 q rows of one (batch, q head), 16 rows per warp.  Per kv
// tile of 64 keys (the next tile's K and V already in flight by cp.async):
// S = Q K^T with m16n8k16 mma.sync (A and B fragments by ldmatrix from the
// Q and K tiles), the online softmax on the accumulator fragments in
// registers (a row's values live in the four threads of a quad; masks only
// on tiles that cross a mask edge), then O += P V with P re-packed to bf16
// A fragments straight from the S accumulators and the V fragments by
// transposing ldmatrix.  O stays in registers (D / 2 floats a thread).
template <int D>
__global__ void __launch_bounds__(kMThreads, 1)
flash_bf16_kernel(const __nv_bfloat16* __restrict__ q,
                 const __nv_bfloat16* __restrict__ k,
                 const __nv_bfloat16* __restrict__ v,
                 __nv_bfloat16* __restrict__ o, int hq, int hkv, int sq,
                 int skv, int causal, int window, float softcap,
                 float scale) {
  using L = MmaLayout<D>;
  constexpr int kND = D / 8;       // n tiles of the output
  constexpr int kNK = kMBK / 8;    // n tiles of the scores
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* Ks = Qs + kMBQ * L::kRow;   // [2][kMBK][kRow]
  __nv_bfloat16* Vs = Ks + 2 * L::kTile;      // [2][kMBK][kRow]

  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int g = lane / 4, tq = lane % 4;  // quad group, thread in quad
  const int bh = blockIdx.y;
  const int kvh = (bh / hq) * hkv + (bh % hq) / (hq / hkv);
  // The heaviest (latest) q tiles first: they have the most live keys.
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kMBQ;
  const __nv_bfloat16* kh = k + (size_t)kvh * skv * D;
  const __nv_bfloat16* vh = v + (size_t)kvh * skv * D;

  stage_bf16<D>(Qs, q + (size_t)bh * sq * D, q0, kMBQ, sq);
  const int qpos0 = skv - sq + q0;
  const int qlast = skv - sq + min(q0 + kMBQ, sq) - 1;
  const int kv_hi = causal ? min(skv, qlast + 1) : skv;
  const int kv_lo = window > 0 ? max(0, qpos0 - window + 1) : 0;
  const int tile_lo = kv_lo / kMBK;
  const int tile_hi = kv_hi > kv_lo ? (kv_hi + kMBK - 1) / kMBK : tile_lo;
  // Tiles whose every (row, key) pair is live need no mask.
  const bool rows_full = q0 + kMBQ <= sq;

  if (tile_lo < tile_hi) {
    stage_bf16<D>(Ks, kh, tile_lo * kMBK, kMBK, skv);
    stage_bf16<D>(Vs, vh, tile_lo * kMBK, kMBK, skv);
  }
  cp_async_commit();  // with the Q tile

  // This thread's two rows of the warp's 16: g and g + 8.
  const int r0 = warp * 16 + g;
  const int qp[2] = {qpos0 + r0, qpos0 + r0 + 8};
  const bool rlive[2] = {q0 + r0 < sq, q0 + r0 + 8 < sq};
  float m_run[2] = {kNegInf, kNegInf}, l_run[2] = {0.f, 0.f};
  float acc[kND][4];
#pragma unroll
  for (int n = 0; n < kND; ++n)
    acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
  // ldmatrix row addresses: lane l feeds row l % 8 of matrix l / 8.
  const int lr = lane % 8, lm = lane / 8;
  const __nv_bfloat16* qa =
      Qs + (warp * 16 + lr + 8 * (lm & 1)) * L::kRow + 8 * (lm >> 1);
  const int ka0 = (lr + 8 * (lm >> 1)) * L::kRow + 8 * (lm & 1);
  const int va0 = (lr + 8 * (lm & 1)) * L::kRow + 8 * (lm >> 1);

  for (int tile = tile_lo; tile < tile_hi; ++tile) {
    const int kv0 = tile * kMBK;
    const int buf = (tile - tile_lo) & 1;
    if (tile + 1 < tile_hi) {  // prefetch the next tile into the other half
      stage_bf16<D>(Ks + (buf ^ 1) * L::kTile, kh, kv0 + kMBK, kMBK, skv);
      stage_bf16<D>(Vs + (buf ^ 1) * L::kTile, vh, kv0 + kMBK, kMBK, skv);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // this tile (and the Q tile) visible to every warp
    const __nv_bfloat16* ka = Ks + buf * L::kTile + ka0;
    const __nv_bfloat16* va = Vs + buf * L::kTile + va0;
    const bool full = rows_full && kv0 + kMBK <= skv &&
                      (!causal || kv0 + kMBK - 1 <= qpos0) &&
                      (window <= 0 || kv0 > qlast - window);

    float s[kNK][4];
#pragma unroll
    for (int j = 0; j < kNK; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll 2
    for (int kk = 0; kk < D; kk += 16) {
      uint32_t a[4];
      ldsm_x4(a, qa + kk);
#pragma unroll
      for (int j = 0; j < kNK; j += 2) {
        uint32_t b[4];  // b0, b1 of n tiles j and j + 1
        ldsm_x4(b, ka + 8 * j * L::kRow + kk);
        mma_bf16(s[j], a, b[0], b[1]);
        mma_bf16(s[j + 1], a, b[2], b[3]);
      }
    }

    // Scale, soft-cap, mask; the online softmax per row.
    float mx[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int j = 0; j < kNK; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int h = e / 2;
        bool ok = true;
        if (!full) {
          const int kpos = kv0 + 8 * j + 2 * tq + (e & 1);
          ok = rlive[h] && kpos < skv;
          if (causal) ok = ok && kpos <= qp[h];
          if (window > 0) ok = ok && kpos > qp[h] - window;
        }
        float x = s[j][e] * scale;
        if (softcap > 0.f) x = softcap * tanhf(x / softcap);
        // -inf marks a masked score: its p is 0, and it never sets the max
        s[j][e] = ok ? x : -INFINITY;
        mx[h] = fmaxf(mx[h], ok ? x : kNegInf);
      }
    float alpha[2], sum[2] = {0.f, 0.f};
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
      const float m_cur = fmaxf(m_run[h], mx[h]);
      alpha[h] = exp2f((m_run[h] - m_cur) * kLog2e);
      m_run[h] = m_cur;
    }
#pragma unroll
    for (int j = 0; j < kNK; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int h = e / 2;
        const float p = s[j][e] == -INFINITY
                            ? 0.f
                            : exp2f((s[j][e] - m_run[h]) * kLog2e);
        s[j][e] = p;
        sum[h] += p;
      }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      sum[h] += __shfl_xor_sync(0xffffffffu, sum[h], 1);
      sum[h] += __shfl_xor_sync(0xffffffffu, sum[h], 2);
      l_run[h] = l_run[h] * alpha[h] + sum[h];
    }
#pragma unroll
    for (int n = 0; n < kND; ++n) {
      acc[n][0] *= alpha[0]; acc[n][1] *= alpha[0];
      acc[n][2] *= alpha[1]; acc[n][3] *= alpha[1];
    }

    // O += P V over the tile's keys, 16 at a time.
#pragma unroll
    for (int kk = 0; kk < kNK / 2; ++kk) {
      const uint32_t a[4] = {pack_bf16(s[2 * kk][0], s[2 * kk][1]),
                             pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                             pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                             pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
      for (int n = 0; n < kND; n += 2) {
        uint32_t b[4];  // b0, b1 of n tiles n and n + 1
        ldsm_x4_t(b, va + 16 * kk * L::kRow + 8 * n);
        mma_bf16(acc[n], a, b[0], b[1]);
        mma_bf16(acc[n + 1], a, b[2], b[3]);
      }
    }
    __syncthreads();  // every warp is done with this half before its refill
  }
  cp_async_wait<0>();  // nothing may land after the CTA exits

  __nv_bfloat16* oh = o + (size_t)bh * sq * D;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    if (!rlive[h]) continue;
    const float inv = 1.f / fmaxf(l_run[h], 1e-30f);
    __nv_bfloat16* row = oh + (size_t)(q0 + r0 + 8 * h) * D + 2 * tq;
#pragma unroll
    for (int n = 0; n < kND; ++n)
      *reinterpret_cast<uint32_t*>(row + 8 * n) =
          pack_bf16(acc[n][2 * h] * inv, acc[n][2 * h + 1] * inv);
  }
}

// ------------------------------------------------------------- launch --

template <typename K>
cudaError_t allow_smem(K kernel, size_t smem, bool& done) {
  if (done) return cudaSuccess;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  done = err == cudaSuccess;
  return err;
}

template <int D>
int launch_f32(const void* q, const void* k, const void* v, void* o, int b,
               int hq, int hkv, int sq, int skv, int causal, int window,
               float softcap, float scale, cudaStream_t stream) {
  const size_t smem = Layout<D>::kSmemFloats * sizeof(float);
  static bool attr = false;
  const cudaError_t err = allow_smem(flash_f32_kernel<D>, smem, attr);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((sq + kBQ - 1) / kBQ, b * hq);
  flash_f32_kernel<D><<<grid, kThreads, smem, stream>>>(
      (const float*)q, (const float*)k, (const float*)v, (float*)o, hq, hkv,
      sq, skv, causal, window, softcap, scale);
  return (int)cudaGetLastError();
}

template <int D>
int launch_bf16(const void* q, const void* k, const void* v, void* o, int b,
                int hq, int hkv, int sq, int skv, int causal, int window,
                float softcap, float scale, cudaStream_t stream) {
  const size_t smem = MmaLayout<D>::kSmemBytes;
  static bool attr = false;
  const cudaError_t err = allow_smem(flash_bf16_kernel<D>, smem, attr);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((sq + kMBQ - 1) / kMBQ, b * hq);
  flash_bf16_kernel<D><<<grid, kMThreads, smem, stream>>>(
      (const __nv_bfloat16*)q, (const __nv_bfloat16*)k,
      (const __nv_bfloat16*)v, (__nv_bfloat16*)o, hq, hkv, sq, skv, causal,
      window, softcap, scale);
  return (int)cudaGetLastError();
}

template <int D>
int launch(int dtype, const void* q, const void* k, const void* v, void* o,
           int b, int hq, int hkv, int sq, int skv, int causal, int window,
           float softcap, float scale, cudaStream_t stream) {
  if (dtype == 0)
    return launch_f32<D>(q, k, v, o, b, hq, hkv, sq, skv, causal, window,
                         softcap, scale, stream);
  if (dtype == 1)
    return launch_bf16<D>(q, k, v, o, b, hq, hkv, sq, skv, causal, window,
                          softcap, scale, stream);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// dtype: 0 float32 (CUDA cores), 1 bfloat16 (tensor cores).  window <= 0:
// no window; softcap <= 0: none.
extern "C" int lm_flash_attention(const void* q, const void* k,
                                  const void* v, void* o, int b, int hq,
                                  int hkv, int sq, int skv, int d, int dtype,
                                  int causal, int window, float softcap,
                                  float scale, void* stream) {
  if (hkv <= 0 || hq % hkv != 0) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  switch (d) {
#define FLASH_CASE(D)                                                        \
  case D:                                                                    \
    return launch<D>(dtype, q, k, v, o, b, hq, hkv, sq, skv, causal, window, \
                     softcap, scale, st);
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

