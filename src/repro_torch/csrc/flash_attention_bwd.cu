// flash_attention_bwd: the gradient of flash attention (kernel 10's
// backward) with respect to q, k and v.
//
// Replaces no TPU kernel: the reference's Pallas flash kernel has no VJP,
// and its training step takes the gradient of the same attention from XLA's
// autodiff of ops.attention off the TPU (repro/train/step.py, value_and_grad
// of the loss; repro/kernels/ops.py sends a cache-less call to
// ref.local_attention / ref.blockwise_attention there).  The port sends
// every cache-less call to its flash kernel (flash_attention.cu), so the
// gradient of that call is a kernel too.
//
// The function: for q [B, Hq, Sq, D], k and v [B, Hkv, Skv, D], the output
// o, each row's log-sum-exp `lse` [B, Hq, Sq] from the forward kernel and
// the output's gradient dO, the exact gradient of what the forward
// computes: s = scale q.k; the optional soft-cap x = c tanh(s / c) before
// the masks (queries right-aligned to keys, causal, window); p = exp(x -
// lse) on live pairs, 0 elsewhere; then
//   D_i  = rowsum(dO_i o_i)                         (flash_bwd_pre_kernel)
//   dP   = dO v^T,  dX = p (dP - D_i),  dS = dX (1 - tanh^2(s / c)) scale
//   dv_j = sum_i p_ij dO_i,  dk_j = sum_i dS_ij q_i   (flash_bwd_dkdv_kernel)
//   dq_i = sum_j dS_ij k_j                          (flash_bwd_dq_kernel)
// GQA: dk and dv sum over the q heads of a kv head.  A row with no live
// key has lse -1e30 and p 0 everywhere, so it adds nothing and gets dq 0.
// Inputs float32 or bfloat16, read as float32 into shared memory; every
// sum in float32; dq, dk, dv are written in the input's type, contiguous.
//
// The schedule (one CTA, 256 threads, CUDA cores):
// * dk/dv: one CTA per (batch, kv head, tile of BK keys).  Its K and V
//   tiles stay in shared memory; it loops over the q heads of its group
//   and over the q tiles of BQ rows that its masks leave live for some
//   key of the tile, and per q tile stages q, dO, lse and D_i, computes
//   the scores and dP (each thread a block of the BQ x BK tile, float4
//   reads over D), p and dS into shared memory, then accumulates dv and
//   dk (each thread a few rows x float4 columns, in registers).
// * dq: one CTA per (batch, q head, tile of BQ rows), over the live kv
//   tiles, recomputing the scores, p, dP and dS the same way, and
//   accumulating dq in registers.
// No atomics: each output element is summed by one thread in a fixed
// order, so two runs give the same gradient bit for bit.  The scores and
// dP are computed twice (once per kernel), 7 products of D per live pair
// against the 5 that the gradient needs.
//
// What bounds it on the H100: the operations.  The gradient does 10 D
// operations per live (query, key) pair and head; gemma3-1b's global layer
// at S = 4096 (4 heads, D 256) is 86 GFLOP a sequence, against ~25 MB of
// q, k, v, o, dO and the three gradients in bfloat16.  This kernel does
// that arithmetic on the CUDA cores in float32 (67 TFLOP/s at most, 15x
// below the bfloat16 tensor cores), reading both operands of every
// multiply-add from shared memory.  The tile sizes follow D: at D 256 a
// 64-key tile's float32 dk and dv accumulators alone would be 128 KB, so
// D 256 takes 32-key and 32-row tiles (142 KB of shared memory with the
// tiles padded by 4 floats a row for conflict-free 16-byte reads; the card
// allows 227 KB a block, static and dynamic together).  wgmma and TMA, as
// the forward's bfloat16 kernel uses them, are the next design.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr float kNegInf = -1e30f;

// Tile sizes by head dim: BQ query rows by BK keys.
template <int D>
struct BwdTiles {
  static constexpr int kBQ = D >= 256 ? 32 : 64;
  static constexpr int kBK = D >= 256 ? 32 : 64;
  static constexpr int kRow = D + 4;      // padded row of a [rows][D] tile
  static constexpr int kSS = kBK + 1;     // padded row of a [BQ][BK] tile
  // Accumulator layout: kTD float4 column groups x kTR row groups; a
  // thread owns kRPT rows and kF4 float4 columns (strided by kTD).
  static constexpr int kTD = (D / 4 < 16) ? D / 4 : 16;
  static constexpr int kTR = kThreads / kTD;
  static constexpr int kF4 = D / 4 / kTD;
  // Score layout: 16 x 16 threads, each kSA rows x kSB columns of the tile.
  static constexpr int kSA = kBQ / 16;
  static constexpr int kSB = kBK / 16;
  // Shared memory: two [BK][kRow] tiles (K, V), two [BQ][kRow] (q, dO), two
  // [BQ][kSS] (p, dS) and the rows' lse and D_i.
  static constexpr size_t kSmemFloats =
      2 * (size_t)kBK * kRow + 2 * (size_t)kBQ * kRow +
      2 * (size_t)kBQ * kSS + 2 * kBQ;
  static_assert(kTR * kTD == kThreads && kF4 >= 1, "unsupported head dim");
  static_assert(kBQ % 16 == 0 && kBK % 16 == 0 && kBQ % kTR == 0 &&
                    kBK % kTR == 0,
                "unsupported tiles");
};

struct Float4x {  // a float4 that loads from and stores to T
  __device__ static float4 load(const float* p) {
    return *reinterpret_cast<const float4*>(p);
  }
  __device__ static float4 load(const __nv_bfloat16* p) {
    const uint2 u = *reinterpret_cast<const uint2*>(p);
    const __nv_bfloat162 a = *reinterpret_cast<const __nv_bfloat162*>(&u.x);
    const __nv_bfloat162 b = *reinterpret_cast<const __nv_bfloat162*>(&u.y);
    const float2 fa = __bfloat1622float2(a), fb = __bfloat1622float2(b);
    return make_float4(fa.x, fa.y, fb.x, fb.y);
  }
  __device__ static void store(float* p, float4 v) {
    *reinterpret_cast<float4*>(p) = v;
  }
  __device__ static void store(__nv_bfloat16* p, float4 v) {
    __nv_bfloat162 a = __floats2bfloat162_rn(v.x, v.y);
    __nv_bfloat162 b = __floats2bfloat162_rn(v.z, v.w);
    uint2 u;
    u.x = *reinterpret_cast<uint32_t*>(&a);
    u.y = *reinterpret_cast<uint32_t*>(&b);
    *reinterpret_cast<uint2*>(p) = u;
  }
};

__device__ __forceinline__ float4 lds4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ float dot4(float4 a, float4 b) {
  return a.x * b.x + a.y * b.y + a.z * b.z + a.w * b.w;
}

__device__ __forceinline__ void fma4(float4& acc, float s, float4 v) {
  acc.x += s * v.x;
  acc.y += s * v.y;
  acc.z += s * v.z;
  acc.w += s * v.w;
}

// Rows [row0, row0 + rows) of a contiguous [S, D] head slice -> shared
// memory (row stride `stride` floats); rows at or past `limit` are zero.
template <int D, typename T>
__device__ __forceinline__ void stage(float* dst, int stride, const T* src,
                                      int row0, int rows, int limit) {
  constexpr int kF = D / 4;
  for (int e = threadIdx.x; e < rows * kF; e += kThreads) {
    const int r = e / kF, c = (e % kF) * 4;
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (row0 + r < limit) v = Float4x::load(src + (size_t)(row0 + r) * D + c);
    *reinterpret_cast<float4*>(dst + r * stride + c) = v;
  }
}

// The masks and the shape, shared by both kernels.
struct Mask {
  int sq, skv, causal, window;
  float softcap, scale;
  // Is (query row i, key j) live?
  __device__ __forceinline__ bool live(int i, int j) const {
    if (i >= sq || j >= skv) return false;
    const int qpos = skv - sq + i;
    if (causal && j > qpos) return false;
    if (window > 0 && j <= qpos - window) return false;
    return true;
  }
};

// One (BQ x BK) tile: the scores of q rows [q0, q0 + BQ) against keys
// [k0, k0 + BK) and dP = dO v^T, then p -> Ps and dS -> Ds (both [BQ][kSS]).
// Qs, dOs: [BQ][kRow]; Ks, Vs: [BK][kRow]; lse_s, dd_s: [BQ].
template <int D>
__device__ __forceinline__ void tile_p_ds(const float* Qs, const float* dOs,
                                          const float* Ks, const float* Vs,
                                          const float* lse_s,
                                          const float* dd_s, float* Ps,
                                          float* Ds, int q0, int k0,
                                          const Mask& mk) {
  using L = BwdTiles<D>;
  const int tc = threadIdx.x % 16, tr = threadIdx.x / 16;
  float s[L::kSA][L::kSB], dp[L::kSA][L::kSB];
#pragma unroll
  for (int a = 0; a < L::kSA; ++a)
#pragma unroll
    for (int b = 0; b < L::kSB; ++b) s[a][b] = dp[a][b] = 0.f;
#pragma unroll 2
  for (int c = 0; c < D; c += 4) {
    float4 qv[L::kSA], ov[L::kSA], kv[L::kSB], vv[L::kSB];
#pragma unroll
    for (int a = 0; a < L::kSA; ++a) {
      qv[a] = lds4(Qs + (tr + 16 * a) * L::kRow + c);
      ov[a] = lds4(dOs + (tr + 16 * a) * L::kRow + c);
    }
#pragma unroll
    for (int b = 0; b < L::kSB; ++b) {
      kv[b] = lds4(Ks + (tc + 16 * b) * L::kRow + c);
      vv[b] = lds4(Vs + (tc + 16 * b) * L::kRow + c);
    }
#pragma unroll
    for (int a = 0; a < L::kSA; ++a)
#pragma unroll
      for (int b = 0; b < L::kSB; ++b) {
        s[a][b] += dot4(qv[a], kv[b]);
        dp[a][b] += dot4(ov[a], vv[b]);
      }
  }
  const bool capped = mk.softcap > 0.f;
#pragma unroll
  for (int a = 0; a < L::kSA; ++a) {
    const int r = tr + 16 * a;
    const float lse = lse_s[r], dd = dd_s[r];
#pragma unroll
    for (int b = 0; b < L::kSB; ++b) {
      const int cidx = tc + 16 * b;
      float x = s[a][b] * mk.scale, dcap = 1.f;
      if (capped) {
        const float t = tanhf(x / mk.softcap);
        x = mk.softcap * t;
        dcap = 1.f - t * t;
      }
      const bool ok = mk.live(q0 + r, k0 + cidx);
      const float p = ok ? expf(x - lse) : 0.f;
      Ps[r * L::kSS + cidx] = p;
      Ds[r * L::kSS + cidx] = p * (dp[a][b] - dd) * dcap * mk.scale;
    }
  }
}

// D_i = rowsum(dO_i o_i) over `rows` contiguous rows of width d: one
// thread a row.
template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_pre_kernel(const T* __restrict__ o, const T* __restrict__ dout,
                     float* __restrict__ delta, long long rows) {
  const long long r = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (r >= rows) return;
  const T* orow = o + r * D;
  const T* drow = dout + r * D;
  float acc = 0.f;
#pragma unroll 4
  for (int c = 0; c < D; c += 4)
    acc += dot4(Float4x::load(orow + c), Float4x::load(drow + c));
  delta[r] = acc;
}

// One CTA: BK keys of one (batch, kv head); see the header note.
template <typename T, int D>
__global__ void __launch_bounds__(kThreads, 1)
flash_bwd_dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                      const T* __restrict__ v, const T* __restrict__ dout,
                      const float* __restrict__ lse,
                      const float* __restrict__ delta, T* __restrict__ dk,
                      T* __restrict__ dv, int hq, int hkv, Mask mk) {
  using L = BwdTiles<D>;
  extern __shared__ float smem[];
  float* Ks = smem;                        // [BK][kRow]
  float* Vs = Ks + L::kBK * L::kRow;       // [BK][kRow]
  float* Qs = Vs + L::kBK * L::kRow;       // [BQ][kRow]
  float* dOs = Qs + L::kBQ * L::kRow;      // [BQ][kRow]
  float* Ps = dOs + L::kBQ * L::kRow;      // [BQ][kSS]
  float* Ds = Ps + L::kBQ * L::kSS;        // [BQ][kSS]
  float* lse_s = Ds + L::kBQ * L::kSS;     // [BQ]
  float* dd_s = lse_s + L::kBQ;            // [BQ]

  const int t = threadIdx.x;
  const int bk = blockIdx.y;               // batch * hkv + kv head
  const int bi = bk / hkv, kvh = bk % hkv, group = hq / hkv;
  const int k0 = blockIdx.x * L::kBK;
  const int sq = mk.sq, skv = mk.skv;
  const size_t kv_off = (size_t)bk * skv * D;
  stage<D>(Ks, L::kRow, k + kv_off, k0, L::kBK, skv);
  stage<D>(Vs, L::kRow, v + kv_off, k0, L::kBK, skv);

  // The q rows that some key of this tile is live for.
  const int kmax = min(k0 + L::kBK, skv) - 1;
  const int shift = skv - sq;              // query i sits at key shift + i
  const int i_lo = mk.causal ? max(0, k0 - shift) : 0;
  const int i_hi = mk.window > 0 ? min(sq, kmax + mk.window - shift) : sq;
  const int t_lo = i_lo / L::kBQ;
  const int t_hi = i_hi > i_lo ? (i_hi + L::kBQ - 1) / L::kBQ : t_lo;

  const int ad = t % L::kTD, ar = (t / L::kTD) * (L::kBK / L::kTR);
  constexpr int kRPT = L::kBK / L::kTR;
  float4 adk[kRPT][L::kF4], adv[kRPT][L::kF4];
#pragma unroll
  for (int i = 0; i < kRPT; ++i)
#pragma unroll
    for (int f = 0; f < L::kF4; ++f)
      adk[i][f] = adv[i][f] = make_float4(0.f, 0.f, 0.f, 0.f);

  for (int g = 0; g < group; ++g) {
    const int h = kvh * group + g;
    const size_t q_off = ((size_t)bi * hq + h) * sq;
    for (int tile = t_lo; tile < t_hi; ++tile) {
      const int q0 = tile * L::kBQ;
      __syncthreads();                     // the previous tile is consumed
      stage<D>(Qs, L::kRow, q + q_off * D, q0, L::kBQ, sq);
      stage<D>(dOs, L::kRow, dout + q_off * D, q0, L::kBQ, sq);
      for (int r = t; r < L::kBQ; r += kThreads) {
        const bool in = q0 + r < sq;
        lse_s[r] = in ? lse[q_off + q0 + r] : 0.f;
        dd_s[r] = in ? delta[q_off + q0 + r] : 0.f;
      }
      __syncthreads();
      tile_p_ds<D>(Qs, dOs, Ks, Vs, lse_s, dd_s, Ps, Ds, q0, k0, mk);
      __syncthreads();
      // dv += p^T dO, dk += dS^T q over the tile's rows.
#pragma unroll 2
      for (int i = 0; i < L::kBQ; ++i) {
        float4 ov[L::kF4], qv[L::kF4];
#pragma unroll
        for (int f = 0; f < L::kF4; ++f) {
          ov[f] = lds4(dOs + i * L::kRow + (ad + L::kTD * f) * 4);
          qv[f] = lds4(Qs + i * L::kRow + (ad + L::kTD * f) * 4);
        }
#pragma unroll
        for (int j = 0; j < kRPT; ++j) {
          const float p = Ps[i * L::kSS + ar + j];
          const float ds = Ds[i * L::kSS + ar + j];
#pragma unroll
          for (int f = 0; f < L::kF4; ++f) {
            fma4(adv[j][f], p, ov[f]);
            fma4(adk[j][f], ds, qv[f]);
          }
        }
      }
    }
  }
#pragma unroll
  for (int j = 0; j < kRPT; ++j) {
    const int key = k0 + ar + j;
    if (key >= skv) continue;
#pragma unroll
    for (int f = 0; f < L::kF4; ++f) {
      const size_t off = kv_off + (size_t)key * D + (ad + L::kTD * f) * 4;
      Float4x::store(dk + off, adk[j][f]);
      Float4x::store(dv + off, adv[j][f]);
    }
  }
}

// One CTA: BQ rows of one (batch, q head); see the header note.
template <typename T, int D>
__global__ void __launch_bounds__(kThreads, 1)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const T* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta, T* __restrict__ dq,
                    int hq, int hkv, Mask mk) {
  using L = BwdTiles<D>;
  extern __shared__ float smem[];
  float* Ks = smem;
  float* Vs = Ks + L::kBK * L::kRow;
  float* Qs = Vs + L::kBK * L::kRow;
  float* dOs = Qs + L::kBQ * L::kRow;
  float* Ps = dOs + L::kBQ * L::kRow;
  float* Ds = Ps + L::kBQ * L::kSS;
  float* lse_s = Ds + L::kBQ * L::kSS;
  float* dd_s = lse_s + L::kBQ;

  const int t = threadIdx.x;
  const int bh = blockIdx.y;               // batch * hq + q head
  const int bi = bh / hq, h = bh % hq, kvh = h / (hq / hkv);
  const int q0 = blockIdx.x * L::kBQ;
  const int sq = mk.sq, skv = mk.skv;
  const size_t q_off = (size_t)bh * sq;
  const size_t kv_off = ((size_t)bi * hkv + kvh) * skv * D;
  stage<D>(Qs, L::kRow, q + q_off * D, q0, L::kBQ, sq);
  stage<D>(dOs, L::kRow, dout + q_off * D, q0, L::kBQ, sq);
  for (int r = t; r < L::kBQ; r += kThreads) {
    const bool in = q0 + r < sq;
    lse_s[r] = in ? lse[q_off + q0 + r] : 0.f;
    dd_s[r] = in ? delta[q_off + q0 + r] : 0.f;
  }

  // The live kv range of this q tile (the forward's).
  const int qpos0 = skv - sq + q0;
  const int qlast = skv - sq + min(q0 + L::kBQ, sq) - 1;
  const int kv_hi = mk.causal ? min(skv, qlast + 1) : skv;
  const int kv_lo = mk.window > 0 ? max(0, qpos0 - mk.window + 1) : 0;
  const int t_lo = kv_lo / L::kBK;
  const int t_hi = kv_hi > kv_lo ? (kv_hi + L::kBK - 1) / L::kBK : t_lo;

  constexpr int kRPT = L::kBQ / L::kTR;
  const int ad = t % L::kTD, ar = (t / L::kTD) * kRPT;
  float4 acc[kRPT][L::kF4];
#pragma unroll
  for (int i = 0; i < kRPT; ++i)
#pragma unroll
    for (int f = 0; f < L::kF4; ++f)
      acc[i][f] = make_float4(0.f, 0.f, 0.f, 0.f);

  for (int tile = t_lo; tile < t_hi; ++tile) {
    const int k0 = tile * L::kBK;
    __syncthreads();                       // the previous tile is consumed
    stage<D>(Ks, L::kRow, k + kv_off, k0, L::kBK, skv);
    stage<D>(Vs, L::kRow, v + kv_off, k0, L::kBK, skv);
    __syncthreads();
    tile_p_ds<D>(Qs, dOs, Ks, Vs, lse_s, dd_s, Ps, Ds, q0, k0, mk);
    __syncthreads();
    // dq += dS k over the tile's keys.
#pragma unroll 2
    for (int j = 0; j < L::kBK; ++j) {
      float4 kv[L::kF4];
#pragma unroll
      for (int f = 0; f < L::kF4; ++f)
        kv[f] = lds4(Ks + j * L::kRow + (ad + L::kTD * f) * 4);
#pragma unroll
      for (int i = 0; i < kRPT; ++i) {
        const float ds = Ds[(ar + i) * L::kSS + j];
#pragma unroll
        for (int f = 0; f < L::kF4; ++f) fma4(acc[i][f], ds, kv[f]);
      }
    }
  }
#pragma unroll
  for (int i = 0; i < kRPT; ++i) {
    const int row = q0 + ar + i;
    if (row >= sq) continue;
#pragma unroll
    for (int f = 0; f < L::kF4; ++f)
      Float4x::store(dq + (q_off + row) * D + (ad + L::kTD * f) * 4,
                     acc[i][f]);
  }
}

template <typename K>
cudaError_t allow_smem(K kernel, size_t smem, bool& done) {
  if (done) return cudaSuccess;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  done = err == cudaSuccess;
  return err;
}

template <typename T, int D>
int launch_pre(const void* o, const void* dout, void* delta, long long rows,
               cudaStream_t stream) {
  const long long blocks = (rows + kThreads - 1) / kThreads;
  if (blocks == 0) return (int)cudaSuccess;
  flash_bwd_pre_kernel<T, D><<<(unsigned)blocks, kThreads, 0, stream>>>(
      (const T*)o, (const T*)dout, (float*)delta, rows);
  return (int)cudaGetLastError();
}

template <typename T, int D>
int launch_dkdv(const void* q, const void* k, const void* v, const void* dout,
                const void* lse, const void* delta, void* dk, void* dv, int b,
                int hq, int hkv, const Mask& mk, cudaStream_t stream) {
  using L = BwdTiles<D>;
  const size_t smem = L::kSmemFloats * sizeof(float);
  static bool attr = false;
  const cudaError_t err = allow_smem(flash_bwd_dkdv_kernel<T, D>, smem, attr);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((mk.skv + L::kBK - 1) / L::kBK, b * hkv);
  flash_bwd_dkdv_kernel<T, D><<<grid, kThreads, smem, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (const T*)dout,
      (const float*)lse, (const float*)delta, (T*)dk, (T*)dv, hq, hkv, mk);
  return (int)cudaGetLastError();
}

template <typename T, int D>
int launch_dq(const void* q, const void* k, const void* v, const void* dout,
              const void* lse, const void* delta, void* dq, int b, int hq,
              int hkv, const Mask& mk, cudaStream_t stream) {
  using L = BwdTiles<D>;
  const size_t smem = L::kSmemFloats * sizeof(float);
  static bool attr = false;
  const cudaError_t err = allow_smem(flash_bwd_dq_kernel<T, D>, smem, attr);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((mk.sq + L::kBQ - 1) / L::kBQ, b * hq);
  flash_bwd_dq_kernel<T, D><<<grid, kThreads, smem, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (const T*)dout,
      (const float*)lse, (const float*)delta, (T*)dq, hq, hkv, mk);
  return (int)cudaGetLastError();
}

bool valid_shape(int b, int hq, int hkv, int sq, int skv) {
  return b > 0 && hkv > 0 && hq % hkv == 0 && sq > 0 && skv > 0;
}

}  // namespace

#define BWD_SWITCH(CALL)                                          \
  switch (d * 2 + dtype) {                                        \
    case 16 * 2: return CALL(float, 16);                          \
    case 16 * 2 + 1: return CALL(__nv_bfloat16, 16);              \
    case 32 * 2: return CALL(float, 32);                          \
    case 32 * 2 + 1: return CALL(__nv_bfloat16, 32);              \
    case 64 * 2: return CALL(float, 64);                          \
    case 64 * 2 + 1: return CALL(__nv_bfloat16, 64);              \
    case 128 * 2: return CALL(float, 128);                        \
    case 128 * 2 + 1: return CALL(__nv_bfloat16, 128);            \
    case 256 * 2: return CALL(float, 256);                        \
    case 256 * 2 + 1: return CALL(__nv_bfloat16, 256);            \
    default: return (int)cudaErrorInvalidValue;                   \
  }

// D_i = rowsum(dO * o) over `rows` contiguous rows of width d: o and dout
// of dtype (0 float32, 1 bfloat16), delta float32 [rows].
extern "C" int lm_flash_bwd_pre(const void* o, const void* dout, void* delta,
                                long long rows, int d, int dtype,
                                void* stream) {
  if (dtype != 0 && dtype != 1) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
#define PRE(T, D) launch_pre<T, D>(o, dout, delta, rows, st)
  BWD_SWITCH(PRE)
#undef PRE
}

// dk, dv [B, Hkv, Skv, D] (contiguous, the inputs' type) of contiguous q,
// dout [B, Hq, Sq, D], k, v [B, Hkv, Skv, D], float32 lse and delta [B, Hq,
// Sq].  window <= 0: none; softcap <= 0: none.
extern "C" int lm_flash_bwd_dkdv(const void* q, const void* k, const void* v,
                                 const void* dout, const void* lse,
                                 const void* delta, void* dk, void* dv, int b,
                                 int hq, int hkv, int sq, int skv, int d,
                                 int dtype, int causal, int window,
                                 float softcap, float scale, void* stream) {
  if (!valid_shape(b, hq, hkv, sq, skv)) return (int)cudaErrorInvalidValue;
  const Mask mk{sq, skv, causal, window, softcap, scale};
  const cudaStream_t st = (cudaStream_t)stream;
#define DKDV(T, D) \
  launch_dkdv<T, D>(q, k, v, dout, lse, delta, dk, dv, b, hq, hkv, mk, st)
  BWD_SWITCH(DKDV)
#undef DKDV
}

// dq [B, Hq, Sq, D] (contiguous, the inputs' type); the rest as above.
extern "C" int lm_flash_bwd_dq(const void* q, const void* k, const void* v,
                               const void* dout, const void* lse,
                               const void* delta, void* dq, int b, int hq,
                               int hkv, int sq, int skv, int d, int dtype,
                               int causal, int window, float softcap,
                               float scale, void* stream) {
  if (!valid_shape(b, hq, hkv, sq, skv)) return (int)cudaErrorInvalidValue;
  const Mask mk{sq, skv, causal, window, softcap, scale};
  const cudaStream_t st = (cudaStream_t)stream;
#define DQ(T, D) \
  launch_dq<T, D>(q, k, v, dout, lse, delta, dq, b, hq, hkv, mk, st)
  BWD_SWITCH(DQ)
#undef DQ
}
