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
// Inputs float32 or bfloat16; every sum in float32; dq, dk, dv are
// written in the input's type, contiguous.
//
// What bounds it on the H100: the operations.  The gradient does 10 D
// operations per live (query, key) pair and head (the scores, dP, dv, dk
// and dq, 2 D each); gemma3-1b's global layer at S = 4096 (4 heads, D 256)
// is 86 GFLOP a sequence (0.087 ms at 989 TFLOP/s) against ~25 MB of q,
// k, v, o, dO and the three gradients in bfloat16.  Without atomics the
// scores and dP are computed once in each of the two kernels: 14 D
// operations a live pair are done for the 10 D that are needed.
//
// * bfloat16 at D 64, 128 and 256 (the model's activations; every head
//   dim of the ten configurations, MLA padded to 256): two kernels on
//   Hopper's warpgroup MMA (wgmma) and tensor memory accelerator (TMA),
//   on the forward's building blocks (hopper.cuh).  Each CTA is three
//   warpgroups: a producer whose one thread issues every TMA load into a
//   ring of kStages stages (full and empty mbarriers, as the forward's),
//   and two consumer warpgroups (setmaxnreg: the producer gives its
//   registers to them).  Tiles are 64 rows (wgmma's M) in the swizzled
//   layout TMA writes and the descriptors read; the tensor maps are 4-D
//   over contiguous [B, H, S, D] tensors, so rows past S read as zero.
//   - flash_bwd_dkdv_wgmma_kernel: a CTA owns a 64-key tile of one
//     (batch, kv head); its K and V tiles are loaded once and stay.  The
//     producer streams q and dO of each live q tile of each q head of the
//     group, and its warp stages the tile's lse and D_i beside them (a 64-float
//     box is more than a short Sq holds, so not by TMA).  With keys as M,
//     warpgroup 1 computes S^T = K q^T, warpgroup 2 dP^T = V dO^T (both
//     K-major, D / 16 wgmma m64n64k16); warpgroup 1 takes p^T = exp(x - lse)
//     and f = p^T (1 - tanh^2) scale on the fragments and hands f to warpgroup
//     2 through a 16 KB float32 exchange under two named barriers (full,
//     empty); warpgroup 2 takes dS^T = f (dP^T - D_i).  Then warpgroup 1
//     accumulates dv += p^T dO and warpgroup 2 dk += dS^T q, each with its
//     operand re-packed as the bfloat16 register A (the accumulator layout is
//     the A fragment layout) and dO or q read MN-major through the descriptor's
//     transpose bit: 4 wgmma m64n(D)k16 a q tile.  The register budget sets the
//     split: at D 256 a 64-key dk or dv accumulator is 128 float32 registers a
//     thread in one warpgroup, so each warpgroup owns one of them, and no
//     product is computed twice. Shared memory at D 256: K and V 64 KB, a
//     two-stage q / dO ring 128 KB, the exchange 16 KB, lse and D_i 1 KB: 209
//     KB + 1 KB alignment of the 227 KB a CTA may have (D <= 128: three
//     stages).  Under the causal mask the CTA of key tile 0 walks every q tile
//     of every head of the group, the last one a single tile: at gemma3-1b's S
//     4096 and B Hkv = 1 that is 4 x 64 tiles for the heaviest of 64 CTAs, on a
//     card of 132 SMs.  So a key tile is a cluster of kParts = 2 CTAs, each
//     walking every other tile of the walk, and rank 0 adds rank 1's float32
//     sums (left in rank 1's free ring) through distributed shared memory, in
//     rank order, before it stores dk and dv: 128 CTAs at B Hkv = 1, the
//     heaviest 128 tiles.  The grid is (kParts, B Hkv, key tiles), the low key
//     tiles (the heaviest) first.
//   - flash_bwd_dq_wgmma_kernel: a CTA owns 64 q rows of one (batch, q
//     head); q and dO are loaded once (each thread reads its two rows' lse and
//     D_i), K and V tiles stream through the ring.  Warpgroup 1 computes S = q
//     K^T, warpgroup 2 dP = dO V^T; each writes its tile (f, or dP) to its own
//     16 KB exchange, and after a named barrier both form the same dS = f (dP -
//     D_i) and accumulate their half of dq's columns, dq += dS K (K MN-major,
//     wgmma m64n(D/2)k16): at D 256 a whole 64 x 256 accumulator would be 128
//     registers beside the two score tiles.  Shared memory at D 256: q and dO
//     64 KB, a two-stage K / V ring 128 KB, the exchanges 32 KB: 226 KB with
//     the alignment.  The grid is (B Hq, q tiles), the latest q tiles (the
//     heaviest under the causal mask) first.
//   Both kernels visit only the tiles that the causal and window masks
//   leave live for some pair (the loop bounds below), and mask only the
//   tiles that cross a causal or window edge or the end of Sq or Skv
//   (tile_full).  p^T and dS^T are rounded to bfloat16 as the A operands
//   of their products, as every tensor-core flash backward does (and as
//   the forward rounds p for P V); every sum, and dS from p, is float32.
//   Each output element is summed by one thread in a fixed order (dk and
//   dv: one a CTA of the cluster, then added in rank order), so two runs
//   give the same gradient bit for bit.
// * float32 (the float32 gradient check, the tests), and bfloat16 at D 16
//   and 32 (test shapes only): the CUDA-core kernels, 256 threads; TF32
//   would lose the float32 tolerance.  dk/dv: one CTA per (batch, kv
//   head, tile of BK keys); its K and V tiles stay in shared memory; it
//   loops over the q heads of its group and over the q tiles of BQ rows
//   that its masks leave live for some key of the tile, and per q tile
//   stages q, dO, lse and D_i, computes the scores and dP (each thread a
//   block of the BQ x BK tile, float4 reads over D), p and dS into shared
//   memory, then accumulates dv and dk (each thread a few rows x float4
//   columns, in registers).  dq: one CTA per (batch, q head, tile of BQ
//   rows), over the live kv tiles, recomputing the scores, p, dP and dS
//   the same way.  Both operands of every multiply-add come from shared
//   memory; at D 256 a 64-key tile's float32 dk and dv accumulators alone
//   would be 128 KB, so D 256 takes 32-key and 32-row tiles.
//
// Times (H100 80GB HBM3 at 700 W, chip_smoke.py phase 6, gemma3-1b's
// training shapes, device time of the three launches): a global layer's
// backward takes 0.325 ms at B 1 (3.7x its 0.087 ms bound; the CUDA-core
// kernels took 10.57 ms) and 0.448 ms at B 2; a 512-window layer's 0.096
// ms at B 1 (4.7x) and 0.179 ms at B 2.  What holds them back, from
// clock64() sections of the heaviest CTA (tools/flash_bwd_probe.py
// --sections) and a count of bytes: a 64 x 64 tile of dk/dv reads ~192
// KB of shared memory in its four products, TMA writes 64 KB and the
// exchange moves 32 KB, ~2250 clocks at the SM's ~128 bytes a clock,
// against ~3300 clocks measured a tile (dq: the same ~288 KB, ~3500
// clocks); the elementwise work between the products (p or dS, the
// exchange) runs while the other warpgroup's products do.  Keep that work
// free of branches (the masks only on tiles not wholly live,
// ex2.approx.ftz for exp2, lse and D_i preloaded into registers, 16-byte
// exchange accesses): a branch per element, as a masked exp2f compiles,
// serialises the 32 elements of a thread and made it the largest span.
#include <type_traits>

#include "hopper.cuh"

namespace {

constexpr int kThreads = 256;

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
  // Is (query row i, key j) live?  Without branches: the bfloat16
  // kernels evaluate it for 32 pairs a thread at once.
  __device__ __forceinline__ bool live(int i, int j) const {
    const int qpos = skv - sq + i;
    return (i < sq) & (j < skv) & (!causal | (j <= qpos)) &
           ((window <= 0) | (j > qpos - window));
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

// ------------------------------- bfloat16: wgmma, TMA, warp-specialised --

constexpr int kWThreads = 384;  // producer + two consumer warpgroups
// CTAs of a dk/dv key tile, one cluster: each sums every kParts-th q tile
// of the tile's walk; rank 0 adds the others' sums in rank order.
constexpr int kParts = 2;
constexpr float kLog2e = 1.4426950408889634f;
// Named barriers of the two consumer warpgroups (256 threads).
constexpr uint32_t kXFull = 1, kXEmpty = 2, kJoint = 3;

// A 64-row bfloat16 tile of D columns, as TMA writes it and the wgmma
// descriptors read it: D / BC column blocks of rows kRB bytes wide (the
// swizzle's width), each block 1024-byte aligned.
template <int D, int BC>
struct WgTile {
  static constexpr int kBC = BC;
  static constexpr int kRB = 2 * BC;
  static constexpr int kCB = D / BC;
  static constexpr int kKPB = kRB / 32;           // k-steps of 16 in a block
  static constexpr uint32_t kDescLayout = kRB == 128 ? 1 : 2;
  static constexpr uint32_t kSwzMask = kRB / 16 - 1;
  static constexpr uint32_t kSbo = 8 * kRB;       // 8-row groups
  static constexpr uint32_t kBlock = 64 * kRB;    // bytes of a column block
  static constexpr uint32_t kBytes = 64 * D * 2;
  static_assert(BC == 32 || BC == 64, "unsupported column block");
};

// Is every pair of q rows [q0, q0 + 64) x keys [k0, k0 + 64) live?
__device__ __forceinline__ bool tile_full(const Mask& mk, int q0, int k0) {
  const int shift = mk.skv - mk.sq;
  return q0 + 64 <= mk.sq && k0 + 64 <= mk.skv &&
         (!mk.causal || k0 + 63 <= shift + q0) &&
         (mk.window <= 0 || k0 > shift + q0 + 63 - mk.window);
}

// acc (64 x 64) = A B^T over D, A and B 64-row tiles (K-major): D / 16
// wgmma m64n64k16, waited for.
template <class L, int D>
__device__ __forceinline__ void tile_product(float (&acc)[32], uint32_t a,
                                             uint32_t b) {
  const uint64_t da = wg_desc(a, 16, L::kSbo, L::kDescLayout);
  const uint64_t db = wg_desc(b, 16, L::kSbo, L::kDescLayout);
  reg_fence(acc);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const uint32_t off = (kk / L::kKPB) * L::kBlock + (kk % L::kKPB) * 32;
    wgmma_ss(acc, da + (off >> 4), db + (off >> 4), kk > 0);
  }
  wgmma_commit();
  wgmma_wait<0>();
  reg_fence(acc);
}

// acc (64 x N) += A (64 x 64: bfloat16 fragments) B (64 x N from column
// block start b, MN-major: the transpose bit), N = 2 x acc's registers;
// waited for.
template <class L, int R>
__device__ __forceinline__ void accumulate(float (&acc)[R],
                                           uint32_t (&pa)[4][4], uint32_t b) {
  const uint64_t db = wg_desc(b, L::kBlock, L::kSbo, L::kDescLayout);
  reg_fence(acc);
  reg_fence(pa);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
    wgmma_rs(acc, pa[kk], db + ((kk * 16 * L::kRB) >> 4));
  wgmma_commit();
  wgmma_wait<0>();
  reg_fence(acc);
  reg_fence(pa);
}

// A 64 x 64 accumulator tile as the bfloat16 A operand, 16 columns a k-step.
__device__ __forceinline__ void pack_a(const float (&x)[32],
                                       uint32_t (&pa)[4][4]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int r = 0; r < 4; ++r)
      pa[kk][r] = pack_bf16(x[8 * kk + 2 * r], x[8 * kk + 2 * r + 1]);
}

// An accumulator (64 x 2R) as bfloat16 into columns [col0, col0 + 2R) of
// the 64-row tile at dst, swizzled; r0 and tq4 place this thread's
// fragments.
template <class L, int R>
__device__ __forceinline__ void store_tile(uint32_t dst, const float (&acc)[R],
                                           int col0, int r0, int tq4) {
#pragma unroll
  for (int jj = 0; jj < R / 4; ++jj)
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int col = col0 + 8 * jj;
      const uint32_t off = (col / L::kBC) * L::kBlock + (r0 + 8 * hh) * L::kRB +
                           ((col % L::kBC) / 8) * 16 + tq4 * 4;
      st_shared(dst + (off ^ (((off >> 7) & L::kSwzMask) << 4)),
                pack_bf16(acc[4 * jj + 2 * hh], acc[4 * jj + 2 * hh + 1]));
    }
}

// The scaled, soft-capped score in the log2 domain and its derivative's
// factor: x2 = x log2(e) for x = scale s (or c tanh(scale s / c)), dcap =
// 1 - tanh^2 (1 without a cap).
struct ScoreMap {
  float mul, cap2;
  bool capped;
  __device__ explicit ScoreMap(const Mask& mk)
      : mul(mk.softcap > 0.f ? mk.scale / mk.softcap : mk.scale * kLog2e),
        cap2(mk.softcap * kLog2e), capped(mk.softcap > 0.f) {}
  __device__ __forceinline__ float operator()(float s, float& dcap) const {
    if (!capped) return s * mul;
    const float t = tanhf(s * mul);
    dcap = 1.f - t * t;
    return cap2 * t;
  }
};

// Shared memory of a dk/dv CTA, from a 1024-aligned base: K and V, then
// kStages (q, dO) stages, the exchange (64 x 64 float32), kStages (lse,
// D_i) rows of 64 floats each, then the mbarriers (K/V full; per stage
// full and empty).
template <int D>
struct DkdvLayout {
  using T = WgTile<D, 64>;
  static constexpr int kStages = D >= 256 ? 2 : 3;
  static constexpr uint32_t kV = T::kBytes;
  static constexpr uint32_t kRing = 2 * T::kBytes;
  static constexpr uint32_t kX = kRing + 2 * kStages * T::kBytes;
  static constexpr uint32_t kRows = kX + 64 * 64 * 4;
  static constexpr uint32_t kBar = kRows + kStages * 512;
  static constexpr size_t kSmemBytes = 1024 + kBar + 8 * (1 + 2 * kStages);
};

// Shared memory of a dq CTA: q and dO, then kStages (K, V) stages, the two
// exchanges, then the mbarriers (q full; per stage full and empty).  dq's
// column halves are whole column blocks (D 64: 32 columns, a 64-byte swizzle).
template <int D>
struct DqLayout {
  using T = WgTile<D, (D / 2 < 64 ? D / 2 : 64)>;
  static constexpr int kStages = D >= 256 ? 2 : 3;
  static constexpr uint32_t kdO = T::kBytes;
  static constexpr uint32_t kRing = 2 * T::kBytes;
  static constexpr uint32_t kX = kRing + 2 * kStages * T::kBytes;
  static constexpr uint32_t kBar = kX + 2 * 64 * 64 * 4;
  static constexpr size_t kSmemBytes = 1024 + kBar + 8 * (1 + 2 * kStages);
};

// One cluster of kParts CTAs: 64 keys of one (batch, kv head).  See the
// header note.
template <int D>
__global__ void __cluster_dims__(kParts, 1, 1) __launch_bounds__(kWThreads, 1)
flash_bwd_dkdv_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                            const __grid_constant__ CUtensorMap tk,
                            const __grid_constant__ CUtensorMap tv,
                            const __grid_constant__ CUtensorMap tdo,
                            const __grid_constant__ CUtensorMap tdk,
                            const __grid_constant__ CUtensorMap tdv,
                            const float* __restrict__ lse,
                            const float* __restrict__ delta, int hq, int hkv,
                            Mask mk) {
  using L = DkdvLayout<D>;
  using T = typename L::T;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  unsigned char* gbase = smem_raw + (base - smem_u32(smem_raw));
  const uint32_t sK = base, sV = base + L::kV;
  auto sQ = [&](int s) { return base + L::kRing + 2 * s * T::kBytes; };
  auto sdO = [&](int s) { return sQ(s) + T::kBytes; };
  // the exchange: f of fragment elements 4 e4 .. 4 e4 + 3 of thread t at
  // xchg[128 e4 + t]
  float4* xchg = reinterpret_cast<float4*>(gbase + L::kX);
  const uint32_t kv_full = base + L::kBar, full = kv_full + 8;
  const uint32_t empty = full + 8 * L::kStages;

  const int part = blockIdx.x;  // the CTA's rank in its cluster
  const int bk = blockIdx.y;    // batch * hkv + kv head
  const int bi = bk / hkv, kvh = bk % hkv, group = hq / hkv;
  const int k0 = blockIdx.z * 64;  // low key tiles (the heaviest) first
  const int sq = mk.sq, skv = mk.skv, shift = skv - sq;
  // The q rows that some key of this tile is live for, as 64-row tiles
  // [t_lo, t_lo + tiles); the CTA walks them for each q head of the group.
  const int kmax = min(k0 + 64, skv) - 1;
  const int i_lo = mk.causal ? max(0, k0 - shift) : 0;
  const int i_hi = mk.window > 0 ? min(sq, kmax + mk.window - shift) : sq;
  const int t_lo = i_lo / 64;
  const int tiles = i_hi > i_lo ? (i_hi + 63) / 64 - t_lo : 0;
  // This CTA's share of the walk: items part, part + kParts, ...
  const int n = group * tiles;
  const int m = n > part ? (n - part + kParts - 1) / kParts : 0;

  if (threadIdx.x == 0) {
    mbar_init(kv_full, 1);
    for (int s = 0; s < L::kStages; ++s) {
      mbar_init(full + 8 * s, 1 + 32);    // the TMA's bytes, the rows' lanes
      mbar_init(empty + 8 * s, 2 * 128);  // every consumer thread
    }
    fence_barrier_init();
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 0) {
    // ---- producer: one thread issues every copy; its warp stages each q
    // tile's lse and D_i (64 rows of 4 bytes: below TMA's box for a
    // short Sq) and arrives on the stage's full barrier after its stores.
    setmaxnreg_dec<40>();
    if (threadIdx.x < 32) {
      const int lane = threadIdx.x;
      if (lane == 0) {
        mbar_expect_tx(kv_full, 2 * T::kBytes);
        for (int c = 0; c < T::kCB; ++c) {
          tma_load(sK + c * T::kBlock, &tk, kv_full, c * T::kBC, k0, kvh, bi);
          tma_load(sV + c * T::kBlock, &tv, kv_full, c * T::kBC, k0, kvh, bi);
        }
      }
      for (int j = 0; j < m; ++j) {
        const int s = j % L::kStages, i = part + kParts * j;
        const int h = kvh * group + i / tiles, q0 = (t_lo + i % tiles) * 64;
        // rows past Sq take 0: their pairs are masked
        const size_t row = ((size_t)bi * hq + h) * sq + q0;
        float lv[2], dlv[2];
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const bool in = q0 + lane + 32 * hh < sq;
          lv[hh] = in ? lse[row + lane + 32 * hh] : 0.f;
          dlv[hh] = in ? delta[row + lane + 32 * hh] : 0.f;
        }
        // Round j / kStages of this stage; round 0 finds it empty.
        mbar_wait(empty + 8 * s, ((j / L::kStages) & 1) ^ 1);
        if (lane == 0) {
          mbar_expect_tx(full + 8 * s, 2 * T::kBytes);
          for (int c = 0; c < T::kCB; ++c) {
            tma_load(sQ(s) + c * T::kBlock, &tq, full + 8 * s, c * T::kBC,
                     q0, h, bi);
            tma_load(sdO(s) + c * T::kBlock, &tdo, full + 8 * s, c * T::kBC,
                     q0, h, bi);
          }
        }
        float* rows = reinterpret_cast<float*>(gbase + L::kRows + 512 * s);
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          rows[lane + 32 * hh] = lv[hh];
          rows[64 + lane + 32 * hh] = dlv[hh];
        }
        mbar_arrive(full + 8 * s);
      }
    }
  } else {
    // ---- consumers: warpgroup 1 the scores, p and dv; 2 dP, dS and dk.
    setmaxnreg_inc<232>();
    const int w = wg - 1;
    const int tid = threadIdx.x - 128 * wg;
    const int warp = tid / 32, lane = tid % 32;
    const int g = lane / 4, tq4 = lane % 4;
    const int r0 = 16 * warp + g;  // this thread's keys k0 + r0, + 8
    const ScoreMap score(mk);
    float acc[D / 2];  // dv (warpgroup 1) or dk (2): keys x D
#pragma unroll
    for (int e = 0; e < D / 2; ++e) acc[e] = 0.f;
    float x[32];  // S^T, then p^T (1); dP^T, then dS^T (2): keys x q rows
    uint32_t pa[4][4];

    mbar_wait(kv_full, 0);
    int tile = part;  // item part + kParts j is q tile t_lo + tile of a head
    for (int j = 0; j < m; ++j, tile += kParts) {
      while (tile >= tiles) tile -= tiles;
      const int s = j % L::kStages;
      const int q0 = (t_lo + tile) * 64;
      const float* rows =
          reinterpret_cast<const float*>(gbase + L::kRows + 512 * s);
      mbar_wait(full + 8 * s, (j / L::kStages) & 1);
      // lse (warpgroup 1, log2 domain) or D_i (2) of this thread's 16 q
      // rows, into registers before the product
      float rv[16];
#pragma unroll
      for (int c = 0; c < 8; ++c) {
        const float2 v = *reinterpret_cast<const float2*>(
            rows + 64 * w + 8 * c + 2 * tq4);
        rv[2 * c] = w == 0 ? v.x * kLog2e : v.x;
        rv[2 * c + 1] = w == 0 ? v.y * kLog2e : v.y;
      }
      tile_product<T, D>(x, w == 0 ? sK : sV, w == 0 ? sQ(s) : sdO(s));
      if (w == 0) {
        // p^T, and f = p^T dcap scale into the exchange; the masks only on
        // a tile that is not wholly live
        auto form_p = [&](auto masked) {
#pragma unroll
          for (int e4 = 0; e4 < 8; ++e4) {
            float f[4];
#pragma unroll
            for (int c = 0; c < 4; ++c) {
              const int e = 4 * e4 + c;
              float dcap = 1.f;
              const float x2 = score(x[e], dcap);
              float p = fast_exp2(x2 - rv[2 * e4 + (c & 1)]);
              if constexpr (decltype(masked)::value)
                p = mk.live(q0 + 8 * e4 + 2 * tq4 + (c & 1),
                            k0 + r0 + 8 * (c >> 1)) ? p : 0.f;
              f[c] = p * dcap * mk.scale;
              x[e] = p;
            }
            xchg[e4 * 128 + tid] = make_float4(f[0], f[1], f[2], f[3]);
          }
        };
        if (j > 0) named_sync(kXEmpty, 256);  // dS^T of j - 1 is formed
        if (tile_full(mk, q0, k0))
          form_p(std::false_type{});
        else
          form_p(std::true_type{});
        named_arrive(kXFull, 256);
      } else {
        named_sync(kXFull, 256);
#pragma unroll
        for (int e4 = 0; e4 < 8; ++e4) {
          const float4 f = xchg[e4 * 128 + tid];
          x[4 * e4] = f.x * (x[4 * e4] - rv[2 * e4]);
          x[4 * e4 + 1] = f.y * (x[4 * e4 + 1] - rv[2 * e4 + 1]);
          x[4 * e4 + 2] = f.z * (x[4 * e4 + 2] - rv[2 * e4]);
          x[4 * e4 + 3] = f.w * (x[4 * e4 + 3] - rv[2 * e4 + 1]);
        }
        if (j + 1 < m) named_arrive(kXEmpty, 256);
      }
      pack_a(x, pa);
      // dv += p^T dO (warpgroup 1), dk += dS^T q (2)
      accumulate<T>(acc, pa, w == 0 ? sdO(s) : sQ(s));
      mbar_arrive(empty + 8 * s);
    }

    // Epilogue: every product of the CTA is done, so its ring is free.  A
    // CTA of rank > 0 leaves its float32 sums there (fragment order, 16
    // bytes a thread a step); rank 0 adds them in rank order through
    // distributed shared memory, then writes dk into K's tile and dv into
    // V's as bfloat16 and stores them by TMA (clipped at Skv).
    named_sync(kJoint, 256);
    const uint32_t red = base + L::kRing + w * (D / 8) * 128 * 16;
    if (part != 0) {
      float4* mine = reinterpret_cast<float4*>(gbase + (red - base));
#pragma unroll
      for (int e = 0; e < D / 8; ++e)
        mine[e * 128 + tid] = make_float4(acc[4 * e], acc[4 * e + 1],
                                          acc[4 * e + 2], acc[4 * e + 3]);
    }
    cluster_sync();  // the sums are written
    if (part == 0) {
      for (int r = 1; r < kParts; ++r)
#pragma unroll
        for (int e = 0; e < D / 8; ++e) {
          const float4 v = ld_cluster_f4(red + (e * 128 + tid) * 16, r);
          acc[4 * e] += v.x;
          acc[4 * e + 1] += v.y;
          acc[4 * e + 2] += v.z;
          acc[4 * e + 3] += v.w;
        }
    }
    cluster_sync();  // read: a CTA of rank > 0 may exit
    if (part == 0) {
      const uint32_t out = w == 0 ? sV : sK;
      store_tile<T>(out, acc, 0, r0, tq4);
      fence_proxy_async();  // the stores above, before TMA reads them
      named_sync(kJoint, 256);
      if (tid == 0) {
        for (int c = 0; c < T::kCB; ++c)
          tma_store(w == 0 ? &tdv : &tdk, out + c * T::kBlock, c * T::kBC,
                    k0, kvh, bi);
        tma_store_wait();
      }
    }
    return;
  }
  // the producer warpgroup's part of the cluster's two barriers
  cluster_sync();
  cluster_sync();
}

// One CTA: 64 q rows of one (batch, q head).  See the header note.
template <int D>
__global__ void __launch_bounds__(kWThreads, 1)
flash_bwd_dq_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                          const __grid_constant__ CUtensorMap tk,
                          const __grid_constant__ CUtensorMap tv,
                          const __grid_constant__ CUtensorMap tdo,
                          const __grid_constant__ CUtensorMap tdq,
                          const float* __restrict__ lse,
                          const float* __restrict__ delta, int hq, int hkv,
                          Mask mk) {
  using L = DqLayout<D>;
  using T = typename L::T;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  unsigned char* gbase = smem_raw + (base - smem_u32(smem_raw));
  const uint32_t sQ = base, sdO = base + L::kdO;
  auto sK = [&](int s) { return base + L::kRing + 2 * s * T::kBytes; };
  auto sV = [&](int s) { return sK(s) + T::kBytes; };
  // two exchanges (f; dP), each as the dk/dv kernel's
  float4* xchg = reinterpret_cast<float4*>(gbase + L::kX);
  const uint32_t q_full = base + L::kBar, full = q_full + 8;
  const uint32_t empty = full + 8 * L::kStages;

  const int bh = blockIdx.x;  // batch * hq + q head
  const int bi = bh / hq, h = bh % hq, kvh = h / (hq / hkv);
  // The latest q tiles (the heaviest) of every head first.
  const int q0 = (gridDim.y - 1 - blockIdx.y) * 64;
  const int sq = mk.sq, skv = mk.skv;
  // The live kv tiles of this q tile (the forward's bounds).
  const int qpos0 = skv - sq + q0;
  const int qlast = skv - sq + min(q0 + 64, sq) - 1;
  const int kv_hi = mk.causal ? min(skv, qlast + 1) : skv;
  const int kv_lo = mk.window > 0 ? max(0, qpos0 - mk.window + 1) : 0;
  const int t_lo = kv_lo / 64;
  const int n = kv_hi > kv_lo ? (kv_hi + 63) / 64 - t_lo : 0;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < L::kStages; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, 2 * 128);
    }
    fence_barrier_init();
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 0) {
    setmaxnreg_dec<40>();
    if (threadIdx.x == 0) {
      mbar_expect_tx(q_full, 2 * T::kBytes);
      for (int c = 0; c < T::kCB; ++c) {
        tma_load(sQ + c * T::kBlock, &tq, q_full, c * T::kBC, q0, h, bi);
        tma_load(sdO + c * T::kBlock, &tdo, q_full, c * T::kBC, q0, h, bi);
      }
      for (int i = 0; i < n; ++i) {
        const int s = i % L::kStages, k0 = (t_lo + i) * 64;
        mbar_wait(empty + 8 * s, ((i / L::kStages) & 1) ^ 1);
        mbar_expect_tx(full + 8 * s, 2 * T::kBytes);
        for (int c = 0; c < T::kCB; ++c) {
          tma_load(sK(s) + c * T::kBlock, &tk, full + 8 * s, c * T::kBC, k0,
                   kvh, bi);
          tma_load(sV(s) + c * T::kBlock, &tv, full + 8 * s, c * T::kBC, k0,
                   kvh, bi);
        }
      }
    }
  } else {
    // ---- consumers: warpgroup 1 the scores and p, 2 dP; both dS and
    // their half of dq's columns.
    setmaxnreg_inc<232>();
    const int w = wg - 1;
    const int tid = threadIdx.x - 128 * wg;
    const int warp = tid / 32, lane = tid % 32;
    const int g = lane / 4, tq4 = lane % 4;
    const int r0 = 16 * warp + g;  // this thread's rows q0 + r0, + 8
    const ScoreMap score(mk);
    float acc[D / 4];  // dq's columns [w D / 2, (w + 1) D / 2)
#pragma unroll
    for (int e = 0; e < D / 4; ++e) acc[e] = 0.f;
    float x[32];  // S, then p (1); dP (2); then dS: q rows x keys
    uint32_t pa[4][4];
    float4* mine = xchg + w * 16 * 64;
    const float4* theirs = xchg + (1 - w) * 16 * 64;

    // this thread's rows' lse (log2 domain) and D_i; rows past Sq take 0
    float lse2[2], dd[2];
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int row = q0 + r0 + 8 * hh;
      lse2[hh] = row < sq ? lse[(size_t)bh * sq + row] * kLog2e : 0.f;
      dd[hh] = row < sq ? delta[(size_t)bh * sq + row] : 0.f;
    }
    mbar_wait(q_full, 0);
    for (int i = 0; i < n; ++i) {
      const int s = i % L::kStages, k0 = (t_lo + i) * 64;
      mbar_wait(full + 8 * s, (i / L::kStages) & 1);
      tile_product<T, D>(x, w == 0 ? sQ : sdO, w == 0 ? sK(s) : sV(s));
      if (w == 0) {
        // f = p dcap scale; the masks only on a tile not wholly live
        auto form_f = [&](auto masked) {
#pragma unroll
          for (int e = 0; e < 32; ++e) {
            const int hh = (e >> 1) & 1;
            float dcap = 1.f;
            const float x2 = score(x[e], dcap);
            float p = fast_exp2(x2 - lse2[hh]);
            if constexpr (decltype(masked)::value)
              p = mk.live(q0 + r0 + 8 * hh,
                          k0 + 8 * (e >> 2) + 2 * tq4 + (e & 1)) ? p : 0.f;
            x[e] = p * dcap * mk.scale;
          }
        };
        if (tile_full(mk, q0, k0))
          form_f(std::false_type{});
        else
          form_f(std::true_type{});
      }
#pragma unroll
      for (int e4 = 0; e4 < 8; ++e4)
        mine[e4 * 128 + tid] = make_float4(x[4 * e4], x[4 * e4 + 1],
                                           x[4 * e4 + 2], x[4 * e4 + 3]);
      named_sync(kXFull, 256);
      // The same dS = f (dP - D_i) in both warpgroups, bit for bit.
#pragma unroll
      for (int e4 = 0; e4 < 8; ++e4) {
        const float4 v = theirs[e4 * 128 + tid];
        const float other[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int e = 4 * e4 + c;
          const float f = w == 0 ? x[e] : other[c];
          const float dp = w == 0 ? other[c] : x[e];
          x[e] = f * (dp - dd[c >> 1]);
        }
      }
      named_sync(kXEmpty, 256);  // both exchanges read
      pack_a(x, pa);
      // dq[:, half w] += dS K[:, half w]
      accumulate<T>(acc, pa, sK(s) + w * (T::kCB / 2) * T::kBlock);
      mbar_arrive(empty + 8 * s);
    }

    // Epilogue: q is free once both warpgroups are done; dq's halves into
    // its tile as bfloat16, then TMA stores (clipped at Sq).
    named_sync(kJoint, 256);
    store_tile<T>(sQ, acc, w * (D / 2), r0, tq4);
    fence_proxy_async();
    named_sync(kJoint, 256);
    if (w == 0 && tid == 0) {
      for (int c = 0; c < T::kCB; ++c)
        tma_store(&tdq, sQ + c * T::kBlock, c * T::kBC, q0, h, bi);
      tma_store_wait();
    }
  }
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

// The tensor maps of the bfloat16 kernels over contiguous [B, H, S, D]
// tensors: 64-row boxes of a tile's column block.
template <class L, int D>
bool head_map(CUtensorMap* map, const void* base, int rows, int heads,
              int batch) {
  const long long st[3] = {(long long)heads * rows * D * 2,
                           (long long)rows * D * 2, (long long)D * 2};
  return encode_bf16_map(map, base, D, rows, heads, batch, st, L::kBC, 64);
}

// Which kernels a (dtype, D) takes: the bfloat16 wgmma kernels at D 64,
// 128 and 256; the CUDA-core kernels for float32 and for bfloat16 at D 16
// and 32.
template <typename T, int D>
constexpr bool kWgmma = std::is_same<T, __nv_bfloat16>::value && D >= 64;

template <typename T, int D>
int launch_dkdv(const void* q, const void* k, const void* v, const void* dout,
                const void* lse, const void* delta, void* dk, void* dv, int b,
                int hq, int hkv, const Mask& mk, cudaStream_t stream) {
  if constexpr (kWgmma<T, D>) {
    using L = DkdvLayout<D>;
    using W = typename L::T;
    const size_t smem = L::kSmemBytes;
    static unsigned long long attr = 0;  // a bit a card
    const cudaError_t err =
        allow_smem(flash_bwd_dkdv_wgmma_kernel<D>, smem, attr);
    if (err != cudaSuccess) return (int)err;
    CUtensorMap mq, mkk, mv, mdo, mdk, mdv;
    if (!head_map<W, D>(&mq, q, mk.sq, hq, b) ||
        !head_map<W, D>(&mdo, dout, mk.sq, hq, b) ||
        !head_map<W, D>(&mkk, k, mk.skv, hkv, b) ||
        !head_map<W, D>(&mv, v, mk.skv, hkv, b) ||
        !head_map<W, D>(&mdk, dk, mk.skv, hkv, b) ||
        !head_map<W, D>(&mdv, dv, mk.skv, hkv, b))
      return (int)cudaErrorInvalidValue;
    const dim3 grid(kParts, b * hkv, (mk.skv + 63) / 64);
    flash_bwd_dkdv_wgmma_kernel<D><<<grid, kWThreads, smem, stream>>>(
        mq, mkk, mv, mdo, mdk, mdv, (const float*)lse, (const float*)delta,
        hq, hkv, mk);
  } else {
    using L = BwdTiles<D>;
    const size_t smem = L::kSmemFloats * sizeof(float);
    static unsigned long long attr = 0;  // a bit a card
    const cudaError_t err =
        allow_smem(flash_bwd_dkdv_kernel<T, D>, smem, attr);
    if (err != cudaSuccess) return (int)err;
    const dim3 grid((mk.skv + L::kBK - 1) / L::kBK, b * hkv);
    flash_bwd_dkdv_kernel<T, D><<<grid, kThreads, smem, stream>>>(
        (const T*)q, (const T*)k, (const T*)v, (const T*)dout,
        (const float*)lse, (const float*)delta, (T*)dk, (T*)dv, hq, hkv, mk);
  }
  return (int)cudaGetLastError();
}

template <typename T, int D>
int launch_dq(const void* q, const void* k, const void* v, const void* dout,
              const void* lse, const void* delta, void* dq, int b, int hq,
              int hkv, const Mask& mk, cudaStream_t stream) {
  if constexpr (kWgmma<T, D>) {
    using L = DqLayout<D>;
    using W = typename L::T;
    const size_t smem = L::kSmemBytes;
    static unsigned long long attr = 0;  // a bit a card
    const cudaError_t err =
        allow_smem(flash_bwd_dq_wgmma_kernel<D>, smem, attr);
    if (err != cudaSuccess) return (int)err;
    CUtensorMap mq, mkk, mv, mdo, mdq;
    if (!head_map<W, D>(&mq, q, mk.sq, hq, b) ||
        !head_map<W, D>(&mdo, dout, mk.sq, hq, b) ||
        !head_map<W, D>(&mdq, dq, mk.sq, hq, b) ||
        !head_map<W, D>(&mkk, k, mk.skv, hkv, b) ||
        !head_map<W, D>(&mv, v, mk.skv, hkv, b))
      return (int)cudaErrorInvalidValue;
    const dim3 grid(b * hq, (mk.sq + 63) / 64);
    flash_bwd_dq_wgmma_kernel<D><<<grid, kWThreads, smem, stream>>>(
        mq, mkk, mv, mdo, mdq, (const float*)lse, (const float*)delta, hq,
        hkv, mk);
  } else {
    using L = BwdTiles<D>;
    const size_t smem = L::kSmemFloats * sizeof(float);
    static unsigned long long attr = 0;  // a bit a card
    const cudaError_t err = allow_smem(flash_bwd_dq_kernel<T, D>, smem, attr);
    if (err != cudaSuccess) return (int)err;
    const dim3 grid((mk.sq + L::kBQ - 1) / L::kBQ, b * hq);
    flash_bwd_dq_kernel<T, D><<<grid, kThreads, smem, stream>>>(
        (const T*)q, (const T*)k, (const T*)v, (const T*)dout,
        (const float*)lse, (const float*)delta, (T*)dq, hq, hkv, mk);
  }
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

// Dynamic shared memory of one CTA of the bfloat16 dk/dv (which 0) or dq
// (which 1) kernel at head dim d; -1 where d takes the CUDA-core kernels.
extern "C" int lm_flash_bwd_wgmma_smem_bytes(int which, int d) {
  switch (d) {
#define SMEM_CASE(D) \
  case D:            \
    return (int)(which == 0 ? DkdvLayout<D>::kSmemBytes    \
                            : DqLayout<D>::kSmemBytes);
    SMEM_CASE(64)
    SMEM_CASE(128)
    SMEM_CASE(256)
#undef SMEM_CASE
    default:
      return -1;
  }
}
