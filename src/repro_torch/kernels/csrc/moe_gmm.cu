// Grouped matmul for Hopper (sm_90a): the expert contraction of a
// Mixture-of-Experts layer,
//   out[e] = x[e] @ w[e]      x [E, C, K], w [E, K, N] -> out [E, C, N]
// with x and w both bf16 or both fp32, products and sums in fp32 and out
// in x's type.
//
// Replaces the Pallas TPU kernel grouped_matmul_tpu
// (repro/kernels/moe_gmm.py:38).  The port calls it three times per MoE
// layer call (models/moe.py moe_apply: the gate and up projections of the
// dispatched tokens [E, C, d] and the down projection of act(g) * u),
// with C the capacity of each expert: 8 rows at a decode tick, 16 for a
// speculative verify pass, 24 for a 64-token chunk and 88-320 for a
// monolithic prefill.
//
// What bounds it on an H100: bytes, at every serving shape.  Each weight
// element is read once per call and used for 2*C flops; in bf16 that is C
// flops per byte, under the ~295 flops per byte at which the tensor cores
// would take over, for any C the serving path makes (granite-moe's decode
// tick: 33.5 MB of one projection's weights for 0.27 GFLOP; at C 320 the
// 10.7 GFLOP are 0.011 ms at the bf16 peak, near the 0.019 ms of bytes).
//
// Which instantiation runs is chosen by (dtype, C) in grouped_matmul_launch
// (grouped_matmul_variant names it):
//   * bf16, C <= 16 (a decode tick, a verify pass): the small-C tile.  It
//     computes out[e]^T = w[e]^T x[e]^T, so that 16 columns of N fill the
//     mma's 16 rows and the tokens its 8 columns (one block of 8 at C <= 8,
//     two at C <= 16), instead of padding C to 16 or 32 rows.  A CTA of 4
//     warps owns 64 columns of N (16 a warp) and walks all of K in 64-deep
//     steps through a 4-stage cp.async ring (32 KB of weights in flight a
//     CTA, 2 or more CTAs an SM at the serving shapes);
//   * bf16, 16 < C <= 64 (a chunk): [32 c x 64 n] tiles, 4 warps side by
//     side in N, 64-deep steps through a 4-stage ring;
//   * bf16, C > 64 (a monolithic prefill): [64 c x 128 n] tiles, 2 x 2
//     warps of [32 x 64], 32-deep steps through a 3-stage ring; it
//     compiles to 96 registers a thread, so 5 CTAs share an SM (no
//     minimum of CTAs an SM is declared: with one, ptxas takes more
//     registers and fewer CTAs fit); the CTAs of one weight tile (the c
//     tiles) are adjacent in the grid, so all but the first read it from
//     L2;
//   * fp32, any C: the CUDA-core kernel below, fp32 FMAs (never TF32),
//     [32 x 64] tiles in shared memory, 4 x 4 outputs a thread.
// The bf16 tiles multiply on the tensor cores: mma.sync m16n8k16 with bf16
// operands from ldmatrix (.trans where the operand lies the other way in
// shared memory) and fp32 accumulators.  bf16 x bf16 products are exact
// in fp32, so the result differs from the plain version's fp32 einsum
// only in summation order (16-deep blocks inside the mma, then the K steps
// in ascending order), and is rounded once to bf16.  Shared rows are
// padded by 16 bytes, so each ldmatrix phase hits 8 distinct bank groups.
// Operands are read in place (a layer's view of the stacked [L, E, K, N]
// weights), with no padded copy: rows whose starts are 16-byte aligned
// (K, N multiples of 8) move as 16-byte cp.async copies whose source size
// zero-fills the ragged edge of C, K and N; other rows (the test sweep's K
// 70, N 90) take a scalar staging path inside the same kernel.  Where the
// grid has fewer CTAs than the card has SMs, K is split across CTAs: each
// writes an fp32 partial and a second pass sums the partials in split
// order and rounds once (deterministic, no atomics).
// Later work: wgmma with TMA and a persistent schedule over the experts'
// tiles for the monolithic shapes.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "tc_bf16.cuh"

namespace {

// ------------------------------------------------ fp32: CUDA-core kernel

constexpr int kThreads = 128;
constexpr int kTileC = 32;  // rows of x (tokens of one expert) per CTA
constexpr int kTileN = 64;  // output columns per CTA
constexpr int kTileK = 32;  // depth staged per step
constexpr int kRun = 8;     // consecutive elements one thread loads
constexpr int kWRuns = kTileK * kTileN / kRun / kThreads;  // 2 per thread
static_assert(kTileC * kTileK / kRun == kThreads, "one x run per thread");

template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) { return x; }

// kRun consecutive elements from src, of which the first n lie inside the
// tensor (zeros past them), widened to fp32; with vec, a whole run is one
// or two 16-byte loads.
template <typename T>
__device__ __forceinline__ void load_run(const T* src, int n, bool vec,
                                         float* dst);

template <>
__device__ __forceinline__ void load_run<float>(const float* src, int n,
                                                bool vec, float* dst) {
  if (vec && n >= kRun) {
    const float4 a = *reinterpret_cast<const float4*>(src);
    const float4 b = *reinterpret_cast<const float4*>(src + 4);
    dst[0] = a.x; dst[1] = a.y; dst[2] = a.z; dst[3] = a.w;
    dst[4] = b.x; dst[5] = b.y; dst[6] = b.z; dst[7] = b.w;
    return;
  }
#pragma unroll
  for (int i = 0; i < kRun; ++i) dst[i] = i < n ? src[i] : 0.f;
}

template <typename T>
__global__ void __launch_bounds__(kThreads) grouped_matmul_kernel(
    const T* __restrict__ x, const T* __restrict__ w, T* __restrict__ out,
    int C, int K, int N, int vec_x, int vec_w) {
  // x tile transposed (xs[k][c]) so a thread reads its 4 rows as one
  // float4; w tile as it lies (ws[k][n])
  __shared__ __align__(16) float xs[kTileK][kTileC];
  __shared__ __align__(16) float ws[kTileK][kTileN];
  const int n0 = blockIdx.x * kTileN;
  const int c0 = blockIdx.y * kTileC;
  const int e = blockIdx.z;
  const int tid = threadIdx.x;
  const int tc = tid / 16;  // rows c0 + 4*tc .. c0 + 4*tc + 3
  const int tn = tid % 16;  // columns n0 + 4*tn .. n0 + 4*tn + 3
  const T* xe = x + static_cast<size_t>(e) * C * K;
  const T* we = w + static_cast<size_t>(e) * K * N;

  // this thread's x run: row xc, depth xk .. xk + 7 of the tile
  const int xc = tid / (kTileK / kRun);
  const int xk = (tid % (kTileK / kRun)) * kRun;
  float xr[kRun], wr[kWRuns][kRun];

  auto load = [&](int k0) {
    const int c = c0 + xc, k = k0 + xk;
    const int nx = (c < C) ? K - k : 0;
    load_run<T>(xe + static_cast<size_t>(c < C ? c : 0) * K + k, nx,
                vec_x != 0, xr);
#pragma unroll
    for (int j = 0; j < kWRuns; ++j) {
      const int i = tid + j * kThreads;
      const int kk = k0 + i / (kTileN / kRun);
      const int nn = n0 + (i % (kTileN / kRun)) * kRun;
      const int nw = (kk < K) ? N - nn : 0;
      load_run<T>(we + static_cast<size_t>(kk < K ? kk : 0) * N + nn, nw,
                  vec_w != 0, wr[j]);
    }
  };

  float acc[4][4];
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[r][c] = 0.f;
  // a warp holds row groups 2*warp and 2*warp + 1: rows 8*warp .. +7
  const bool active = c0 + 4 * tc < C;

  load(0);
  for (int k0 = 0; k0 < K; k0 += kTileK) {
#pragma unroll
    for (int i = 0; i < kRun; ++i) xs[xk + i][xc] = xr[i];
#pragma unroll
    for (int j = 0; j < kWRuns; ++j) {
      const int i = tid + j * kThreads;
      float* dst = &ws[i / (kTileN / kRun)][(i % (kTileN / kRun)) * kRun];
      *reinterpret_cast<float4*>(dst) =
          make_float4(wr[j][0], wr[j][1], wr[j][2], wr[j][3]);
      *reinterpret_cast<float4*>(dst + 4) =
          make_float4(wr[j][4], wr[j][5], wr[j][6], wr[j][7]);
    }
    __syncthreads();
    if (k0 + kTileK < K) load(k0 + kTileK);  // in flight during the FMAs
    if (active) {
#pragma unroll 8
      for (int k = 0; k < kTileK; ++k) {
        const float4 a = *reinterpret_cast<const float4*>(&xs[k][4 * tc]);
        const float4 b = *reinterpret_cast<const float4*>(&ws[k][4 * tn]);
        const float av[4] = {a.x, a.y, a.z, a.w};
        const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int c = 0; c < 4; ++c) acc[r][c] = fmaf(av[r], bv[c], acc[r][c]);
      }
    }
    __syncthreads();  // the tiles are overwritten by the next step
  }

  T* oe = out + static_cast<size_t>(e) * C * N;
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int c = c0 + 4 * tc + r;
    if (c >= C) break;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + 4 * tn + j;
      if (n < N) oe[static_cast<size_t>(c) * N + n] = from_float<T>(acc[r][j]);
    }
  }
}

template <typename T>
int launch(const void* x, const void* w, void* out, int E, int C, int K,
           int N, int vec_x, int vec_w, cudaStream_t stream) {
  const dim3 grid((N + kTileN - 1) / kTileN, (C + kTileC - 1) / kTileC, E);
  grouped_matmul_kernel<T><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w), static_cast<T*>(out),
      C, K, N, vec_x, vec_w);
  return static_cast<int>(cudaGetLastError());
}


// ------------------------------------------- bf16: tensor-core kernels

using tc::bf16;
constexpr int kPad = 8;  // bf16 elements of padding per shared row

// Stages rows [r0, r0 + ROWS) x cols [c0, c0 + COLS) of the row-major
// [nrows, ncols] operand g into s (row stride COLS + kPad), zeros outside
// the operand.  vec: 16-byte cp.async copies (ncols a multiple of 8, g
// 16-byte aligned), the edge zero-filled through the source size; else
// scalar loads and shared stores.
template <int ROWS, int COLS>
__device__ __forceinline__ void stage(bf16* s, const bf16* __restrict__ g,
                                      int nrows, int ncols, int r0, int c0,
                                      bool vec) {
  constexpr int kRuns = COLS / 8;
  for (int i = threadIdx.x; i < ROWS * kRuns; i += kThreads) {
    const int r = i / kRuns, c = (i % kRuns) * 8;
    const int gr = r0 + r, gc = c0 + c;
    bf16* dst = s + r * (COLS + kPad) + c;
    if (vec) {
      const bool in = gr < nrows && gc < ncols;
      tc::cp_async16(dst, in ? g + static_cast<size_t>(gr) * ncols + gc : g,
                     in ? 16 : 0);
    } else {
#pragma unroll
      for (int e = 0; e < 8; ++e)
        dst[e] = (gr < nrows && gc + e < ncols)
                     ? g[static_cast<size_t>(gr) * ncols + gc + e]
                     : __float2bfloat16(0.f);
    }
  }
}

// One output element: bf16 into out, or with a split of K the fp32
// partial of split sp into work [splits, E, C, N].
struct Epilogue {
  bf16* out;
  float* work;
  int splits;
  size_t total;  // E * C * N
  __device__ __forceinline__ void put(int sp, size_t i, float v) const {
    if (splits > 1)
      work[sp * total + i] = v;
    else
      out[i] = __float2bfloat16(v);
  }
};

// The small-C tile: out[e]^T [n, c] = w[e]^T x[e]^T for C <= 8 * NB8.
// Grid (N / 64, 1, E * splits); warp w owns columns n0 + 16w .. + 15.
template <int NB8>
__global__ void __launch_bounds__(kThreads) gmm_small_c(
    const bf16* __restrict__ x, const bf16* __restrict__ w, Epilogue ep,
    int C, int K, int N, int vec_x, int vec_w, int kt_per) {
  constexpr int TC = 8 * NB8, BN = 64, BK = 64, STAGES = 4;
  __shared__ __align__(16) bf16 xs[STAGES][TC][BK + kPad];
  __shared__ __align__(16) bf16 ws[STAGES][BK][BN + kPad];
  const int n0 = blockIdx.x * BN;
  const int e = blockIdx.z / ep.splits, sp = blockIdx.z % ep.splits;
  const int kt0 = sp * kt_per;
  const int nt = min((K + BK - 1) / BK - kt0, kt_per);
  const bf16* xe = x + static_cast<size_t>(e) * C * K;
  const bf16* we = w + static_cast<size_t>(e) * K * N;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  auto load = [&](int t) {
    const int st = t % STAGES, k0 = (kt0 + t) * BK;
    stage<TC, BK>(&xs[st][0][0], xe, C, K, 0, k0, vec_x != 0);
    stage<BK, BN>(&ws[st][0][0], we, K, N, k0, n0, vec_w != 0);
  };

  float acc[NB8][4] = {};
#pragma unroll
  for (int t = 0; t < STAGES - 1; ++t) {
    if (t < nt) load(t);
    tc::cp_async_commit();
  }
  for (int t = 0; t < nt; ++t) {
    tc::cp_async_wait<STAGES - 2>();
    __syncthreads();  // stage t landed; stage t - 1 is free again
    if (t + STAGES - 1 < nt) load(t + STAGES - 1);
    tc::cp_async_commit();
    const int st = t % STAGES;
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      // A = w^T [16 n x 16 k]: the transpose of w's [k][n] rows
      unsigned a[4];
      tc::ldsm_x4_trans(
          a, &ws[st][kk * 16 + (lane & 7) + (lane >> 4) * 8]
                [warp * 16 + ((lane >> 3) & 1) * 8]);
#pragma unroll
      for (int j = 0; j < NB8; ++j) {  // B = x^T [16 k x 8 c]
        unsigned b[2];
        tc::ldsm_x2(b, &xs[st][j * 8 + (lane & 7)]
                         [kk * 16 + ((lane >> 3) & 1) * 8]);
        tc::mma_bf16(acc[j], a, b[0], b[1]);
      }
    }
  }
  tc::cp_async_wait<0>();

  const int g = lane >> 2, t4 = lane & 3;
  const size_t base = static_cast<size_t>(e) * C * N;
#pragma unroll
  for (int j = 0; j < NB8; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int n = n0 + warp * 16 + g + (i >> 1) * 8;
      const int c = j * 8 + t4 * 2 + (i & 1);
      if (c < C && n < N)
        ep.put(sp, base + static_cast<size_t>(c) * N + n, acc[j][i]);
    }
}

// Dynamic shared memory of gmm_tiles: the x and w rings.
template <int BM, int BN, int BK, int STAGES>
constexpr int tiles_smem_bytes() {
  return STAGES * (BM * (BK + kPad) + BK * (BN + kPad)) * 2;
}

// The [BM c x BN n] tile with WM x WN warps, each [BM / WM x BN / WN].
// Grid (C / BM, N / BN, E * splits): the c tiles of one weight tile are
// adjacent.
template <int BM, int BN, int BK, int WM, int WN, int STAGES>
__global__ void __launch_bounds__(kThreads) gmm_tiles(
    const bf16* __restrict__ x, const bf16* __restrict__ w, Epilogue ep,
    int C, int K, int N, int vec_x, int vec_w, int kt_per) {
  static_assert(WM * WN * 32 == kThreads, "4 warps");
  constexpr int TM = BM / WM, TN = BN / WN, MF = TM / 16, NF = TN / 8;
  static_assert(MF >= 1 && NF % 2 == 0, "whole fragments");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  auto xs = reinterpret_cast<bf16(*)[BM][BK + kPad]>(smem_raw);
  auto ws = reinterpret_cast<bf16(*)[BK][BN + kPad]>(
      smem_raw + STAGES * BM * (BK + kPad) * 2);
  const int c0 = blockIdx.x * BM, n0 = blockIdx.y * BN;
  const int e = blockIdx.z / ep.splits, sp = blockIdx.z % ep.splits;
  const int kt0 = sp * kt_per;
  const int nt = min((K + BK - 1) / BK - kt0, kt_per);
  const bf16* xe = x + static_cast<size_t>(e) * C * K;
  const bf16* we = w + static_cast<size_t>(e) * K * N;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int wm = warp / WN, wn = warp % WN;
  auto load = [&](int t) {
    const int st = t % STAGES, k0 = (kt0 + t) * BK;
    stage<BM, BK>(&xs[st][0][0], xe, C, K, c0, k0, vec_x != 0);
    stage<BK, BN>(&ws[st][0][0], we, K, N, k0, n0, vec_w != 0);
  };

  float acc[MF][NF][4] = {};
#pragma unroll
  for (int t = 0; t < STAGES - 1; ++t) {
    if (t < nt) load(t);
    tc::cp_async_commit();
  }
  for (int t = 0; t < nt; ++t) {
    tc::cp_async_wait<STAGES - 2>();
    __syncthreads();  // stage t landed; stage t - 1 is free again
    if (t + STAGES - 1 < nt) load(t + STAGES - 1);
    tc::cp_async_commit();
    const int st = t % STAGES;
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      unsigned a[MF][4];
#pragma unroll
      for (int mf = 0; mf < MF; ++mf)
        tc::ldsm_x4(a[mf], &xs[st][wm * TM + mf * 16 + (lane & 15)]
                              [kk * 16 + (lane >> 4) * 8]);
#pragma unroll
      for (int q = 0; q < NF / 2; ++q) {  // two blocks of 8 columns
        unsigned b[4];
        tc::ldsm_x4_trans(
            b, &ws[st][kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8]
                  [wn * TN + q * 16 + (lane >> 4) * 8]);
#pragma unroll
        for (int mf = 0; mf < MF; ++mf) {
          tc::mma_bf16(acc[mf][2 * q], a[mf], b[0], b[1]);
          tc::mma_bf16(acc[mf][2 * q + 1], a[mf], b[2], b[3]);
        }
      }
    }
  }
  tc::cp_async_wait<0>();

  const int g = lane >> 2, t4 = lane & 3;
  const size_t base = static_cast<size_t>(e) * C * N;
#pragma unroll
  for (int mf = 0; mf < MF; ++mf)
#pragma unroll
    for (int nf = 0; nf < NF; ++nf)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int c = c0 + wm * TM + mf * 16 + g + (i >> 1) * 8;
        const int n = n0 + wn * TN + nf * 8 + t4 * 2 + (i & 1);
        if (c < C && n < N)
          ep.put(sp, base + static_cast<size_t>(c) * N + n, acc[mf][nf][i]);
      }
}

// out = bf16(sum of the splits' fp32 partials), in split order.
__global__ void gmm_reduce(const float* __restrict__ work,
                           bf16* __restrict__ out, size_t total, int splits) {
  for (size_t i = blockIdx.x * static_cast<size_t>(blockDim.x) + threadIdx.x;
       i < total; i += static_cast<size_t>(gridDim.x) * blockDim.x) {
    float s = 0.f;
    for (int p = 0; p < splits; ++p) s += work[p * total + i];
    out[i] = __float2bfloat16(s);
  }
}

// The bf16 tile shapes, by C.
enum Variant { kSmall8, kSmall16, kChunk, kMono };
constexpr int kChunkBM = 32, kChunkBN = 64, kChunkBK = 64;
constexpr int kMonoBM = 64, kMonoBN = 128, kMonoBK = 32;
constexpr int kSmallBN = 64, kSmallBK = 64;

Variant variant_of(int C) {
  if (C <= 8) return kSmall8;
  if (C <= 16) return kSmall16;
  if (C <= 64) return kChunk;
  return kMono;
}

// (CTAs of one split, K depth of one step) of the bf16 grid.
void bf16_grid(int E, int C, int N, int* ctas, int* bk) {
  switch (variant_of(C)) {
    case kSmall8:
    case kSmall16:
      *ctas = (N + kSmallBN - 1) / kSmallBN * E;
      *bk = kSmallBK;
      return;
    case kChunk:
      *ctas = (C + kChunkBM - 1) / kChunkBM *
              ((N + kChunkBN - 1) / kChunkBN) * E;
      *bk = kChunkBK;
      return;
    default:
      *ctas = (C + kMonoBM - 1) / kMonoBM *
              ((N + kMonoBN - 1) / kMonoBN) * E;
      *bk = kMonoBK;
  }
}

template <int BM, int BN, int BK, int WM, int WN, int STAGES>
cudaError_t launch_tiles(const bf16* x, const bf16* w, const Epilogue& ep,
                         int C, int K, int N, int vec_x, int vec_w,
                         int kt_per, int z, cudaStream_t stream) {
  constexpr int bytes = tiles_smem_bytes<BM, BN, BK, STAGES>();
  auto kernel = gmm_tiles<BM, BN, BK, WM, WN, STAGES>;
  if (bytes > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return err;
  }
  kernel<<<dim3((C + BM - 1) / BM, (N + BN - 1) / BN, z), kThreads, bytes,
           stream>>>(x, w, ep, C, K, N, vec_x, vec_w, kt_per);
  return cudaSuccess;
}

int launch_bf16(const void* x, const void* w, void* out, void* work, int E,
                int C, int K, int N, int vec_x, int vec_w, int splits,
                cudaStream_t stream) {
  int ctas, bk;
  bf16_grid(E, C, N, &ctas, &bk);
  const int ktiles = (K + bk - 1) / bk;
  const int kt_per = (ktiles + splits - 1) / splits;
  const Epilogue ep{static_cast<bf16*>(out), static_cast<float*>(work),
                    splits, static_cast<size_t>(E) * C * N};
  const bf16* xb = static_cast<const bf16*>(x);
  const bf16* wb = static_cast<const bf16*>(w);
  const int z = E * splits;
  cudaError_t err = cudaSuccess;
  switch (variant_of(C)) {
    case kSmall8:
      gmm_small_c<1><<<dim3((N + kSmallBN - 1) / kSmallBN, 1, z), kThreads,
                       0, stream>>>(xb, wb, ep, C, K, N, vec_x, vec_w,
                                    kt_per);
      break;
    case kSmall16:
      gmm_small_c<2><<<dim3((N + kSmallBN - 1) / kSmallBN, 1, z), kThreads,
                       0, stream>>>(xb, wb, ep, C, K, N, vec_x, vec_w,
                                    kt_per);
      break;
    case kChunk:
      err = launch_tiles<kChunkBM, kChunkBN, kChunkBK, 1, 4, 4>(
          xb, wb, ep, C, K, N, vec_x, vec_w, kt_per, z, stream);
      break;
    default:
      err = launch_tiles<kMonoBM, kMonoBN, kMonoBK, 2, 2, 3>(
          xb, wb, ep, C, K, N, vec_x, vec_w, kt_per, z, stream);
  }
  if (err == cudaSuccess) err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return static_cast<int>(err);
  const size_t total = ep.total;
  const size_t want = (total + 255) / 256;
  const int blocks = static_cast<int>(want < 4096 ? want : 4096);
  gmm_reduce<<<blocks, 256, 0, stream>>>(static_cast<const float*>(work),
                                         static_cast<bf16*>(out), total,
                                         splits);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// How many ways grouped_matmul_launch splits K for these shapes on a card
// of sms SMs: 1 unless the grid has fewer CTAs than SMs, then enough
// splits to give every SM a CTA, each of at least one K step.  Always 1
// for fp32 (dtype 0).  The wrapper allocates the fp32 partials [splits, E,
// C, N] when it is more than 1.
int grouped_matmul_splits(int dtype, int E, int C, int K, int N, int sms) {
  if (dtype != 1) return 1;
  int ctas, bk;
  bf16_grid(E, C, N, &ctas, &bk);
  const int ktiles = (K + bk - 1) / bk;
  if (ctas >= sms || ktiles <= 1) return 1;
  int splits = (sms + ctas - 1) / ctas;
  if (splits > ktiles) splits = ktiles;
  const int per = (ktiles + splits - 1) / splits;
  return (ktiles + per - 1) / per;  // no split left empty
}

// Which hand-written instantiation runs for (dtype, C).
const char* grouped_matmul_variant(int dtype, int C) {
  if (dtype != 1) return "fp32 CUDA-core FMAs, [32 c x 64 n] tiles";
  switch (variant_of(C)) {
    case kSmall8:
      return "bf16 mma.sync small-C (out^T = w^T x^T, C <= 8), 64 n a CTA";
    case kSmall16:
      return "bf16 mma.sync small-C (out^T = w^T x^T, C <= 16), 64 n a CTA";
    case kChunk:
      return "bf16 mma.sync chunk tile [32 c x 64 n]";
    default:
      return "bf16 mma.sync monolithic tile [64 c x 128 n]";
  }
}

// dtype: 0 fp32, 1 bf16 (x, w and out alike).  x [E, C, K], w [E, K, N]
// and out [E, C, N] contiguous; vec_x / vec_w: 1 when every row of x / w
// starts on a 16-byte boundary (K / N a multiple of 16 bytes' worth of
// elements and an aligned base), so whole runs move as vectors.  splits
// from grouped_matmul_splits; work: fp32 [splits, E, C, N] when splits > 1
// (else unused).  E, C and N must be > 0.  Returns cudaGetLastError()
// after the launches, or -1 for a bad dtype code.
int grouped_matmul_launch(int dtype, const void* x, const void* w, void* out,
                          void* work, int E, int C, int K, int N, int vec_x,
                          int vec_w, int splits, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return launch<float>(x, w, out, E, C, K, N, vec_x, vec_w, s);
    case 1:
      return launch_bf16(x, w, out, work, E, C, K, N, vec_x, vec_w,
                         splits < 1 ? 1 : splits, s);
    default:
      return -1;
  }
}

}  // extern "C"
