// Dense product for Hopper (sm_90a), column-stable by construction:
//   out = x @ w      x [M, K], w [K, N] -> out [M, N]
// with x and w both bf16 or both fp32, products and sums in fp32 and out
// in x's type.
//
// Replaces no Pallas kernel.  The JAX package computes its projections
// with jnp (repro/models/lm.py:121-137, 289-291, 303-315; moe.py:160-166),
// which XLA lowers to a dot; its tensor-parallel guarantee (a sharded
// engine emits the unsharded engine's tokens bit for bit) rests on XLA's
// dot giving column-sliceable results: a product over a column shard of
// w equals those columns of the unsharded product.  cuBLAS picks its
// kernel by shape and does not (on an H100, 46 of chip_smoke.py phase
// 9h's 60 bf16 shard products matched, 24 of 60 in fp32).  This kernel is
// added so that the port keeps the JAX contract: the port calls it for every
// projection whose weight tensor parallelism cuts by columns (q, k, v and
// the attention output, the MLP's and the shared expert's three, whisper's
// encoder, decoder and cross-attention projections).
//
// The contract.  The arithmetic of each output element depends only on
// the launch plan (kernels/dense_matmul.py plan: the variant and the K
// split, from (dtype, M, K, plan_n) and the SM count) and on that
// element's row of x and column of w, never on where the column lies in
// the tile or on how many columns there are.  So for every width tp that
// divides N,
//   dense_matmul(x, w[:, r N/tp : (r+1) N/tp], plan_n=N)
//     == dense_matmul(x, w)[:, r N/tp : (r+1) N/tp]          bit for bit.
// Each element is summed over K in ascending order: 16-deep blocks inside
// the tensor-core instruction (the same instruction at every column), the
// blocks in order, and where the plan splits K, each split's fp32 partial
// summed in split order by a second pass.  No atomics: two calls give the
// same bits on any card.
//
// What bounds it on an H100: bytes at a decode tick, a verify pass or a
// chunk (M <= 64: each weight element is read once for 2 M flops, under
// the ~295 flops a byte at which the bf16 tensor cores take over), and
// operations at prompt and training rows (llama3.2-3b's w_gate at M 8192:
// 4.1e11 flops against 64 MB).  The variants, chosen by the plan:
//   * bf16, M <= 64 (and bf16 rows that TMA cannot describe at any M):
//     mma.sync tiles (tc_bf16.cuh) of out^T = w^T x^T, so that 16 columns
//     of N fill the mma's 16 rows and the tokens its 8 columns (8, 16, 32
//     or 64 rows of x a CTA, by M), instead of padding M to 16.  A CTA of
//     4 warps owns 64 columns (16 a warp) and streams w in 64-deep steps
//     through a 4-stage cp.async ring.  Where the global N gives fewer CTAs
//     than the card has SMs, K is split across CTAs so that the global N
//     fills the 132 SMs; each split writes an fp32 partial and a second
//     pass sums them in split order and rounds once;
//   * bf16, M > 64, rows 16-byte aligned (prompts, training): the
//     persistent wgmma + TMA mainloop of wgmma_bf16.cuh (as the
//     grouped-matmul backward runs it): one CTA an SM walks [128 x 256]
//     output tiles (the same tile at every N, the ragged edge zero-filled
//     by TMA and left unwritten by the TMA stores); a producer warpgroup
//     issues the TMA loads of x (K-major, [128 rows][64]) and w (read as it
//     lies, [K, N] row-major: MN-major, four [64 k][64 n] boxes) into a
//     3-stage ring; two consumer warpgroups run wgmma m64n256k16 over the
//     whole K of the tile, in order, with no split; the epilogue goes
//     through swizzled shared boxes and TMA stores;
//   * fp32, any M: CUDA-core FMAs, never TF32, [32 x 64] tiles, K walked
//     in 32-deep steps in order, split under the same rule as the bf16
//     mma.sync tiles.
// Operands are read in place (a layer's view of a stacked [L, K, N] leaf),
// with no padded copy.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "tc_bf16.cuh"
#include "wgmma_bf16.cuh"

namespace {

using tc::bf16;
constexpr int kThreads = 128;
constexpr int kPad = 8;  // bf16 elements of padding per shared row

// The variant codes of kernels/dense_matmul.py VARIANTS.
enum Variant { kF32 = 0, kMmaSync = 1, kWgmma = 2 };

template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) { return x; }
template <>
__device__ __forceinline__ bf16 from_float<bf16>(float x) {
  return __float2bfloat16(x);
}

// One output element: into out, or with a split of K the fp32 partial of
// split sp into work [splits, M, N].
template <typename T>
struct Epilogue {
  T* out;
  float* work;
  int splits;
  size_t total;  // M * N
  __device__ __forceinline__ void put(int sp, size_t i, float v) const {
    if (splits > 1)
      work[sp * total + i] = v;
    else
      out[i] = from_float<T>(v);
  }
};

// out = T(sum of the splits' fp32 partials), in split order.
template <typename T>
__global__ void dense_reduce(const float* __restrict__ work,
                             T* __restrict__ out, size_t total, int splits) {
  for (size_t i = blockIdx.x * static_cast<size_t>(blockDim.x) + threadIdx.x;
       i < total; i += static_cast<size_t>(gridDim.x) * blockDim.x) {
    float s = 0.f;
    for (int p = 0; p < splits; ++p) s += work[p * total + i];
    out[i] = from_float<T>(s);
  }
}

// ------------------------------------------------ fp32: CUDA-core kernel

constexpr int kF32M = 32;  // rows of x per CTA
constexpr int kF32N = 64;  // output columns per CTA
constexpr int kF32K = 32;  // depth staged per step
constexpr int kRun = 8;    // consecutive elements one thread loads
constexpr int kWRuns = kF32K * kF32N / kRun / kThreads;  // 2 per thread
static_assert(kF32M * kF32K / kRun == kThreads, "one x run per thread");

// kRun consecutive floats from src, of which the first n lie inside the
// tensor (zeros past them); with vec, a whole run is two 16-byte loads.
__device__ __forceinline__ void load_run(const float* src, int n, bool vec,
                                         float* dst) {
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

// Grid (N / 64, M / 32, splits); split sp walks K steps kt0 .. kt0 +
// kt_per - 1 (the last split fewer), each thread a 4 x 4 block.
__global__ void __launch_bounds__(kThreads) dense_f32(
    const float* __restrict__ x, const float* __restrict__ w,
    Epilogue<float> ep, int M, int K, int N, int vec_x, int vec_w,
    int kt_per) {
  // x tile transposed (xs[k][m]) so a thread reads its 4 rows as one
  // float4; w tile as it lies (ws[k][n])
  __shared__ __align__(16) float xs[kF32K][kF32M];
  __shared__ __align__(16) float ws[kF32K][kF32N];
  const int n0 = blockIdx.x * kF32N, m0 = blockIdx.y * kF32M;
  const int sp = blockIdx.z;
  const int kt0 = sp * kt_per;
  const int nt = min((K + kF32K - 1) / kF32K - kt0, kt_per);
  const int tid = threadIdx.x;
  const int tm = tid / 16;  // rows m0 + 4 tm .. + 3
  const int tn = tid % 16;  // columns n0 + 4 tn .. + 3
  // this thread's x run: row xm, depth xk .. xk + 7 of the tile
  const int xm = tid / (kF32K / kRun);
  const int xk = (tid % (kF32K / kRun)) * kRun;
  float xr[kRun], wr[kWRuns][kRun];

  auto load = [&](int k0) {
    const int m = m0 + xm, k = k0 + xk;
    const int nx = (m < M) ? K - k : 0;
    load_run(x + static_cast<size_t>(m < M ? m : 0) * K + k, nx, vec_x != 0,
             xr);
#pragma unroll
    for (int j = 0; j < kWRuns; ++j) {
      const int i = tid + j * kThreads;
      const int kk = k0 + i / (kF32N / kRun);
      const int nn = n0 + (i % (kF32N / kRun)) * kRun;
      const int nw = (kk < K) ? N - nn : 0;
      load_run(w + static_cast<size_t>(kk < K ? kk : 0) * N + nn, nw,
               vec_w != 0, wr[j]);
    }
  };

  float acc[4][4];
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[r][c] = 0.f;
  const bool active = m0 + 4 * tm < M;

  if (nt > 0) load(kt0 * kF32K);
  for (int t = 0; t < nt; ++t) {
    const int k0 = (kt0 + t) * kF32K;
#pragma unroll
    for (int i = 0; i < kRun; ++i) xs[xk + i][xm] = xr[i];
#pragma unroll
    for (int j = 0; j < kWRuns; ++j) {
      const int i = tid + j * kThreads;
      float* dst = &ws[i / (kF32N / kRun)][(i % (kF32N / kRun)) * kRun];
      *reinterpret_cast<float4*>(dst) =
          make_float4(wr[j][0], wr[j][1], wr[j][2], wr[j][3]);
      *reinterpret_cast<float4*>(dst + 4) =
          make_float4(wr[j][4], wr[j][5], wr[j][6], wr[j][7]);
    }
    __syncthreads();
    if (t + 1 < nt) load(k0 + kF32K);  // in flight during the FMAs
    if (active) {
#pragma unroll 8
      for (int k = 0; k < kF32K; ++k) {
        const float4 a = *reinterpret_cast<const float4*>(&xs[k][4 * tm]);
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

#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int m = m0 + 4 * tm + r;
    if (m >= M) break;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + 4 * tn + j;
      if (n < N) ep.put(sp, static_cast<size_t>(m) * N + n, acc[r][j]);
    }
  }
}

// ------------------------------------ bf16, M <= 64: mma.sync tiles

constexpr int kSmallBN = 64, kSmallBK = 64, kSmallStages = 4;

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

template <int NB8>
constexpr int small_smem_bytes() {
  return kSmallStages * (8 * NB8 * (kSmallBK + kPad) +
                         kSmallBK * (kSmallBN + kPad)) * 2;
}

// out^T [n, m] = w^T x^T over 8 NB8 rows of x a CTA.  Grid (N / 64, M /
// (8 NB8), splits); warp w owns columns n0 + 16 w .. + 15, the A fragment
// (16 n x 16 k of w^T, one ldmatrix.trans) reused over NB8 blocks of 8
// rows.
template <int NB8>
__global__ void __launch_bounds__(kThreads) dense_mma_sync(
    const bf16* __restrict__ x, const bf16* __restrict__ w,
    Epilogue<bf16> ep, int M, int K, int N, int vec_x, int vec_w,
    int kt_per) {
  constexpr int TM = 8 * NB8, BN = kSmallBN, BK = kSmallBK;
  constexpr int STAGES = kSmallStages;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  auto xs = reinterpret_cast<bf16(*)[TM][BK + kPad]>(smem_raw);
  auto ws = reinterpret_cast<bf16(*)[BK][BN + kPad]>(
      smem_raw + STAGES * TM * (BK + kPad) * 2);
  const int n0 = blockIdx.x * BN, m0 = blockIdx.y * TM, sp = blockIdx.z;
  const int kt0 = sp * kt_per;
  const int nt = min((K + BK - 1) / BK - kt0, kt_per);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  auto load = [&](int t) {
    const int st = t % STAGES, k0 = (kt0 + t) * BK;
    stage<TM, BK>(&xs[st][0][0], x, M, K, m0, k0, vec_x != 0);
    stage<BK, BN>(&ws[st][0][0], w, K, N, k0, n0, vec_w != 0);
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
      for (int j = 0; j < NB8; ++j) {  // B = x^T [16 k x 8 m]
        unsigned b[2];
        tc::ldsm_x2(b, &xs[st][j * 8 + (lane & 7)]
                         [kk * 16 + ((lane >> 3) & 1) * 8]);
        tc::mma_bf16(acc[j], a, b[0], b[1]);
      }
    }
  }
  tc::cp_async_wait<0>();

  const int g = lane >> 2, t4 = lane & 3;
#pragma unroll
  for (int j = 0; j < NB8; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int n = n0 + warp * 16 + g + (i >> 1) * 8;
      const int m = m0 + j * 8 + t4 * 2 + (i & 1);
      if (m < M && n < N)
        ep.put(sp, static_cast<size_t>(m) * N + n, acc[j][i]);
    }
}

template <int NB8>
cudaError_t launch_small(const bf16* x, const bf16* w,
                         const Epilogue<bf16>& ep, int M, int K, int N,
                         int vec_x, int vec_w, int kt_per,
                         cudaStream_t stream) {
  constexpr int bytes = small_smem_bytes<NB8>();
  auto kernel = dense_mma_sync<NB8>;
  if (bytes > 48 * 1024) {  // once a process (a call a projection at decode)
    static const cudaError_t attr = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (attr != cudaSuccess) return attr;
  }
  kernel<<<dim3((N + kSmallBN - 1) / kSmallBN, (M + 8 * NB8 - 1) / (8 * NB8),
                ep.splits),
           kThreads, bytes, stream>>>(x, w, ep, M, K, N, vec_x, vec_w,
                                      kt_per);
  return cudaGetLastError();
}

// --------------------- bf16, M > 64, TMA-aligned rows: wgmma kernel

constexpr int WBM = 128, WBN = 256, WBK = 64, WSTAGES = 3;
constexpr int kWThreads = 384;    // a producer and two consumer warpgroups
constexpr int kConsumers = 256;   // arrivals that free a stage
constexpr int kBox = 64 * WBK * 2;          // 8 KB: a box of 64 x 64
constexpr int kA = WBM * WBK * 2;           // 16 KB: x's share of a stage
constexpr int kStage = kA + WBN * WBK * 2;  // 48 KB: x, then w
constexpr int kOut = 64 * WBN * 2;          // 32 KB: a consumer's rows out
constexpr int kWSmem = WSTAGES * kStage + 2 * kOut + 2 * WSTAGES * 8 + 1024;

// Grid: min(tiles, SMs) CTAs of kWThreads; tile t is rows (t % mt) 128 ..
// and columns (t / mt) 256 .. (the row tiles of one column tile adjacent,
// so they read its w from L2).  Tensor maps (bf16, 3-D with one "expert",
// 128-byte swizzle): x_k over x [M][K], boxes 64 x 128 (K-major A); w_mn
// over w [K][N], 64 x 64 (MN-major B, four a stage); o over out [M][N],
// 64 x 64.
__global__ void __launch_bounds__(kWThreads, 1) dense_wgmma(
    const __grid_constant__ CUtensorMap x_k,
    const __grid_constant__ CUtensorMap w_mn,
    const __grid_constant__ CUtensorMap o, int mt, int tiles, int kb) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  // the ring's base on a 1024-byte boundary (the swizzle atoms'), then
  // each consumer's output rows, then the barriers
  unsigned char* ring =
      smem_raw + ((1024 - (wg::smem_u32(smem_raw) & 1023)) & 1023);
  unsigned char* outs = ring + WSTAGES * kStage;
  uint64_t* full = reinterpret_cast<uint64_t*>(outs + 2 * kOut);
  uint64_t* empty = full + WSTAGES;
  if (threadIdx.x == 0) {
    for (int s = 0; s < WSTAGES; ++s) {
      wg::mbar_init(&full[s], 1);
      wg::mbar_init(&empty[s], kConsumers);
    }
    wg::mbar_init_fence();
  }
  __syncthreads();
  const int group = threadIdx.x / 128;
  if (group == 0) {  // the producer
    wg::setmaxnreg_dec<40>();
    if (threadIdx.x != 0) return;
    int stage = 0;
    uint32_t phase = 0;
    for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
      const int m0 = (t % mt) * WBM, n0 = (t / mt) * WBN;
      for (int k = 0; k < kb; ++k) {
        wg::mbar_wait(&empty[stage], phase ^ 1);
        uint64_t* bar = &full[stage];
        wg::mbar_expect_tx(bar, kStage);
        unsigned char* a = ring + stage * kStage;
        unsigned char* b = a + kA;
        const int k0 = k * WBK;
        wg::tma_load_3d(a, &x_k, bar, k0, m0, 0);  // x rows m0.., cols k0..
        for (int j = 0; j < WBN / 64; ++j)  // w rows k0.. as [k][n]
          wg::tma_load_3d(b + j * kBox, &w_mn, bar, n0 + 64 * j, k0, 0);
        if (++stage == WSTAGES) {
          stage = 0;
          phase ^= 1;
        }
      }
    }
  } else {  // a consumer: rows 64 cw .. 64 cw + 63 of every tile
    wg::setmaxnreg_inc<232>();
    const int cw = group - 1;
    const int lane = threadIdx.x & 31, g = lane >> 2, t4 = lane & 3;
    const int row = 16 * ((threadIdx.x / 32) & 3) + g;  // and row + 8
    const bool leader = threadIdx.x % 128 == 0;
    unsigned char* out = outs + cw * kOut;  // four boxes of [64][64] bf16
    int stage = 0;
    uint32_t phase = 0;
    float acc[128];
    for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
      const int m0 = (t % mt) * WBM, n0 = (t / mt) * WBN;
      // the whole K of the tile in order; a stage is freed once the group
      // after it has been issued and it has completed
      int prev = -1;
      for (int k = 0; k < kb; ++k) {
        wg::mbar_wait(&full[stage], phase);
        const unsigned char* a = ring + stage * kStage + cw * kBox;
        const unsigned char* b = ring + stage * kStage + kA;
        wg::wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < WBK / 16; ++kk)
          // x K-major: 16 values are 32 bytes of each 128-byte row; w
          // MN-major: 16 reduction rows are two 1024-byte atoms
          wg::wgmma_m64n256k16<0, 1>(
              acc, wg::desc_sw128(a + kk * 32, 16, 1024),
              wg::desc_sw128(b + kk * 2048, kBox, 1024), k > 0 || kk > 0);
        wg::wgmma_commit();
        if (prev >= 0) {
          wg::wgmma_wait<1>();
          wg::mbar_arrive(&empty[prev]);
        }
        prev = stage;
        if (++stage == WSTAGES) {
          stage = 0;
          phase ^= 1;
        }
      }
      wg::wgmma_wait<0>();
      wg::fence_regs(acc);
      wg::mbar_arrive(&empty[prev]);
      // the rows as bf16 into the 128-byte-swizzled boxes once the last
      // tile's store has read them, then one TMA store a box (the edges
      // past M or N are not written)
      if (leader) wg::bulk_wait_read<0>();
      wg::named_sync(1 + cw, 128);
#pragma unroll
      for (int j = 0; j < WBN / 8; ++j)
#pragma unroll
        for (int v = 0; v < 2; ++v) {
          const int r = row + 8 * v;
          *reinterpret_cast<unsigned*>(
              out + (j / 8) * kBox + r * 128 + (((j & 7) ^ g) << 4) +
              4 * t4) = tc::pack_bf16(acc[4 * j + 2 * v],
                                      acc[4 * j + 2 * v + 1]);
        }
      wg::fence_proxy_async();
      wg::named_sync(1 + cw, 128);
      if (leader) {
        for (int q = 0; q < WBN / 64; ++q)
          wg::tma_store_3d(&o, out + q * kBox, n0 + 64 * q, m0 + 64 * cw, 0);
        wg::bulk_commit();
      }
    }
    if (leader) wg::bulk_wait<0>();
  }
}

// cuTensorMapEncodeTiled from the driver, found once through the runtime
// (no -lcuda at link time); nullptr where the driver lacks it.
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static const EncodeTiled fn = []() -> EncodeTiled {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err != cudaSuccess || found != cudaDriverEntryPointSuccess)
      return nullptr;
    return reinterpret_cast<EncodeTiled>(p);
  }();
  return fn;
}

// A bf16 matrix [rows][inner] (contiguous, inner a multiple of 8, base
// 16-byte aligned) as a 3-D map of boxes box_inner x box_rows x 1, 128-byte
// swizzle, zeros out of bounds.  Returns 0, or the driver's error code.
int tensor_map(CUtensorMap* map, const void* base, int rows, int inner,
               int box_inner, int box_rows) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return static_cast<int>(CUDA_ERROR_NOT_FOUND);
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(inner),
                              static_cast<cuuint64_t>(rows), 1};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(inner) * 2,
                                 static_cast<cuuint64_t>(rows) * inner * 2};
  const cuuint32_t box[3] = {static_cast<cuuint32_t>(box_inner),
                             static_cast<cuuint32_t>(box_rows), 1};
  const cuuint32_t unit[3] = {1, 1, 1};
  return static_cast<int>(fn(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(base), dims,
      strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE));
}

// Driver errors come back offset, apart from the runtime's.
constexpr int kDriverError = 100000;

int launch_wgmma(const bf16* x, const bf16* w, bf16* out, int M, int K,
                 int N, int sms, cudaStream_t stream) {
  CUtensorMap x_k, w_mn, o;
  int err = tensor_map(&x_k, x, M, K, 64, WBM);
  if (err == 0) err = tensor_map(&w_mn, w, K, N, 64, WBK);
  if (err == 0) err = tensor_map(&o, out, M, N, 64, 64);
  if (err != 0) return kDriverError + err;
  // setmaxnreg.inc waits for registers the producer releases: the
  // consumers' 2 x 128 x (232 - r) must fit in its 128 x (r - 40), so the
  // kernel must start with r >= 168 registers a thread (it does, built
  // with __launch_bounds__(384, 1)); a build with fewer is refused here
  // rather than left to hang
  static const int regs = [] {
    cudaFuncAttributes a;
    return cudaFuncGetAttributes(&a, dense_wgmma) == cudaSuccess ? a.numRegs
                                                                 : 0;
  }();
  if (regs < 168) return static_cast<int>(cudaErrorLaunchOutOfResources);
  static const cudaError_t attr = cudaFuncSetAttribute(
      dense_wgmma, cudaFuncAttributeMaxDynamicSharedMemorySize, kWSmem);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const int mt = (M + WBM - 1) / WBM;
  const int tiles = mt * ((N + WBN - 1) / WBN);
  const int grid = tiles < sms ? tiles : sms;
  dense_wgmma<<<grid, kWThreads, kWSmem, stream>>>(x_k, w_mn, o, mt, tiles,
                                                   (K + WBK - 1) / WBK);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
cudaError_t launch_reduce(const float* work, T* out, size_t total,
                          int splits, cudaStream_t stream) {
  const size_t want = (total + 255) / 256;
  const int blocks = static_cast<int>(want < 4096 ? want : 4096);
  dense_reduce<T><<<blocks, 256, 0, stream>>>(work, out, total, splits);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 0 fp32, 1 bf16 (x, w and out alike).  variant: 0 the fp32
// CUDA-core tiles, 1 the bf16 mma.sync tiles of 8 rows8 rows of x a CTA
// (rows8 1, 2, 4 or 8), 2 the bf16 wgmma kernel; splits and kt_per (K
// steps a split) from kernels/dense_matmul.py plan (1 for the wgmma
// kernel).  x [M, K], w [K, N] and out [M, N] contiguous; vec_x / vec_w: 1
// when every row of x / w starts on a 16-byte boundary (the wgmma kernel
// needs both); work: fp32 [splits, M, N] when splits > 1 (else unused);
// sms: the card's SMs (the wgmma kernel's persistent grid at most).  M, K
// and N must be > 0.  Returns cudaGetLastError() after the launches,
// 100000 + the driver's error where a tensor map cannot be encoded, or -1
// for an argument the kernels do not take.
int dense_matmul_launch(int dtype, int variant, int rows8, const void* x,
                        const void* w, void* out, void* work, int M, int K,
                        int N, int vec_x, int vec_w, int splits, int kt_per,
                        int sms, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (splits < 1 || kt_per < 1) return -1;
  const size_t total = static_cast<size_t>(M) * N;
  cudaError_t err;
  if (dtype == 0 && variant == kF32) {
    const Epilogue<float> ep{static_cast<float*>(out),
                             static_cast<float*>(work), splits, total};
    dense_f32<<<dim3((N + kF32N - 1) / kF32N, (M + kF32M - 1) / kF32M,
                     splits),
                kThreads, 0, s>>>(static_cast<const float*>(x),
                                  static_cast<const float*>(w), ep, M, K, N,
                                  vec_x, vec_w, kt_per);
    err = cudaGetLastError();
    if (err != cudaSuccess || splits == 1) return static_cast<int>(err);
    return static_cast<int>(launch_reduce<float>(
        static_cast<const float*>(work), static_cast<float*>(out), total,
        splits, s));
  }
  if (dtype != 1) return -1;
  const bf16* xb = static_cast<const bf16*>(x);
  const bf16* wb = static_cast<const bf16*>(w);
  if (variant == kWgmma) {
    if (splits != 1 || !vec_x || !vec_w) return -1;
    return launch_wgmma(xb, wb, static_cast<bf16*>(out), M, K, N, sms, s);
  }
  if (variant != kMmaSync) return -1;
  const Epilogue<bf16> ep{static_cast<bf16*>(out), static_cast<float*>(work),
                          splits, total};
  switch (rows8) {
    case 1:
      err = launch_small<1>(xb, wb, ep, M, K, N, vec_x, vec_w, kt_per, s);
      break;
    case 2:
      err = launch_small<2>(xb, wb, ep, M, K, N, vec_x, vec_w, kt_per, s);
      break;
    case 4:
      err = launch_small<4>(xb, wb, ep, M, K, N, vec_x, vec_w, kt_per, s);
      break;
    case 8:
      err = launch_small<8>(xb, wb, ep, M, K, N, vec_x, vec_w, kt_per, s);
      break;
    default:
      return -1;
  }
  if (err != cudaSuccess || splits == 1) return static_cast<int>(err);
  return static_cast<int>(launch_reduce<bf16>(
      static_cast<const float*>(work), static_cast<bf16*>(out), total,
      splits, s));
}

}  // extern "C"
