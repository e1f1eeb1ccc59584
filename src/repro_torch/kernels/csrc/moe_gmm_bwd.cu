// Grouped matmul (backward) for Hopper (sm_90a): given the forward's
// operands x [E, C, K], w [E, K, N] and the output's gradient dy
// [E, C, N], all bf16 or all fp32, returns
//   dx[e] = dy[e] w[e]^T   [E, C, K]      dw[e] = x[e]^T dy[e]   [E, K, N]
// with products and sums in fp32, each output rounded once to the
// inputs' type.
//
// Replaces no Pallas kernel: the JAX package trains its MoE layers through
// jnp.einsum (repro/models/moe.py:128-146), which XLA differentiates.  The
// port runs its forward through the grouped-matmul kernel (csrc/moe_gmm.cu),
// whose autograd Function (kernels/moe_gmm.py GroupedMatmul) calls this
// kernel for the three expert contractions of every MoE layer.
//
// What bounds it on an H100: operations, at the training shapes.  A
// granite-moe-1b-a400m gate product at B 8 x S 1024 (E 32, C 2560, K 1024,
// N 512) needs 4 E C K N = 1.72e11 operations (0.17 ms at the bf16 peak)
// over 2 x 168 MB + 34 MB (dy and x read, dx written; w read and dw
// written: 0.13 ms at 3.35 TB/s).
//
// Design (simple first): one generic tiled product out[M, N'] = A[M, R]
// B[R, N'] per expert, instantiated twice:
//   * dx: A = dy [C, N] as it lies (M = C, R = N), B(r, n') = w[n', r]
//     (w's rows are the output columns, so each row is read along the
//     reduction: ldmatrix without .trans);
//   * dw: A(m, r) = x[r, m] (x read transposed: ldmatrix.trans of its
//     [c][k] rows), B = dy [C, N] (ldmatrix.trans, as the forward's w).
// bf16: [64 x 128] tiles of 2 x 2 warps, 32-deep steps through a 3-stage
// cp.async ring (the forward's monolithic tile), mma.sync m16n8k16 with
// fp32 accumulators (tc_bf16.cuh).  bf16 x bf16 products are exact in fp32,
// so the result differs from the plain version only in the order of its
// sums.  fp32: a CUDA-core kernel of full fp32 FMAs (never TF32),
// [64 x 64] tiles, 4 x 4 outputs a thread.
// Deterministic, with no atomics: each output element is summed by one
// thread over the whole reduction (dw: all C rows of its expert) in
// ascending order, so two calls give the same bits.  Every grid of the
// training shapes has thousands of CTAs (dw of a granite gate product:
// 2048), so the reduction needs no split across CTAs.
// Later work: wgmma and TMA; one launch for dx and dw.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "tc_bf16.cuh"

namespace {

using tc::bf16;
constexpr int kThreads = 128;
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

constexpr int BM = 64, BN = 128, BK = 32, WM = 2, WN = 2, STAGES = 3;
constexpr int TM = BM / WM, TN = BN / WN, MF = TM / 16, NF = TN / 8;
// A_T: A stored [R, M] (read transposed); B_T: B stored [N', R].
template <bool A_T, bool B_T>
struct Smem {
  static constexpr int A_ELEMS = A_T ? BK * (BM + kPad) : BM * (BK + kPad);
  static constexpr int B_ELEMS = B_T ? BN * (BK + kPad) : BK * (BN + kPad);
  static constexpr int BYTES = STAGES * (A_ELEMS + B_ELEMS) * 2;
};

// out[e] [M, N'] = A[e] B[e]; A[e] [M, R] row-major, or [R, M] with A_T;
// B[e] [R, N'] row-major, or [N', R] with B_T.  Grid (M / BM, N' / BN, E).
template <bool A_T, bool B_T>
__global__ void __launch_bounds__(kThreads) gmm_bwd_tiles(
    const bf16* __restrict__ a, const bf16* __restrict__ b,
    bf16* __restrict__ out, int M, int R, int N, int vec_a, int vec_b) {
  using S = Smem<A_T, B_T>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* as = reinterpret_cast<bf16*>(smem_raw);
  bf16* bs = as + STAGES * S::A_ELEMS;
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BN, e = blockIdx.z;
  const bf16* ae = a + static_cast<size_t>(e) * M * R;
  const bf16* be = b + static_cast<size_t>(e) * R * N;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int wm = warp / WN, wn = warp % WN;
  const int nt = (R + BK - 1) / BK;
  auto load = [&](int t) {
    const int st = t % STAGES, r0 = t * BK;
    if (A_T)
      stage<BK, BM>(as + st * S::A_ELEMS, ae, R, M, r0, m0, vec_a != 0);
    else
      stage<BM, BK>(as + st * S::A_ELEMS, ae, M, R, m0, r0, vec_a != 0);
    if (B_T)
      stage<BN, BK>(bs + st * S::B_ELEMS, be, N, R, n0, r0, vec_b != 0);
    else
      stage<BK, BN>(bs + st * S::B_ELEMS, be, R, N, r0, n0, vec_b != 0);
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
    const bf16* at = as + (t % STAGES) * S::A_ELEMS;
    const bf16* bt = bs + (t % STAGES) * S::B_ELEMS;
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      unsigned af[MF][4];
#pragma unroll
      for (int mf = 0; mf < MF; ++mf) {
        const int mb = wm * TM + mf * 16;
        if (A_T)  // stored [r][m]: matrices (r, m), (r, m + 8), (r + 8, ..)
          tc::ldsm_x4_trans(
              af[mf], at + (kk * 16 + (lane & 7) + (lane >> 4) * 8) *
                               (BM + kPad) + mb + ((lane >> 3) & 1) * 8);
        else  // stored [m][r]
          tc::ldsm_x4(af[mf], at + (mb + (lane & 15)) * (BK + kPad) +
                                  kk * 16 + (lane >> 4) * 8);
      }
#pragma unroll
      for (int q = 0; q < NF / 2; ++q) {  // two blocks of 8 columns
        const int nb = wn * TN + q * 16;
        unsigned bf[4];
        if (B_T)  // stored [n][r]: b0, b1 of block nb, then of nb + 8
          tc::ldsm_x4(bf, bt + (nb + (lane & 7) + (lane >> 4) * 8) *
                                   (BK + kPad) + kk * 16 +
                          ((lane >> 3) & 1) * 8);
        else  // stored [r][n]
          tc::ldsm_x4_trans(
              bf, bt + (kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) *
                           (BN + kPad) + nb + (lane >> 4) * 8);
#pragma unroll
        for (int mf = 0; mf < MF; ++mf) {
          tc::mma_bf16(acc[mf][2 * q], af[mf], bf[0], bf[1]);
          tc::mma_bf16(acc[mf][2 * q + 1], af[mf], bf[2], bf[3]);
        }
      }
    }
  }
  tc::cp_async_wait<0>();

  const int g = lane >> 2, t4 = lane & 3;
  bf16* oe = out + static_cast<size_t>(e) * M * N;
#pragma unroll
  for (int mf = 0; mf < MF; ++mf)
#pragma unroll
    for (int nf = 0; nf < NF; ++nf)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int m = m0 + wm * TM + mf * 16 + g + (i >> 1) * 8;
        const int n = n0 + wn * TN + nf * 8 + t4 * 2 + (i & 1);
        if (m < M && n < N)
          oe[static_cast<size_t>(m) * N + n] = __float2bfloat16(acc[mf][nf][i]);
      }
}

template <bool A_T, bool B_T>
cudaError_t launch_tiles(const bf16* a, const bf16* b, bf16* out, int E,
                         int M, int R, int N, int vec_a, int vec_b,
                         cudaStream_t stream) {
  constexpr int bytes = Smem<A_T, B_T>::BYTES;
  auto kernel = gmm_bwd_tiles<A_T, B_T>;
  if (bytes > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return err;
  }
  kernel<<<dim3((M + BM - 1) / BM, (N + BN - 1) / BN, E), kThreads, bytes,
           stream>>>(a, b, out, M, R, N, vec_a, vec_b);
  return cudaGetLastError();
}

// ------------------------------------------------ fp32: CUDA-core kernel

constexpr int kF32Threads = 256;
constexpr int FM = 64, FN = 64, FK = 16;

// The same product in fp32 FMAs: A and B tiles staged as [FK][FM] and
// [FK][FN] (reduction-major), each thread a 4 x 4 block of the 64 x 64
// output tile, summed over R in ascending order.
template <bool A_T, bool B_T>
__global__ void __launch_bounds__(kF32Threads) gmm_bwd_f32(
    const float* __restrict__ a, const float* __restrict__ b,
    float* __restrict__ out, int M, int R, int N) {
  __shared__ __align__(16) float as[FK][FM];
  __shared__ __align__(16) float bs[FK][FN];
  const int m0 = blockIdx.x * FM, n0 = blockIdx.y * FN, e = blockIdx.z;
  const float* ae = a + static_cast<size_t>(e) * M * R;
  const float* be = b + static_cast<size_t>(e) * R * N;
  const int tid = threadIdx.x, tm = tid / 16, tn = tid % 16;
  float acc[4][4] = {};
  for (int r0 = 0; r0 < R; r0 += FK) {
    for (int i = tid; i < FK * FM; i += kF32Threads) {
      // A_T reads along m (its rows), else along r
      const int r = A_T ? i / FM : i % FK, m = A_T ? i % FM : i / FK;
      const int gr = r0 + r, gm = m0 + m;
      as[r][m] = (gr < R && gm < M)
                     ? ae[A_T ? static_cast<size_t>(gr) * M + gm
                              : static_cast<size_t>(gm) * R + gr]
                     : 0.f;
    }
    for (int i = tid; i < FK * FN; i += kF32Threads) {
      const int r = B_T ? i % FK : i / FN, n = B_T ? i / FK : i % FN;
      const int gr = r0 + r, gn = n0 + n;
      bs[r][n] = (gr < R && gn < N)
                     ? be[B_T ? static_cast<size_t>(gn) * R + gr
                              : static_cast<size_t>(gr) * N + gn]
                     : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < FK; ++k) {
      const float4 av = *reinterpret_cast<const float4*>(&as[k][4 * tm]);
      const float4 bv = *reinterpret_cast<const float4*>(&bs[k][4 * tn]);
      const float ar[4] = {av.x, av.y, av.z, av.w};
      const float br[4] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(ar[i], br[j], acc[i][j]);
    }
    __syncthreads();
  }
  float* oe = out + static_cast<size_t>(e) * M * N;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = m0 + 4 * tm + i;
    if (m >= M) break;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + 4 * tn + j;
      if (n < N) oe[static_cast<size_t>(m) * N + n] = acc[i][j];
    }
  }
}

template <bool A_T, bool B_T>
cudaError_t launch_f32(const float* a, const float* b, float* out, int E,
                       int M, int R, int N, cudaStream_t stream) {
  gmm_bwd_f32<A_T, B_T><<<dim3((M + FM - 1) / FM, (N + FN - 1) / FN, E),
                          kF32Threads, 0, stream>>>(a, b, out, M, R, N);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 0 fp32, 1 bf16 (x, w, dy, dx and dw alike).  x [E, C, K], w
// [E, K, N], dy [E, C, N], dx [E, C, K], dw [E, K, N], contiguous; vec_*:
// 1 when every row of that operand starts on a 16-byte boundary (its row
// length a multiple of 8 elements and an aligned base; bf16 only).  E, C,
// K and N must be > 0.  Two kernels on `stream` (dx, then dw); returns
// cudaGetLastError() after each launch (the first failure), -1 for a bad
// dtype code.
int grouped_matmul_bwd_launch(int dtype, const void* x, const void* w,
                              const void* dy, void* dx, void* dw, int E,
                              int C, int K, int N, int vec_x, int vec_w,
                              int vec_dy, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (dtype) {
    case 0: {
      const float* xf = static_cast<const float*>(x);
      const float* wf = static_cast<const float*>(w);
      const float* dyf = static_cast<const float*>(dy);
      err = launch_f32<false, true>(dyf, wf, static_cast<float*>(dx), E, C,
                                    N, K, s);
      if (err != cudaSuccess) return static_cast<int>(err);
      return static_cast<int>(launch_f32<true, false>(
          xf, dyf, static_cast<float*>(dw), E, K, C, N, s));
    }
    case 1: {
      const bf16* xb = static_cast<const bf16*>(x);
      const bf16* wb = static_cast<const bf16*>(w);
      const bf16* dyb = static_cast<const bf16*>(dy);
      // dx [C, K] = dy [C, N] . (w [K, N])^T
      err = launch_tiles<false, true>(dyb, wb, static_cast<bf16*>(dx), E, C,
                                      N, K, vec_dy, vec_w, s);
      if (err != cudaSuccess) return static_cast<int>(err);
      // dw [K, N] = (x [C, K])^T . dy [C, N]
      return static_cast<int>(launch_tiles<true, false>(
          xb, dyb, static_cast<bf16*>(dw), E, K, C, N, vec_x, vec_dy, s));
    }
    default:
      return -1;
  }
}

}  // extern "C"
