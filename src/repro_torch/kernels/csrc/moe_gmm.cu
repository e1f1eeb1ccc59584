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
// speculative verify pass and a few hundred for a monolithic prefill.
//
// What bounds it on an H100: bytes, at every serving shape.  Each weight
// element is read once per call and used for 2*C flops; in bf16 that is C
// flops per byte, under the ~295 flops per byte at which the tensor cores
// would take over, for any C the serving path makes (granite-moe's decode
// tick: 33.5 MB of one projection's weights for 0.27 GFLOP).  This first
// version multiplies on the CUDA cores in fp32 (plain FMAs, never TF32),
// so at large C (a 1024-token prefill bucket, C 320) its own limit is the
// 67 TFLOP/s fp32 rate, not the bytes.  The design:
//   * one CTA per (64-column tile of N, 32-row tile of C, expert); the
//     Pallas kernel's sequential K grid axis becomes a loop inside the CTA
//     that stages [32, 32] x and [32, 64] w tiles in shared memory;
//   * each thread keeps a 4 x 4 block of the output in fp32 registers and
//     accumulates in ascending K, with one FMA per product;
//   * the next K tile is loaded into registers while the current one is
//     multiplied, so global-memory latency overlaps the FMAs;
//   * loads are 16-byte vectors where a row run of 8 elements lies inside
//     the tensor and rows are 16-byte aligned, scalar and masked at the
//     ragged edges of C, K and N: no padded copy of x or w is made, and
//     each layer's [E, K, N] weights are read in place (a view of the
//     stacked [L, E, K, N] leaf);
//   * warps whose rows all lie past C (a decode tick fills 8 of the 32
//     rows) still help load the tiles but skip the FMAs.
// Later work: bf16 tensor-core products (mma.sync, then wgmma with TMA)
// and a persistent schedule over the experts' tiles.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kTileC = 32;  // rows of x (tokens of one expert) per CTA
constexpr int kTileN = 64;  // output columns per CTA
constexpr int kTileK = 32;  // depth staged per step
constexpr int kRun = 8;     // consecutive elements one thread loads
constexpr int kWRuns = kTileK * kTileN / kRun / kThreads;  // 2 per thread
static_assert(kTileC * kTileK / kRun == kThreads, "one x run per thread");

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// kRun consecutive elements from src, of which the first n lie inside the
// tensor (zeros past them), widened to fp32; with vec, a whole run is one
// or two 16-byte loads.
template <typename T>
__device__ __forceinline__ void load_run(const T* src, int n, bool vec,
                                         float* dst);

template <>
__device__ __forceinline__ void load_run<__nv_bfloat16>(
    const __nv_bfloat16* src, int n, bool vec, float* dst) {
  if (vec && n >= kRun) {
    const uint4 raw = *reinterpret_cast<const uint4*>(src);
    const __nv_bfloat16* e = reinterpret_cast<const __nv_bfloat16*>(&raw);
#pragma unroll
    for (int i = 0; i < kRun; ++i) dst[i] = __bfloat162float(e[i]);
    return;
  }
#pragma unroll
  for (int i = 0; i < kRun; ++i)
    dst[i] = i < n ? __bfloat162float(src[i]) : 0.f;
}

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

}  // namespace

extern "C" {

// dtype: 0 fp32, 1 bf16 (x, w and out alike).  x [E, C, K], w [E, K, N]
// and out [E, C, N] contiguous; vec_x / vec_w: 1 when every row of x / w
// starts on a 16-byte boundary (K / N a multiple of 16 bytes' worth of
// elements and an aligned base), so whole runs move as vectors.  E, C and
// N must be > 0.  Returns cudaGetLastError() after the launch, or -1 for a
// bad dtype code.
int grouped_matmul_launch(int dtype, const void* x, const void* w, void* out,
                          int E, int C, int K, int N, int vec_x, int vec_w,
                          void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return launch<float>(x, w, out, E, C, K, N, vec_x, vec_w, s);
    case 1:
      return launch<__nv_bfloat16>(x, w, out, E, C, K, N, vec_x, vec_w, s);
    default:
      return -1;
  }
}

}  // extern "C"
