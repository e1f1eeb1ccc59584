// Fused RMSNorm over the rows of x [rows, d] for Hopper (sm_90a):
//   y = x * rsqrt(mean(x^2) + eps) * scale     (scale + 1 if zero_centered)
// with the sum of squares and the products in fp32 and y in x's type.
//
// Replaces the Pallas TPU kernel rmsnorm_tpu (repro/kernels/rmsnorm.py:23).
// The port calls it for every norm of the attention-family LM (lm._norm:
// ln1, ln2, the post-norms and the final norm; lm._head_rms for qk-norm)
// and for the multimodal encoder's norms (nn.layers.apply_rmsnorm).
//
// What bounds it on an H100: bytes.  It reads x once, writes y once and
// reads scale (d values, shared by every row, from L2); about 3 flops per
// element against the ~295 flops per byte where compute would take over.
// At the serving shapes ([8, 896] per decode tick, [64, 896] per prefill
// chunk: 14 KB and 115 KB of bf16) it moves too few bytes to approach the
// 3.35 TB/s rate, and the launch itself sets its time; what it saves is
// the eight or so launches of the unfused version (cast, square, mean,
// add, rsqrt, two products, cast back) and their fp32 temporaries.
//
// Design: one warp per row, kWarps rows per CTA.  Each lane reads its
// share of the row in 16-byte vectors (8 bf16 or 4 fp32 values: every
// width the port normalizes is a multiple of 8); the sum of squares is
// reduced across the warp with shuffles in fp32.  A second pass over the
// row (from L1: a row is a few KB) writes y with the same vectors.  No
// shared memory, no block-wide barrier.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 4;  // rows per CTA
constexpr int kThreads = 32 * kWarps;

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

// kVec values of a row in one 16-byte access.
template <typename T>
struct alignas(16) Vec {
  static constexpr int kVec = 16 / sizeof(T);
  T v[kVec];
};

template <typename T, typename ST>
__global__ void __launch_bounds__(kThreads) rmsnorm_kernel(
    const T* __restrict__ x, const ST* __restrict__ scale, T* __restrict__ y,
    int rows, int d, float eps, int zero_centered) {
  constexpr int kVec = Vec<T>::kVec;
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (row >= rows) return;  // whole warps leave together
  const Vec<T>* xr =
      reinterpret_cast<const Vec<T>*>(x + static_cast<size_t>(row) * d);
  Vec<T>* yr = reinterpret_cast<Vec<T>*>(y + static_cast<size_t>(row) * d);
  const int nvec = d / kVec;

  float ss = 0.f;
  for (int i = lane; i < nvec; i += 32) {
    const Vec<T> a = xr[i];
#pragma unroll
    for (int j = 0; j < kVec; ++j) {
      const float f = to_float(a.v[j]);
      ss = fmaf(f, f, ss);
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    ss += __shfl_xor_sync(0xffffffffu, ss, off);
  const float r = rsqrtf(ss / static_cast<float>(d) + eps);
  const float shift = zero_centered ? 1.f : 0.f;

  for (int i = lane; i < nvec; i += 32) {
    Vec<T> a = xr[i];
#pragma unroll
    for (int j = 0; j < kVec; ++j) {
      const float s = to_float(scale[i * kVec + j]) + shift;
      // the plain version's order: (x * rsqrt) * scale
      a.v[j] = from_float<T>(to_float(a.v[j]) * r * s);
    }
    yr[i] = a;
  }
}

template <typename T, typename ST>
int launch(const void* x, const void* scale, void* y, int rows, int d,
           float eps, int zero_centered, cudaStream_t stream) {
  const dim3 grid((rows + kWarps - 1) / kWarps);
  rmsnorm_kernel<T, ST><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const ST*>(scale),
      static_cast<T*>(y), rows, d, eps, zero_centered);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_scale(int scale_dtype, const void* x, const void* scale, void* y,
                 int rows, int d, float eps, int zero_centered,
                 cudaStream_t stream) {
  switch (scale_dtype) {
    case 0:
      return launch<T, float>(x, scale, y, rows, d, eps, zero_centered,
                              stream);
    case 1:
      return launch<T, __nv_bfloat16>(x, scale, y, rows, d, eps,
                                      zero_centered, stream);
    default:
      return -1;
  }
}

}  // namespace

extern "C" {

// x, y [rows, d] contiguous and 16-byte aligned, x_dtype: 0 fp32, 1 bf16
// (y has x's type), d a multiple of 16 / sizeof(x's type); scale [d],
// scale_dtype: 0 fp32, 1 bf16.  Returns cudaGetLastError() after the
// launch, or -1 for a bad dtype code.
int rmsnorm_launch(int x_dtype, int scale_dtype, const void* x,
                   const void* scale, void* y, int rows, int d, float eps,
                   int zero_centered, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (x_dtype) {
    case 0:
      return launch_scale<float>(scale_dtype, x, scale, y, rows, d, eps,
                                 zero_centered, s);
    case 1:
      return launch_scale<__nv_bfloat16>(scale_dtype, x, scale, y, rows, d,
                                         eps, zero_centered, s);
    default:
      return -1;
  }
}

// Rows one CTA normalizes.
int rmsnorm_rows_per_cta() { return kWarps; }

}  // extern "C"
