// Fused RMSNorm over the rows of x [rows, d] for Hopper (sm_90a):
//   y = x * rsqrt(mean(x^2) + eps) * scale     (scale + 1 if zero_centered)
// with the sum of squares and the products in fp32 and y in x's type.
//
// Replaces the Pallas TPU kernel rmsnorm_tpu (repro/kernels/rmsnorm.py:23).
// The port calls it for every norm of the attention-family LM (lm._norm:
// ln1, ln2, the post-norms and the final norm; lm._head_rms for qk-norm),
// for the Mamba2 layers' pre-norm and gated norm, and for the multimodal
// encoder's norms (nn.layers.apply_rmsnorm).
//
// What bounds it on an H100: bytes in principle, latency at the serving
// shapes.  It reads x once, writes y once and reads scale (d values,
// shared by every row, from L2); about 3 flops per element against the
// ~295 flops per byte where compute would take over.  At a decode tick
// ([8, 896] bf16, 14 KB) the bytes take 0.000009 ms, so the time is the
// launch and the chain of dependent memory round trips: one is the least.
//
// Design: one round trip.  A row is split over `tpr` threads (a power of
// two up to 256, chosen with `nv` by rmsnorm.py:plan from rows and d),
// each holding at most `nv` (1, 2, 4 or 8, a template argument) of the
// row's 16-byte vectors in registers: vectors t, t + tpr, ... of thread
// t.  Every thread issues its x loads and the scale loads of the same
// columns (16-byte vectors, or 8 bytes for fp32 x with a bf16 scale)
// before the reduction; the sum of squares is reduced over the row's
// lanes with xor shuffles and, past 32 threads a row, across its warps
// through shared memory in warp order (one barrier); y is then written
// from the registers.  No second read of x, no scalar scale loads (but
// for a scale that does not start on its vector's alignment, which no
// caller passes: then the same pass loads it scalar by scalar).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMinThreads = 128;  // threads per CTA (tpr past 128)
constexpr int kMaxThreads = 256;  // and the most threads a row

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

// The N scale values of columns c .. c + N - 1, widened: 16-byte (or, for
// N bf16 values in 8 bytes, 8-byte) vector loads when `vec`, else one
// value at a time.
template <int N, typename ST>
__device__ __forceinline__ void load_scale(const ST* __restrict__ scale,
                                           int c, bool vec, float* out) {
  constexpr int kBytes = N * static_cast<int>(sizeof(ST));
  if (vec) {
    if constexpr (kBytes >= 16) {
#pragma unroll
      for (int u = 0; u < kBytes / 16; ++u) {
        const uint4 raw = reinterpret_cast<const uint4*>(scale + c)[u];
        const ST* e = reinterpret_cast<const ST*>(&raw);
#pragma unroll
        for (int i = 0; i < 16 / static_cast<int>(sizeof(ST)); ++i)
          out[u * (16 / sizeof(ST)) + i] = to_float(e[i]);
      }
    } else {
      const uint2 raw = *reinterpret_cast<const uint2*>(scale + c);
      const ST* e = reinterpret_cast<const ST*>(&raw);
#pragma unroll
      for (int i = 0; i < N; ++i) out[i] = to_float(e[i]);
    }
  } else {
#pragma unroll
    for (int i = 0; i < N; ++i) out[i] = to_float(scale[c + i]);
  }
}

template <typename T, typename ST, int NV>
__global__ void __launch_bounds__(kMaxThreads) rmsnorm_kernel(
    const T* __restrict__ x, const ST* __restrict__ scale, T* __restrict__ y,
    int rows, int d, float eps, int zero_centered, int tpr) {
  constexpr int kVec = Vec<T>::kVec;
  __shared__ float part[kMaxThreads / 32];
  const int tid = threadIdx.x, lane = tid & 31;
  const int t = tid % tpr;  // this thread's place in its row
  const int row = blockIdx.x * (blockDim.x / tpr) + tid / tpr;
  const bool live = row < rows;  // a dead row's threads still reduce
  const Vec<T>* xr =
      reinterpret_cast<const Vec<T>*>(x + static_cast<size_t>(row) * d);
  Vec<T>* yr = reinterpret_cast<Vec<T>*>(y + static_cast<size_t>(row) * d);
  const int nvec = d / kVec;
  constexpr int kAlign = kVec * sizeof(ST) < 16 ? kVec * sizeof(ST) : 16;
  const bool vec = reinterpret_cast<uintptr_t>(scale) % kAlign == 0;

  Vec<T> a[NV];
  float s[NV][kVec];
#pragma unroll
  for (int j = 0; j < NV; ++j) {
    const int i = t + j * tpr;
    if (live && i < nvec) {
      a[j] = xr[i];
      load_scale<kVec>(scale, i * kVec, vec, s[j]);
    }
  }
  float ss = 0.f;
#pragma unroll
  for (int j = 0; j < NV; ++j) {
    if (live && t + j * tpr < nvec) {
#pragma unroll
      for (int e = 0; e < kVec; ++e) {
        const float f = to_float(a[j].v[e]);
        ss = fmaf(f, f, ss);
      }
    }
  }
  for (int off = min(tpr, 32) / 2; off > 0; off >>= 1)
    ss += __shfl_xor_sync(0xffffffffu, ss, off);
  if (tpr > 32) {  // the row's warps, in warp order
    const int warps = tpr / 32, first = (tid / tpr) * warps;
    if (lane == 0) part[tid / 32] = ss;
    __syncthreads();
    ss = 0.f;
    for (int w = 0; w < warps; ++w) ss += part[first + w];
  }
  const float r = rsqrtf(ss / static_cast<float>(d) + eps);
  const float shift = zero_centered ? 1.f : 0.f;
#pragma unroll
  for (int j = 0; j < NV; ++j) {
    const int i = t + j * tpr;
    if (live && i < nvec) {
      Vec<T> o;
#pragma unroll
      for (int e = 0; e < kVec; ++e)  // the plain version's order
        o.v[e] =
            from_float<T>(to_float(a[j].v[e]) * r * (s[j][e] + shift));
      yr[i] = o;
    }
  }
}

template <typename T, typename ST>
int launch(const void* x, const void* scale, void* y, int rows, int d,
           float eps, int zero_centered, int nv, int tpr,
           cudaStream_t stream) {
  if (tpr < 1 || tpr > kMaxThreads || (tpr & (tpr - 1)) ||
      static_cast<long>(nv) * tpr * Vec<T>::kVec < d)
    return -2;
  const int threads = tpr > kMinThreads ? tpr : kMinThreads;
  const dim3 grid((rows + threads / tpr - 1) / (threads / tpr));
  const T* xp = static_cast<const T*>(x);
  const ST* sp = static_cast<const ST*>(scale);
  T* yp = static_cast<T*>(y);
  switch (nv) {
#define RMSNORM_NV(n)                                                    \
  case n:                                                                \
    rmsnorm_kernel<T, ST, n><<<grid, threads, 0, stream>>>(              \
        xp, sp, yp, rows, d, eps, zero_centered, tpr);                   \
    break;
    RMSNORM_NV(1)
    RMSNORM_NV(2)
    RMSNORM_NV(4)
    RMSNORM_NV(8)
#undef RMSNORM_NV
    default:
      return -2;
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_scale(int scale_dtype, const void* x, const void* scale, void* y,
                 int rows, int d, float eps, int zero_centered, int nv,
                 int tpr, cudaStream_t stream) {
  switch (scale_dtype) {
    case 0:
      return launch<T, float>(x, scale, y, rows, d, eps, zero_centered, nv,
                              tpr, stream);
    case 1:
      return launch<T, __nv_bfloat16>(x, scale, y, rows, d, eps,
                                      zero_centered, nv, tpr, stream);
    default:
      return -1;
  }
}

}  // namespace

extern "C" {

// x, y [rows, d] contiguous and 16-byte aligned, x_dtype: 0 fp32, 1 bf16
// (y has x's type), d a multiple of 16 / sizeof(x's type); scale [d],
// scale_dtype: 0 fp32, 1 bf16.  A row is split over tpr threads (a power
// of two, at most 256), each holding at most nv (1, 2, 4 or 8) of its
// 16-byte vectors: nv * tpr vectors must cover the row.  Returns
// cudaGetLastError() after the launch, -1 for a bad dtype code, -2 for a
// bad nv or tpr.
int rmsnorm_launch(int x_dtype, int scale_dtype, const void* x,
                   const void* scale, void* y, int rows, int d, float eps,
                   int zero_centered, int nv, int tpr, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (x_dtype) {
    case 0:
      return launch_scale<float>(scale_dtype, x, scale, y, rows, d, eps,
                                 zero_centered, nv, tpr, s);
    case 1:
      return launch_scale<__nv_bfloat16>(scale_dtype, x, scale, y, rows, d,
                                         eps, zero_centered, nv, tpr, s);
    default:
      return -1;
  }
}

}  // extern "C"
