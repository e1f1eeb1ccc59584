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
//
// The backward (rmsnorm_bwd_launch) replaces no Pallas kernel: the JAX
// package differentiates lm._norm and _head_rms with XLA's autodiff.  With
// r = rsqrt(mean(x^2) + eps), s = scale (+ 1 when zero-centred) and the
// output's gradient g:
//   dx = r (g s - x^ mean(g s x^)) = r g s - x r^3 sum(g s x) / d,
//   dscale = sum over rows of g x^,  x^ = x r,
// in fp32, dx cast to x's type and dscale to the scale's.  Bytes bound it
// (x and g read, dx written; ~10 flops per element): qwen2-0.5b's
// [8192, 896] bf16 moves 44 MB, 0.013 ms at 3.35 TB/s.  One warp a row:
// a first walk over the row's 16-byte vectors sums x^2 and g s x (the xor
// tree of the warp), a second (from L1) writes dx and adds g x^ into the
// warp's own row of a shared [warps, d] accumulator; the CTA then sums its
// warps in warp order into its row of a [blocks, d] fp32 scratch, and a
// second kernel sums the blocks in block order into dscale.  No atomics:
// the grid comes from the shapes alone (rmsnorm.py:bwd_plan), so two calls
// give the same bits.
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

// ------------------------------------------------------------- backward

template <typename T, typename ST>
__global__ void __launch_bounds__(kMaxThreads) rmsnorm_bwd_kernel(
    const T* __restrict__ x, const ST* __restrict__ scale,
    const T* __restrict__ dy, T* __restrict__ dx, float* __restrict__ partial,
    int rows, int d, float eps, int zero_centered) {
  constexpr int kVec = Vec<T>::kVec;
  extern __shared__ __align__(16) float sm[];
  const int warps = blockDim.x / 32, warp = threadIdx.x / 32;
  const int lane = threadIdx.x & 31;
  float* acc = sm;               // [warps][d]: each warp's sum of g x^
  float* s_sh = sm + warps * d;  // [d]: the scale (+ 1), widened
  const float shift = zero_centered ? 1.f : 0.f;
  for (int c = threadIdx.x; c < warps * d; c += blockDim.x) acc[c] = 0.f;
  for (int c = threadIdx.x; c < d; c += blockDim.x)
    s_sh[c] = to_float(scale[c]) + shift;
  __syncthreads();
  const int nvec = d / kVec;
  float* mine = acc + warp * d;
  for (int row = blockIdx.x * warps + warp; row < rows;
       row += gridDim.x * warps) {
    const Vec<T>* xr =
        reinterpret_cast<const Vec<T>*>(x + static_cast<size_t>(row) * d);
    const Vec<T>* gr =
        reinterpret_cast<const Vec<T>*>(dy + static_cast<size_t>(row) * d);
    float ss = 0.f, gsx = 0.f;
    for (int i = lane; i < nvec; i += 32) {
      const Vec<T> a = xr[i], g = gr[i];
#pragma unroll
      for (int e = 0; e < kVec; ++e) {
        const float xf = to_float(a.v[e]);
        ss = fmaf(xf, xf, ss);
        gsx = fmaf(to_float(g.v[e]) * s_sh[i * kVec + e], xf, gsx);
      }
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      ss += __shfl_xor_sync(0xffffffffu, ss, off);
      gsx += __shfl_xor_sync(0xffffffffu, gsx, off);
    }
    const float r = rsqrtf(ss / static_cast<float>(d) + eps);
    const float coef = r * r * r * gsx / static_cast<float>(d);
    Vec<T>* out =
        reinterpret_cast<Vec<T>*>(dx + static_cast<size_t>(row) * d);
    for (int i = lane; i < nvec; i += 32) {
      const Vec<T> a = xr[i], g = gr[i];
      Vec<T> o;
#pragma unroll
      for (int e = 0; e < kVec; ++e) {
        const int c = i * kVec + e;
        const float xf = to_float(a.v[e]), gf = to_float(g.v[e]);
        o.v[e] = from_float<T>(r * (gf * s_sh[c]) - xf * coef);
        mine[c] = fmaf(gf, xf * r, mine[c]);
      }
      out[i] = o;
    }
  }
  __syncthreads();
  for (int c = threadIdx.x; c < d; c += blockDim.x) {
    float t = 0.f;
    for (int w = 0; w < warps; ++w) t += acc[w * d + c];
    partial[static_cast<size_t>(blockIdx.x) * d + c] = t;
  }
}

// dscale[c] = the blocks' partials summed in block order.
template <typename ST>
__global__ void __launch_bounds__(kMaxThreads) rmsnorm_bwd_scale(
    const float* __restrict__ partial, ST* __restrict__ dscale, int blocks,
    int d) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= d) return;
  float t = 0.f;
  for (int b = 0; b < blocks; ++b) t += partial[static_cast<size_t>(b) * d + c];
  dscale[c] = from_float<ST>(t);
}

template <typename T, typename ST>
int launch_bwd(const void* x, const void* scale, const void* dy, void* dx,
               float* partial, void* dscale, int rows, int d, float eps,
               int zero_centered, int blocks, int warps,
               cudaStream_t stream) {
  if (warps < 1 || warps > kMaxThreads / 32 || blocks < 1) return -2;
  const int bytes = (warps + 1) * d * static_cast<int>(sizeof(float));
  auto kernel = rmsnorm_bwd_kernel<T, ST>;
  if (bytes > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  kernel<<<blocks, warps * 32, bytes, stream>>>(
      static_cast<const T*>(x), static_cast<const ST*>(scale),
      static_cast<const T*>(dy), static_cast<T*>(dx), partial, rows, d, eps,
      zero_centered);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  rmsnorm_bwd_scale<ST><<<(d + kMinThreads - 1) / kMinThreads, kMinThreads,
                          0, stream>>>(partial, static_cast<ST*>(dscale),
                                       blocks, d);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_bwd_scale(int scale_dtype, const void* x, const void* scale,
                     const void* dy, void* dx, float* partial, void* dscale,
                     int rows, int d, float eps, int zero_centered,
                     int blocks, int warps, cudaStream_t stream) {
  switch (scale_dtype) {
    case 0:
      return launch_bwd<T, float>(x, scale, dy, dx, partial, dscale, rows, d,
                                  eps, zero_centered, blocks, warps, stream);
    case 1:
      return launch_bwd<T, __nv_bfloat16>(x, scale, dy, dx, partial, dscale,
                                          rows, d, eps, zero_centered,
                                          blocks, warps, stream);
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


// The backward: x, dy, dx [rows, d] (x's type, x_dtype 0 fp32 / 1 bf16),
// scale and dscale [d] (scale_dtype), contiguous and 16-byte aligned as
// the forward's; partial [blocks, d] fp32 scratch.  `blocks` CTAs of
// `warps` warps (1-8), one warp a row; (warps + 1) d floats of shared
// memory a CTA.  Two kernels on `stream`; returns cudaGetLastError() after
// each (the first failure), -1 for a bad dtype code, -2 for a bad warps
// or blocks.
int rmsnorm_bwd_launch(int x_dtype, int scale_dtype, const void* x,
                       const void* scale, const void* dy, void* dx,
                       void* partial, void* dscale, int rows, int d,
                       float eps, int zero_centered, int blocks, int warps,
                       void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* pp = static_cast<float*>(partial);
  switch (x_dtype) {
    case 0:
      return launch_bwd_scale<float>(scale_dtype, x, scale, dy, dx, pp,
                                     dscale, rows, d, eps, zero_centered,
                                     blocks, warps, s);
    case 1:
      return launch_bwd_scale<__nv_bfloat16>(scale_dtype, x, scale, dy, dx,
                                             pp, dscale, rows, d, eps,
                                             zero_centered, blocks, warps, s);
    default:
      return -1;
  }
}

}  // extern "C"
