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
// [8192, 896] bf16 moves 44 MB, 0.013 ms at 3.35 TB/s.
//
// Design: rows in registers, one pass over HBM.  A persistent grid of
// 256-thread CTAs (rmsnorm.py:bwd_plan: two an SM, no more than row
// groups) cuts the rows into contiguous ranges of the same size, one a
// CTA.  A row is split over `tpr` threads (a power of two), each holding
// at most NV (1, 2, 4, 8; a template argument) of its 16-byte vectors,
// vectors t, t + tpr, ..., so a CTA holds a group of 256 / tpr rows at
// once (several rows a warp for narrow rows).  Each thread copies its own
// vectors of x and g by cp.async into its own slots of a two-stage
// shared-memory ring, the next group's in flight while it reduces the
// current one; it reads them back into registers, reduces sum(x^2) and
// sum(g s x) over the row's lanes with xor shuffles and, past 32 threads
// a row, across the row's warps through shared memory in warp order (one
// barrier a group, double-buffered), and writes dx from its registers: x
// and g are read from HBM once, and no barrier orders the ring.  Its
// columns are the same on every row it walks, so it sums g x^ for them in
// fp32 registers; the CTA's row slots are then summed in slot order into
// its row of a [grid, d] fp32 scratch.  The scale (+ 1), widened, sits in
// shared memory laid out so that each thread reads whole float4s and a
// warp's reads fall on distinct banks; where a thread holds at most 16
// values, g s stays in registers between the two passes.  dscale: a
// second kernel, one CTA an 8-column slice, each column's 32 threads
// summing every 32nd partial in order, then an xor tree of the 32 (the
// same sum in the rows kernel after a grid-wide barrier of a cooperative
// launch, one launch a call, was no faster by device time:
// scripts/bwd_kernel_variants.py times the two).  No
// atomics: the grid and every summation order come from the shapes alone,
// so two calls give the same bits.  Rows wider than 8 vectors x 256
// threads take the first version (rmsnorm_bwd_launch_first, chosen by
// rmsnorm.py:bwd_variant): one warp a row, two walks, a [warps, d] shared
// accumulator, its partials summed by a second kernel in block order.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "tc_bf16.cuh"

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

// ------------------------------------------- backward, the first version

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

// ------------------------------------------------------------- backward

constexpr int kBwdThreads = 256;  // threads a CTA of the backward
constexpr int kBwdWarps = kBwdThreads / 32;
constexpr int kStages = 2;  // row groups in a thread's ring
constexpr int kSlice = kBwdWarps;  // dscale columns a slice of the sum
constexpr int kSegments = 32;      // threads a column: a warp
static_assert(kSlice * kSegments == kBwdThreads, "a CTA sums one slice");
constexpr int kFill = 16;  // scale values a thread loads at once

// The thread's 16-byte vectors t, t + tpr, ... of x and g of one row into
// its own slots of a ring stage, [vector j][x, g][thread], by cp.async;
// nothing for a dead row or past the row.  One commit group a call.
template <typename T, int NV>
__device__ __forceinline__ void issue_row(const T* __restrict__ x,
                                          const T* __restrict__ dy,
                                          size_t base, bool live, int nvec,
                                          int t, int tpr, uint4* stage) {
  const uint4* xr = reinterpret_cast<const uint4*>(x + base);
  const uint4* gr = reinterpret_cast<const uint4*>(dy + base);
#pragma unroll
  for (int j = 0; j < NV; ++j) {
    const int i = t + j * tpr;
    if (live && i < nvec) {
      tc::cp_async16(stage + (2 * j) * kBwdThreads + threadIdx.x, xr + i, 16);
      tc::cp_async16(stage + (2 * j + 1) * kBwdThreads + threadIdx.x, gr + i,
                     16);
    }
  }
  tc::cp_async_commit();  // an empty group keeps the count
}

// kVec fp32 values as one 16-byte vector of T (bf16 rounded in pairs).
template <typename T>
__device__ __forceinline__ Vec<T> to_vec(const float (&v)[Vec<T>::kVec]) {
  Vec<T> o;
  if constexpr (sizeof(T) == 2) {
    __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(o.v);
#pragma unroll
    for (int p = 0; p < Vec<T>::kVec / 2; ++p)
      h[p] = __floats2bfloat162_rn(v[2 * p], v[2 * p + 1]);
  } else {
#pragma unroll
    for (int e = 0; e < Vec<T>::kVec; ++e) o.v[e] = v[e];
  }
  return o;
}

// The widened scale (+ 1) of vector i's kVec columns from shared memory,
// laid out [kVec / 4][nvec] float4s so that a warp's lanes (consecutive i)
// read consecutive float4s.
template <int kVec>
__device__ __forceinline__ void scale_of(const float4* __restrict__ s4,
                                         int nvec, int i, float (&s)[kVec]) {
#pragma unroll
  for (int h = 0; h < kVec / 4; ++h) {
    const float4 v = s4[h * nvec + i];
    s[4 * h] = v.x;
    s[4 * h + 1] = v.y;
    s[4 * h + 2] = v.z;
    s[4 * h + 3] = v.w;
  }
}

// dscale of the kSlice columns of slice u from the grid's partials:
// thread (segment q, column c) sums partials q, q + kSegments, ... of its
// column in order; warp w then combines column w's kSegments sums with an
// xor tree (offsets 16, 8, 4, 2, 1).
template <typename ST>
__device__ __forceinline__ void sum_slice(const float* partial,
                                          ST* __restrict__ dscale, int grid,
                                          int d, int u, float* seg) {
  const int col = threadIdx.x % kSlice, q = threadIdx.x / kSlice;
  const int c = u * kSlice + col;
  float t = 0.f;
  if (c < d) {
    for (int g0 = q; g0 < grid; g0 += 8 * kSegments) {
      float v[8];
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        const int g = g0 + k * kSegments;
        v[k] = g < grid ? partial[static_cast<size_t>(g) * d + c] : 0.f;
      }
#pragma unroll
      for (int k = 0; k < 8; ++k) t += v[k];
    }
  }
  seg[q * (kSlice + 1) + col] = t;
  __syncthreads();
  const int w = threadIdx.x / 32, lane = threadIdx.x & 31;
  float v = seg[lane * (kSlice + 1) + w];
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  if (lane == 0 && u * kSlice + w < d)
    dscale[u * kSlice + w] = from_float<ST>(v);
  __syncthreads();  // seg is reused by the next slice
}

template <typename T, typename ST, int NV>
__global__ void __launch_bounds__(kBwdThreads, NV <= 4 ? 2 : 1)
    rmsnorm_bwd_rows(const T* __restrict__ x, const ST* __restrict__ scale,
                     const T* __restrict__ dy, T* __restrict__ dx,
                     float* partial, ST* __restrict__ dscale, int rows,
                     int d, float eps, int zero_centered, int tpr) {
  constexpr int kVec = Vec<T>::kVec;
  constexpr bool kKeepGs = NV * kVec <= 16;
  extern __shared__ __align__(16) float sm[];
  __shared__ float red[2][2][kBwdWarps];  // a group's (ss, gsx) by warp
  const int tid = threadIdx.x, lane = tid & 31, warp = tid / 32;
  const int R = kBwdThreads / tpr;  // rows a group
  const int slot = tid / tpr, t = tid % tpr;
  const int nvec = d / kVec;
  const int used = (nvec + tpr - 1) / tpr;  // vectors a thread at most
  const float shift = zero_centered ? 1.f : 0.f;
  // [kStages][used][x, g][kBwdThreads] uint4, then the scale
  uint4* ring = reinterpret_cast<uint4*>(sm);
  const int stage_vecs = used * 2 * kBwdThreads;
  float* s_sh = sm + kStages * stage_vecs * 4;  // [kVec / 4][nvec][4]
  const int lo = static_cast<int>(static_cast<long long>(blockIdx.x) * rows /
                                  gridDim.x);
  const int hi = static_cast<int>(
      static_cast<long long>(blockIdx.x + 1) * rows / gridDim.x);
  const int groups = (hi - lo + R - 1) / R;
#pragma unroll
  for (int k = 0; k < kStages; ++k) {
    const int row = lo + k * R + slot;
    issue_row<T, NV>(x, dy, static_cast<size_t>(row) * d, row < hi, nvec, t,
                     tpr, ring + k * stage_vecs);
  }
  for (int c0 = tid; c0 < d; c0 += kFill * kBwdThreads) {
    float v[kFill];  // every load issued before the first store
#pragma unroll
    for (int u = 0; u < kFill; ++u) {
      const int c = c0 + u * kBwdThreads;
      v[u] = c < d ? to_float(scale[c]) + shift : 0.f;
    }
#pragma unroll
    for (int u = 0; u < kFill; ++u) {
      const int c = c0 + u * kBwdThreads, i = c / kVec, e = c % kVec;
      if (c < d) s_sh[((e / 4) * nvec + i) * 4 + e % 4] = v[u];
    }
  }
  const float4* s4 = reinterpret_cast<const float4*>(s_sh);
  float acc[NV][kVec];
#pragma unroll
  for (int j = 0; j < NV; ++j)
#pragma unroll
    for (int e = 0; e < kVec; ++e) acc[j][e] = 0.f;
  __syncthreads();  // s_sh

  for (int k = 0; k < groups; ++k) {
    const int row = lo + k * R + slot;
    const bool live = row < hi;
    uint4* stage = ring + (k % kStages) * stage_vecs;
    tc::cp_async_wait<kStages - 1>();  // group k has landed
    Vec<T> xa[NV], ga[NV];
    float gs[kKeepGs ? NV : 1][kVec];  // g s, kept for the second pass
    float ss = 0.f, gsx = 0.f;
#pragma unroll
    for (int j = 0; j < NV; ++j) {
      const int i = t + j * tpr;
      if (live && i < nvec) {
        *reinterpret_cast<uint4*>(&xa[j]) =
            stage[(2 * j) * kBwdThreads + tid];
        *reinterpret_cast<uint4*>(&ga[j]) =
            stage[(2 * j + 1) * kBwdThreads + tid];
        float s[kVec];
        scale_of<kVec>(s4, nvec, i, s);
#pragma unroll
        for (int e = 0; e < kVec; ++e) {
          const float xf = to_float(xa[j].v[e]);
          const float q = to_float(ga[j].v[e]) * s[e];
          if constexpr (kKeepGs) gs[j][e] = q;
          ss = fmaf(xf, xf, ss);
          gsx = fmaf(q, xf, gsx);
        }
      }
    }
    {  // group k + kStages into the slots just read (their values are used)
      const int next = row + kStages * R;
      issue_row<T, NV>(x, dy, static_cast<size_t>(next) * d, next < hi, nvec,
                       t, tpr, stage);
    }
    for (int off = min(tpr, 32) / 2; off > 0; off >>= 1) {
      ss += __shfl_xor_sync(0xffffffffu, ss, off);
      gsx += __shfl_xor_sync(0xffffffffu, gsx, off);
    }
    if (tpr > 32) {  // the row's warps, in warp order
      const int wpr = tpr / 32, first = slot * wpr;
      if (lane == 0) {
        red[k & 1][0][warp] = ss;
        red[k & 1][1][warp] = gsx;
      }
      __syncthreads();
      ss = gsx = 0.f;
      for (int w = 0; w < wpr; ++w) {
        ss += red[k & 1][0][first + w];
        gsx += red[k & 1][1][first + w];
      }
    }
    const float r = rsqrtf(ss / static_cast<float>(d) + eps);
    const float coef = r * r * r * gsx / static_cast<float>(d);
    Vec<T>* out = reinterpret_cast<Vec<T>*>(dx + static_cast<size_t>(row) * d);
#pragma unroll
    for (int j = 0; j < NV; ++j) {
      const int i = t + j * tpr;
      if (live && i < nvec) {
        float q[kVec];  // g s
        if constexpr (kKeepGs) {
#pragma unroll
          for (int e = 0; e < kVec; ++e) q[e] = gs[j][e];
        } else {  // again: the registers hold no copy
          float s[kVec];
          scale_of<kVec>(s4, nvec, i, s);
#pragma unroll
          for (int e = 0; e < kVec; ++e) q[e] = to_float(ga[j].v[e]) * s[e];
        }
        float o[kVec];
#pragma unroll
        for (int e = 0; e < kVec; ++e) {
          const float xf = to_float(xa[j].v[e]);
          o[e] = r * q[e] - xf * coef;
          acc[j][e] = fmaf(to_float(ga[j].v[e]), xf * r, acc[j][e]);
        }
        out[i] = to_vec<T>(o);
      }
    }
  }
  tc::cp_async_wait<0>();  // the ring's last (empty) groups

  // the CTA's partial: one row slot's sums as they are, in whole float4s
  // (the wide rows' case, where a pass through shared memory showed on the
  // card), or the slots summed in slot order through shared memory (the
  // ring's space)
  float* mine = partial + static_cast<size_t>(blockIdx.x) * d;
  if (R == 1) {
#pragma unroll
    for (int j = 0; j < NV; ++j) {
      const int i = t + j * tpr;
      if (i < nvec) {
#pragma unroll
        for (int h = 0; h < kVec / 4; ++h)
          reinterpret_cast<float4*>(mine + i * kVec)[h] =
              make_float4(acc[j][4 * h], acc[j][4 * h + 1],
                          acc[j][4 * h + 2], acc[j][4 * h + 3]);
      }
    }
  } else {
    float* slots = sm;  // [R][d]
    __syncthreads();
#pragma unroll
    for (int j = 0; j < NV; ++j) {
      const int i = t + j * tpr;
      if (i < nvec) {
#pragma unroll
        for (int e = 0; e < kVec; ++e)
          slots[slot * d + i * kVec + e] = acc[j][e];
      }
    }
    __syncthreads();
    for (int c = tid; c < d; c += kBwdThreads) {
      float v = 0.f;
#pragma unroll 8
      for (int q = 0; q < R; ++q) v += slots[q * d + c];
      mine[c] = v;
    }
  }
  // dscale is rmsnorm_bwd_dscale's, from every CTA's partial
}

// dscale of slice blockIdx.x from the grid's partials.
template <typename ST>
__global__ void __launch_bounds__(kBwdThreads) rmsnorm_bwd_dscale(
    const float* __restrict__ partial, ST* __restrict__ dscale, int grid,
    int d) {
  __shared__ float seg[kSegments * (kSlice + 1)];
  sum_slice<ST>(partial, dscale, grid, d, blockIdx.x, seg);
}

template <typename T, typename ST, int NV>
int launch_bwd_rows(const void* x, const void* scale, const void* dy,
                    void* dx, float* partial, void* dscale, int rows, int d,
                    float eps, int zero_centered, int grid, int tpr,
                    cudaStream_t stream) {
  // the ring of kStages groups of `used` vectors of x and g a thread,
  // then the scale
  const int used = (d / Vec<T>::kVec + tpr - 1) / tpr;
  const size_t smem = static_cast<size_t>(kStages) * used * 2 * kBwdThreads *
                          sizeof(uint4) +
                      static_cast<size_t>(d) * sizeof(float);
  auto kernel = rmsnorm_bwd_rows<T, ST, NV>;
  if (smem > 40 * 1024) {  // past 48 KB with the static arrays: opt in
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const T* xp = static_cast<const T*>(x);
  const ST* sp = static_cast<const ST*>(scale);
  const T* gp = static_cast<const T*>(dy);
  T* dxp = static_cast<T*>(dx);
  ST* dsp = static_cast<ST*>(dscale);
  kernel<<<grid, kBwdThreads, smem, stream>>>(xp, sp, gp, dxp, partial, dsp,
                                              rows, d, eps, zero_centered,
                                              tpr);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  rmsnorm_bwd_dscale<ST><<<(d + kSlice - 1) / kSlice, kBwdThreads, 0,
                           stream>>>(partial, dsp, grid, d);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, typename ST>
int launch_bwd_plan(const void* x, const void* scale, const void* dy,
                    void* dx, float* partial, void* dscale, int rows, int d,
                    float eps, int zero_centered, int grid, int tpr,
                    int in_flight, int nv, cudaStream_t stream) {
  if (grid < 1 || tpr < 1 || tpr > kBwdThreads || (tpr & (tpr - 1)) ||
      in_flight * tpr != kBwdThreads ||
      static_cast<long>(nv) * tpr * Vec<T>::kVec < d)
    return -2;
  switch (nv) {
#define RMSNORM_BWD_NV(n)                                                   \
  case n:                                                                   \
    return launch_bwd_rows<T, ST, n>(x, scale, dy, dx, partial, dscale,     \
                                     rows, d, eps, zero_centered, grid, tpr, \
                                     stream);
    RMSNORM_BWD_NV(1)
    RMSNORM_BWD_NV(2)
    RMSNORM_BWD_NV(4)
    RMSNORM_BWD_NV(8)
#undef RMSNORM_BWD_NV
    default:
      return -2;
  }
}

template <typename T>
int launch_bwd_plan_scale(int scale_dtype, const void* x, const void* scale,
                          const void* dy, void* dx, float* partial,
                          void* dscale, int rows, int d, float eps,
                          int zero_centered, int grid, int tpr,
                          int in_flight, int nv, cudaStream_t stream) {
  switch (scale_dtype) {
    case 0:
      return launch_bwd_plan<T, float>(x, scale, dy, dx, partial, dscale,
                                       rows, d, eps, zero_centered, grid,
                                       tpr, in_flight, nv, stream);
    case 1:
      return launch_bwd_plan<T, __nv_bfloat16>(
          x, scale, dy, dx, partial, dscale, rows, d, eps, zero_centered,
          grid, tpr, in_flight, nv, stream);
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
// the forward's; partial [grid, d] fp32 scratch.  `grid` CTAs of 256
// threads: a row over `tpr` threads (a power of two up to 256),
// `in_flight` = 256 / tpr rows a CTA at once, at most `nv` (1, 2, 4 or 8)
// 16-byte vectors a thread, nv * tpr vectors covering a row.  Two kernels
// on `stream` (the rows, then dscale from the partials); returns the first
// launch error, -1 for a bad dtype code, -2 for a plan it cannot run.
int rmsnorm_bwd_launch(int x_dtype, int scale_dtype, const void* x,
                       const void* scale, const void* dy, void* dx,
                       void* partial, void* dscale, int rows, int d,
                       float eps, int zero_centered, int grid, int tpr,
                       int in_flight, int nv, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* pp = static_cast<float*>(partial);
  switch (x_dtype) {
    case 0:
      return launch_bwd_plan_scale<float>(scale_dtype, x, scale, dy, dx, pp,
                                          dscale, rows, d, eps,
                                          zero_centered, grid, tpr,
                                          in_flight, nv, s);
    case 1:
      return launch_bwd_plan_scale<__nv_bfloat16>(
          scale_dtype, x, scale, dy, dx, pp, dscale, rows, d, eps,
          zero_centered, grid, tpr, in_flight, nv, s);
    default:
      return -1;
  }
}

// The first version of the backward (rows wider than the register design
// takes; phase 4's parent): the same tensors, partial [blocks, d] fp32
// scratch.  `blocks` CTAs of `warps` warps (1-8), one warp a row; (warps +
// 1) d floats of shared memory a CTA.  Two kernels on `stream`; returns
// cudaGetLastError() after each (the first failure), -1 for a bad dtype
// code, -2 for a bad warps or blocks.
int rmsnorm_bwd_launch_first(int x_dtype, int scale_dtype, const void* x,
                             const void* scale, const void* dy, void* dx,
                             void* partial, void* dscale, int rows, int d,
                             float eps, int zero_centered, int blocks,
                             int warps, void* stream) {
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
