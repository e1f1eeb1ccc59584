// Paged decode attention for Hopper (sm_90a): one query token per slot
// against a paged K/V pool addressed through a block table.
//
// Replaces the Pallas TPU kernels paged_decode_tpu and
// paged_decode_quant_tpu (repro/kernels/paged_decode.py:92,137).  One
// source covers both: the page type is a template parameter (bf16 pages,
// or int8 pages with fp32 per-row scales dequantized right after the
// load), as the JAX package's _quant_kernel reuses _kernel.  The pools the
// serving path makes are bf16 or int8 only, so those are the page types.
//
// What it computes, per slot b and query head h (kv head h / G):
//   key j*bs + t (page block_tables[b, j], row t) is visible iff the table
//   entry is >= 0, j*bs + t <= pos[b] and, when window > 0,
//   pos[b] - (j*bs + t) < window; out = softmax(q.k * D^-0.5) . v over the
//   visible keys, with the softmax in fp32.
//
// What bounds it on an H100: bytes.  Each visible K/V row is read once and
// used for ~4*G flops per element, far below the ~295 flops per byte at
// which the tensor cores would become the limit.  The design therefore:
//   * reads the pool [P, bs, Hkv, D] in place with its strides: no
//     transposed or gathered copy of the pool is ever made;
//   * never loads what is masked: -1 table entries, blocks past pos / bs
//     and blocks wholly outside the window are skipped, so the bytes read
//     are those of the visible keys (plus the tail of the last block);
//   * stages each page's [bs, D] K and V tiles in shared memory once, with
//     16-byte loads, and lets all G query heads of the kv head read them
//     there, so the pool is read once per (slot, kv head), not once per
//     query head.
// One CTA per (slot, kv head) walks the blocks in order with a running
// (m, l, acc) state per query head in fp32 and finishes with
// acc / max(l, 1e-30).  A row with no visible key writes zeros.
// Later work: split-KV across CTAs for small batches, cp.async/TMA
// double buffering, and tensor-core products.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr float kNegInf = -1e30f;

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

// One 16-byte load of page elements, widened to fp32 (times the row scale
// for int8 pages, the same product as dequantize_kv).
template <typename PT>
struct PageLoad;

template <>
struct PageLoad<__nv_bfloat16> {
  static constexpr int kVec = 8;
  __device__ static void run(const __nv_bfloat16* src, float* dst, float) {
    const uint4 raw = *reinterpret_cast<const uint4*>(src);
    const __nv_bfloat16* e = reinterpret_cast<const __nv_bfloat16*>(&raw);
#pragma unroll
    for (int i = 0; i < kVec; ++i) dst[i] = __bfloat162float(e[i]);
  }
};

template <>
struct PageLoad<int8_t> {
  static constexpr int kVec = 16;
  __device__ static void run(const int8_t* src, float* dst, float scale) {
    const uint4 raw = *reinterpret_cast<const uint4*>(src);
    const int8_t* e = reinterpret_cast<const int8_t*>(&raw);
#pragma unroll
    for (int i = 0; i < kVec; ++i) dst[i] = static_cast<float>(e[i]) * scale;
  }
};

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Shared memory, in floats: q [G][D], K tile [bs][D+1] (padded so that
// threads reading different rows hit different banks), V tile [bs][D],
// scores/probabilities [G][bs], acc [G][D], then m, l and the rescale
// factor [G] each.
__host__ __device__ inline int smem_floats(int G, int D, int bs) {
  return G * D + bs * (D + 1) + bs * D + G * bs + G * D + 3 * G;
}

template <typename QT, typename PT>
__global__ void __launch_bounds__(kThreads) paged_decode_kernel(
    const QT* __restrict__ q, const PT* __restrict__ k_pages,
    const PT* __restrict__ v_pages, const float* __restrict__ k_scales,
    const float* __restrict__ v_scales,
    const int32_t* __restrict__ block_tables, const int32_t* __restrict__ pos,
    QT* __restrict__ out, int H, int Hkv, int D, int bs, int NB, int window,
    float scale) {
  extern __shared__ float smem[];
  const int G = H / Hkv;
  const int h = blockIdx.x;  // kv head
  const int b = blockIdx.y;  // slot
  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int Dp = D + 1;
  float* q_s = smem;
  float* k_s = q_s + G * D;
  float* v_s = k_s + bs * Dp;
  float* p_s = v_s + bs * D;
  float* acc = p_s + G * bs;
  float* m_s = acc + G * D;
  float* l_s = m_s + G;
  float* c_s = l_s + G;

  // the G query heads of kv head h are rows h*G .. h*G+G-1 of q[b]
  const QT* qb = q + (static_cast<size_t>(b) * H + static_cast<size_t>(h) * G) * D;
  for (int i = tid; i < G * D; i += kThreads) {
    q_s[i] = to_float(qb[i]);
    acc[i] = 0.f;
  }
  for (int g = tid; g < G; g += kThreads) {
    m_s[g] = kNegInf;
    l_s[g] = 0.f;
  }
  __syncthreads();

  const int p = pos[b];
  int j_hi = p < 0 ? -1 : p / bs;  // blocks past pos // bs hold no key
  if (j_hi > NB - 1) j_hi = NB - 1;
  int j_lo = 0;
  if (window > 0) {  // first block holding a key inside the window
    const int first = p - window + 1;
    if (first > 0) j_lo = first / bs;
  }
  const int32_t* bt = block_tables + static_cast<size_t>(b) * NB;
  constexpr int kVec = PageLoad<PT>::kVec;
  const int vecs_per_row = D / kVec;

  for (int j = j_lo; j <= j_hi; ++j) {
    const int page = bt[j];
    if (page < 0) continue;  // unallocated: nothing to load or attend
    // row (page, t, h) of the [P, bs, Hkv, D] pool
    const size_t row0 = static_cast<size_t>(page) * bs * Hkv + h;
    for (int i = tid; i < bs * vecs_per_row; i += kThreads) {
      const int t = i / vecs_per_row;
      const int c = (i % vecs_per_row) * kVec;
      const size_t row = row0 + static_cast<size_t>(t) * Hkv;
      float ks = 1.f, vs = 1.f;
      if (k_scales != nullptr) {
        ks = k_scales[row];
        vs = v_scales[row];
      }
      PageLoad<PT>::run(k_pages + row * D + c, k_s + t * Dp + c, ks);
      PageLoad<PT>::run(v_pages + row * D + c, v_s + t * D + c, vs);
    }
    __syncthreads();

    for (int i = tid; i < G * bs; i += kThreads) {
      const int g = i / bs, t = i % bs;
      const int cpos = j * bs + t;
      const bool valid = cpos <= p && (window == 0 || p - cpos < window);
      float s = kNegInf;
      if (valid) {
        const float* qr = q_s + g * D;
        const float* kr = k_s + t * Dp;
        float dot = 0.f;
        for (int d = 0; d < D; ++d) dot = fmaf(qr[d], kr[d], dot);
        s = dot * scale;
      }
      p_s[i] = s;
    }
    __syncthreads();

    // online softmax, one warp per query head
    for (int g = warp; g < G; g += kWarps) {
      float* pr = p_s + g * bs;
      float mx = kNegInf;
      for (int t = lane; t < bs; t += 32) mx = fmaxf(mx, pr[t]);
      mx = warp_max(mx);
      const float m_old = m_s[g];
      const float m_new = fmaxf(m_old, mx);
      float sum = 0.f;
      for (int t = lane; t < bs; t += 32) {
        const float e = expf(pr[t] - m_new);
        pr[t] = e;
        sum += e;
      }
      sum = warp_sum(sum);
      if (lane == 0) {
        const float corr = expf(m_old - m_new);
        l_s[g] = l_s[g] * corr + sum;
        m_s[g] = m_new;
        c_s[g] = corr;
      }
    }
    __syncthreads();

    for (int i = tid; i < G * D; i += kThreads) {
      const int g = i / D, d = i % D;
      const float* pr = p_s + g * bs;
      float a = acc[i] * c_s[g];
      for (int t = 0; t < bs; ++t) a = fmaf(pr[t], v_s[t * D + d], a);
      acc[i] = a;
    }
    __syncthreads();  // the tiles are overwritten by the next block
  }

  QT* ob = out + (static_cast<size_t>(b) * H + static_cast<size_t>(h) * G) * D;
  for (int i = tid; i < G * D; i += kThreads)
    ob[i] = from_float<QT>(acc[i] / fmaxf(l_s[i / D], 1e-30f));
}

template <typename QT, typename PT>
int launch(const void* q, const void* k_pages, const void* v_pages,
           const void* k_scales, const void* v_scales,
           const void* block_tables, const void* pos, void* out, int B, int H,
           int Hkv, int D, int bs, int NB, int window, float scale,
           cudaStream_t stream) {
  const int G = H / Hkv;
  const size_t bytes = sizeof(float) * smem_floats(G, D, bs);
  auto kernel = paged_decode_kernel<QT, PT>;
  if (bytes > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(bytes));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const dim3 grid(Hkv, B);
  kernel<<<grid, kThreads, bytes, stream>>>(
      static_cast<const QT*>(q), static_cast<const PT*>(k_pages),
      static_cast<const PT*>(v_pages), static_cast<const float*>(k_scales),
      static_cast<const float*>(v_scales),
      static_cast<const int32_t*>(block_tables),
      static_cast<const int32_t*>(pos), static_cast<QT*>(out), H, Hkv, D, bs,
      NB, window, scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename QT>
int launch_pages(int page_dtype, const void* q, const void* k_pages,
                 const void* v_pages, const void* k_scales,
                 const void* v_scales, const void* block_tables,
                 const void* pos, void* out, int B, int H, int Hkv, int D,
                 int bs, int NB, int window, float scale,
                 cudaStream_t stream) {
  switch (page_dtype) {
    case 0:
      return launch<QT, __nv_bfloat16>(q, k_pages, v_pages, nullptr, nullptr,
                                       block_tables, pos, out, B, H, Hkv, D,
                                       bs, NB, window, scale, stream);
    case 1:
      return launch<QT, int8_t>(q, k_pages, v_pages, k_scales, v_scales,
                                block_tables, pos, out, B, H, Hkv, D, bs, NB,
                                window, scale, stream);
    default:
      return -1;
  }
}

}  // namespace

extern "C" {

// Bytes of dynamic shared memory one CTA needs; the wrapper checks it
// against the card's 227 KB before launching.
int paged_decode_smem_bytes(int G, int D, int bs) {
  return static_cast<int>(sizeof(float)) * smem_floats(G, D, bs);
}

// q_dtype: 0 fp32, 1 bf16 (the output has q's type).  page_dtype: 0 bf16,
// 1 int8 (k_scales/v_scales then point at fp32 [P, bs, Hkv]).
// All tensors contiguous; block_tables [B, NB] and pos [B] int32.
// Returns cudaGetLastError() after the launch, or -1 for a bad dtype code.
int paged_decode_launch(int q_dtype, int page_dtype, const void* q,
                        const void* k_pages, const void* v_pages,
                        const void* k_scales, const void* v_scales,
                        const void* block_tables, const void* pos, void* out,
                        int B, int H, int Hkv, int D, int bs, int NB,
                        int window, float scale, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (q_dtype) {
    case 0:
      return launch_pages<float>(page_dtype, q, k_pages, v_pages, k_scales,
                                 v_scales, block_tables, pos, out, B, H, Hkv,
                                 D, bs, NB, window, scale, s);
    case 1:
      return launch_pages<__nv_bfloat16>(page_dtype, q, k_pages, v_pages,
                                         k_scales, v_scales, block_tables,
                                         pos, out, B, H, Hkv, D, bs, NB,
                                         window, scale, s);
    default:
      return -1;
  }
}

}  // extern "C"
