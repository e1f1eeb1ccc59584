// Paged multi-token verify attention for Hopper (sm_90a): T query tokens
// per slot, at positions pos .. pos+T-1, against a paged K/V pool
// addressed through a block table, causal per query row.
//
// Replaces the Pallas TPU kernels paged_verify_tpu and
// paged_verify_quant_tpu (repro/kernels/paged_verify.py:95,147).  One
// source covers both: the page type is a template parameter (bf16 pages,
// or int8 pages with fp32 per-row scales dequantized right after the
// load), as the JAX package's _quant_kernel reuses _kernel.  The serving
// path calls it twice: for the T = k+1 rows of a speculative verify pass
// and for the C rows of a chunked-prefill chunk (qpos = pos + arange(C)).
//
// What it computes, per slot b, token t and query head h (kv head h / G):
//   key j*bs + i (page block_tables[b, j], row i) is visible to row t iff
//   the table entry is >= 0, j*bs + i <= pos[b] + t and, when window > 0,
//   pos[b] + t - (j*bs + i) < window; out = softmax(q.k * D^-0.5) . v over
//   the visible keys, with the softmax in fp32 and each probability
//   rounded to the page type before the value product (bf16 pages; int8
//   pages are dequantized to fp32 and keep it fp32), as the plain version
//   (the JAX package's chunk attention) does.  The Pallas kernel keeps
//   fp32 probabilities; the plain version's rounding is what the CPU
//   computes, and an MoE router amplifies the ~1e-3 difference into other
//   experts.  A row with no visible key (a free slot's rows: its table is
//   all -1) gets what the plain version and the Pallas kernel give it: the
//   uniform softmax over the NEG_INF fills of every key the table
//   addresses, i.e. the mean of the NB*bs value rows, -1 entries read from
//   the null page 0 (the weight 1/(NB*bs) rounded as above).  Nobody reads
//   such a row's attention, but an MoE layer routes its token, which
//   competes with the live tokens for each expert's capacity.
//
// What bounds it on an H100: bytes at the verify shape (T*G rows use each
// K/V element ~4*T*G times, under the ~295 flops per byte where the tensor
// cores would take over), operations at long chunks (a T = 64 chunk with
// G = 7 does ~1800 flops per K/V element).  This first version is simple,
// with fp32 products from shared memory and no tensor cores.  The Pallas
// grid (B, Hkv, NB) walks every table entry and keeps all T*G rows in
// scratch; here instead:
//   * the grid is (tile of kRows query rows, kv head, slot): the T*G rows
//     of one (slot, kv head) are flattened token-major (row r is token
//     r / G, query head r % G) and cut into tiles, so a 64-token chunk at
//     G = 7 (448 rows) runs as 28 CTAs per kv head instead of needing all
//     448 fp32 accumulators in one CTA's shared memory;
//   * each CTA walks the blocks its rows can see twice: the first walk
//     reads K and keeps every fp32 score of its rows in a scratch row
//     (shared memory, kRows*NB*bs*4 bytes: 64 KB at 1024 keys; global
//     memory, written and read by this CTA alone, where that does not
//     fit), the max m and sum l of each row then come from the stored
//     scores as the plain version's softmax computes them, and the second
//     walk reads V only, forms exp(s - m) / l from the stored score, rounds
//     it and accumulates p * v (the value product cannot start before l is
//     known if its probabilities are to be rounded as the plain version's
//     are; K and V are each read once);
//   * the blocks a CTA walks are those its rows can see: from the first
//     block inside the window of its earliest row to the block of its
//     latest row; -1 table entries are skipped, never loaded;
//   * each page's [bs, D] K and V tiles of the kv head are staged in shared
//     memory once, with 16-byte loads, for all rows of the tile;
//   * the pool [P, bs, Hkv, D] is read in place with its strides: no
//     transposed or gathered copy is made.
// Later work: wgmma tiles of 64 rows for long chunks, TMA/cp.async double
// buffering, and split-KV for small batches.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kRows = 16;  // query rows (token x query head) per CTA
constexpr int kWarps = kThreads / 32;
constexpr float kNegInf = -1e30f;
constexpr float kMasked = -1e29f;  // scores at or below this are masked

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

__device__ __forceinline__ float value(const __nv_bfloat16* p, size_t i) {
  return __bfloat162float(p[i]);
}
__device__ __forceinline__ float value(const int8_t* p, size_t i) {
  return static_cast<float>(p[i]);
}

// A probability as it multiplies v: rounded to the page type where the
// pages are bf16, as the plain version rounds it (int8 pages are
// dequantized to fp32 first, so it stays fp32).
template <typename PT>
__device__ __forceinline__ float round_p(float p) {
  return __bfloat162float(__float2bfloat16(p));
}
template <>
__device__ __forceinline__ float round_p<int8_t>(float p) {
  return p;
}

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

// Shared memory, in floats: q [kRows][D], acc [kRows][D], the K then V
// tile [bs][D+1] (padded so that threads reading different keys hit
// different banks), m and l [kRows] each, then, unless they go to global
// memory, the scores [kRows][NB*bs] (score_words of them).
__host__ __device__ inline int smem_floats(int D, int bs, int score_words) {
  return 2 * kRows * D + bs * (D + 1) + 2 * kRows + score_words;
}

template <typename QT, typename PT>
__global__ void __launch_bounds__(kThreads) paged_verify_kernel(
    const QT* __restrict__ q, const PT* __restrict__ k_pages,
    const PT* __restrict__ v_pages, const float* __restrict__ k_scales,
    const float* __restrict__ v_scales,
    const int32_t* __restrict__ block_tables, const int32_t* __restrict__ pos,
    float* scores, QT* __restrict__ out, int T, int H, int Hkv, int D, int bs,
    int NB, int window, float scale) {
  extern __shared__ float smem[];
  const int G = H / Hkv;
  const int r0 = blockIdx.x * kRows;  // first row of this tile
  const int h = blockIdx.y;           // kv head
  const int b = blockIdx.z;           // slot
  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int rows = min(kRows, T * G - r0);  // rows of this tile
  const int Dp = D + 1;
  const int S = NB * bs;  // keys the table addresses
  float* q_s = smem;
  float* acc = q_s + kRows * D;
  float* tile = acc + kRows * D;
  float* m_s = tile + bs * Dp;
  float* l_s = m_s + kRows;
  // score of row r and key s at sc[r * S + s]: this CTA's own rows
  float* sc = scores != nullptr
                  ? scores + ((static_cast<size_t>(b) * Hkv + h) * gridDim.x +
                              blockIdx.x) * kRows * S
                  : l_s + kRows;

  // row r of the tile is token (r0 + r) / G, query head h*G + (r0 + r) % G
  for (int i = tid; i < kRows * D; i += kThreads) {
    const int r = i / D, d = i % D;
    float x = 0.f;
    if (r < rows) {
      const int t = (r0 + r) / G, g = (r0 + r) % G;
      x = to_float(q[((static_cast<size_t>(b) * T + t) * H + h * G + g) * D +
                     d]);
    }
    q_s[i] = x;
    acc[i] = 0.f;
  }
  __syncthreads();

  const int p = pos[b];
  const int p_lo = p + r0 / G;               // the tile's earliest row
  const int p_hi = p + (r0 + rows - 1) / G;  // and its latest
  int j_hi = p_hi < 0 ? -1 : p_hi / bs;  // blocks past it hold no key
  if (j_hi > NB - 1) j_hi = NB - 1;
  int j_lo = 0;
  if (window > 0) {  // first block holding a key inside the earliest window
    const int first = p_lo - window + 1;
    if (first > 0) j_lo = first / bs;
  }
  const int32_t* bt = block_tables + static_cast<size_t>(b) * NB;
  constexpr int kVec = PageLoad<PT>::kVec;
  const int vecs_per_row = D / kVec;

  // walk 1: the scores of blocks j_lo .. j_hi (K only); masked keys and
  // unallocated blocks score kNegInf
  for (int j = j_lo; j <= j_hi; ++j) {
    const int page = bt[j];
    if (page >= 0) {
      // row (page, i, h) of the [P, bs, Hkv, D] pool
      const size_t row0 = static_cast<size_t>(page) * bs * Hkv + h;
      for (int i = tid; i < bs * vecs_per_row; i += kThreads) {
        const int t = i / vecs_per_row;
        const int c = (i % vecs_per_row) * kVec;
        const size_t row = row0 + static_cast<size_t>(t) * Hkv;
        const float ks = k_scales != nullptr ? k_scales[row] : 1.f;
        PageLoad<PT>::run(k_pages + row * D + c, tile + t * Dp + c, ks);
      }
      __syncthreads();
    }
    for (int i = tid; i < kRows * bs; i += kThreads) {
      const int r = i / bs, t = i % bs;
      const int rpos = p + (r0 + r) / G;
      const int cpos = j * bs + t;
      const bool valid = page >= 0 && r < rows && cpos <= rpos &&
                         (window == 0 || rpos - cpos < window);
      float s = kNegInf;
      if (valid) {
        const float* qr = q_s + r * D;
        const float* kr = tile + t * Dp;
        float dot = 0.f;
        for (int d = 0; d < D; ++d) dot = fmaf(qr[d], kr[d], dot);
        s = dot * scale;
      }
      sc[r * S + cpos] = s;
    }
    __syncthreads();  // the tile is overwritten by the next block
  }

  // max and sum of each row over its stored scores, one warp per row;
  // masked keys add 0, so a row that sees no key keeps l = 0
  const int lo = j_lo * bs, hi = (j_hi + 1) * bs;
  for (int r = warp; r < kRows; r += kWarps) {
    const float* sr = sc + r * S;
    float mx = kNegInf;
    for (int s = lo + lane; s < hi; s += 32) mx = fmaxf(mx, sr[s]);
    mx = warp_max(mx);
    float sum = 0.f;
    for (int s = lo + lane; s < hi; s += 32)
      sum += sr[s] > kMasked ? expf(sr[s] - mx) : 0.f;
    sum = warp_sum(sum);
    if (lane == 0) {
      m_s[r] = mx;
      l_s[r] = sum;
    }
  }
  __syncthreads();

  // walk 2 (if any row sees a key): V only; each stored score becomes its
  // rounded probability
  int live = 0;
  for (int r = tid; r < rows; r += kThreads) live |= l_s[r] > 0.f;
  if (__syncthreads_or(live)) {
    for (int j = j_lo; j <= j_hi; ++j) {
      const int page = bt[j];
      if (page < 0) continue;  // unallocated: nothing to load or attend
      const size_t row0 = static_cast<size_t>(page) * bs * Hkv + h;
      for (int i = tid; i < bs * vecs_per_row; i += kThreads) {
        const int t = i / vecs_per_row;
        const int c = (i % vecs_per_row) * kVec;
        const size_t row = row0 + static_cast<size_t>(t) * Hkv;
        const float vs = v_scales != nullptr ? v_scales[row] : 1.f;
        PageLoad<PT>::run(v_pages + row * D + c, tile + t * Dp + c, vs);
      }
      for (int i = tid; i < kRows * bs; i += kThreads) {
        const int r = i / bs;
        float* s = sc + r * S + j * bs + i % bs;
        *s = *s > kMasked ? round_p<PT>(expf(*s - m_s[r]) / l_s[r]) : 0.f;
      }
      __syncthreads();
      for (int i = tid; i < kRows * D; i += kThreads) {
        const int d = i % D;
        const float* pr = sc + (i / D) * S + j * bs;
        float a = acc[i];
        for (int t = 0; t < bs; ++t) a = fmaf(pr[t], tile[t * Dp + d], a);
        acc[i] = a;
      }
      __syncthreads();  // the tile is overwritten by the next block
    }
  }

  // rows with no visible key take the mean of the table's value rows,
  // computed once into the tile (free now)
  int dead = 0;
  for (int r = tid; r < rows; r += kThreads) dead |= l_s[r] == 0.f;
  if (__syncthreads_or(dead)) {
    const float w = round_p<PT>(1.f / static_cast<float>(S));
    for (int d = tid; d < D; d += kThreads) {
      float a = 0.f;
      for (int j = 0; j < NB; ++j) {
        const size_t row0 = static_cast<size_t>(max(bt[j], 0)) * bs * Hkv + h;
        for (int i = 0; i < bs; ++i) {
          const size_t row = row0 + static_cast<size_t>(i) * Hkv;
          const float vs = v_scales != nullptr ? v_scales[row] : 1.f;
          a = fmaf(w, value(v_pages, row * D + d) * vs, a);
        }
      }
      tile[d] = a;
    }
    __syncthreads();
  }

  // only this tile's own rows are written
  for (int i = tid; i < rows * D; i += kThreads) {
    const int r = i / D, d = i % D;
    const int t = (r0 + r) / G, g = (r0 + r) % G;
    out[((static_cast<size_t>(b) * T + t) * H + h * G + g) * D + d] =
        from_float<QT>(l_s[r] == 0.f ? tile[d] : acc[i]);
  }
}

template <typename QT, typename PT>
int launch(const void* q, const void* k_pages, const void* v_pages,
           const void* k_scales, const void* v_scales,
           const void* block_tables, const void* pos, void* scores, void* out,
           int B, int T, int H, int Hkv, int D, int bs, int NB, int window,
           float scale, cudaStream_t stream) {
  const int G = H / Hkv;
  const int score_words = scores != nullptr ? 0 : kRows * NB * bs;
  const size_t bytes = sizeof(float) * smem_floats(D, bs, score_words);
  auto kernel = paged_verify_kernel<QT, PT>;
  if (bytes > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(bytes));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const dim3 grid((T * G + kRows - 1) / kRows, Hkv, B);
  kernel<<<grid, kThreads, bytes, stream>>>(
      static_cast<const QT*>(q), static_cast<const PT*>(k_pages),
      static_cast<const PT*>(v_pages), static_cast<const float*>(k_scales),
      static_cast<const float*>(v_scales),
      static_cast<const int32_t*>(block_tables),
      static_cast<const int32_t*>(pos), static_cast<float*>(scores),
      static_cast<QT*>(out), T, H, Hkv, D, bs, NB, window, scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename QT>
int launch_pages(int page_dtype, const void* q, const void* k_pages,
                 const void* v_pages, const void* k_scales,
                 const void* v_scales, const void* block_tables,
                 const void* pos, void* scores, void* out, int B, int T,
                 int H, int Hkv, int D, int bs, int NB, int window,
                 float scale, cudaStream_t stream) {
  switch (page_dtype) {
    case 0:
      return launch<QT, __nv_bfloat16>(q, k_pages, v_pages, nullptr, nullptr,
                                       block_tables, pos, scores, out, B, T,
                                       H, Hkv, D, bs, NB, window, scale,
                                       stream);
    case 1:
      return launch<QT, int8_t>(q, k_pages, v_pages, k_scales, v_scales,
                                block_tables, pos, scores, out, B, T, H, Hkv,
                                D, bs, NB, window, scale, stream);
    default:
      return -1;
  }
}

}  // namespace

extern "C" {

// Bytes of dynamic shared memory one CTA needs, with score_words floats of
// scores kept there (tile_rows()*NB*bs, or 0 when they go to global
// memory); the wrapper checks it against the card's 227 KB before
// launching.
int paged_verify_smem_bytes(int D, int bs, int score_words) {
  return static_cast<int>(sizeof(float)) * smem_floats(D, bs, score_words);
}

// Query rows (token x query head) one CTA takes.
int paged_verify_tile_rows() { return kRows; }

// q [B, T, H, D], q_dtype: 0 fp32, 1 bf16 (the output has q's type).
// page_dtype: 0 bf16, 1 int8 (k_scales/v_scales then point at fp32
// [P, bs, Hkv]).  All tensors contiguous; block_tables [B, NB] and pos [B]
// int32.  scores: null keeps the scores in shared memory; else fp32
// scratch of B*Hkv*ceil(T*G/tile_rows())*tile_rows()*NB*bs floats in
// global memory.
// Returns cudaGetLastError() after the launch, or -1 for a bad dtype code.
int paged_verify_launch(int q_dtype, int page_dtype, const void* q,
                        const void* k_pages, const void* v_pages,
                        const void* k_scales, const void* v_scales,
                        const void* block_tables, const void* pos,
                        void* scores, void* out, int B, int T, int H, int Hkv,
                        int D, int bs, int NB, int window, float scale,
                        void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (q_dtype) {
    case 0:
      return launch_pages<float>(page_dtype, q, k_pages, v_pages, k_scales,
                                 v_scales, block_tables, pos, scores, out, B,
                                 T, H, Hkv, D, bs, NB, window, scale, s);
    case 1:
      return launch_pages<__nv_bfloat16>(page_dtype, q, k_pages, v_pages,
                                         k_scales, v_scales, block_tables,
                                         pos, scores, out, B, T, H, Hkv, D,
                                         bs, NB, window, scale, s);
    default:
      return -1;
  }
}

}  // extern "C"
