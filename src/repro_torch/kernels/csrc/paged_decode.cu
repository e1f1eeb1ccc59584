// Paged decode attention for Hopper (sm_90a): one query token per slot
// against a paged K/V pool addressed through a block table.
//
// Replaces the Pallas TPU kernels paged_decode_tpu and
// paged_decode_quant_tpu (repro/kernels/paged_decode.py:92,137).  One
// source covers both: the page type is a template parameter (bf16 pages,
// or int8 pages with fp32 per-row scales), as the JAX package's
// _quant_kernel reuses _kernel.  The pools the serving path makes are
// bf16 or int8 only, so those are the page types.
//
// What it computes, per slot b and query head h (kv head h / G):
//   key j*bs + t (page block_tables[b, j], row t) is visible iff the table
//   entry is >= 0, j*bs + t <= pos[b] and, when window > 0,
//   pos[b] - (j*bs + t) < window; out = softmax(q.k * D^-0.5) . v over the
//   visible keys, with the softmax in fp32.  Each probability is rounded
//   to the page type against the row's final max and sum (bf16 pages;
//   int8 pages are dequantized to fp32 and keep it fp32), as the plain
//   version (the JAX package's decode_attention) rounds its probabilities
//   before the value product: the Pallas kernel keeps fp32 probabilities,
//   and an MoE router amplifies the ~1e-3 difference into other experts.
//   A row with no visible key (a free slot, whose table is all -1) gets
//   what the plain version and the Pallas kernel give it: the uniform
//   softmax over the NEG_INF fills of every key the table addresses, i.e.
//   the mean of the NB*bs value rows, -1 entries read from the null page 0
//   (the weight 1/(NB*bs) rounded as above).  Nobody reads such a row's
//   attention, but an MoE layer routes its token, which competes with the
//   live tokens for each expert's capacity.
//
// What bounds it on an H100: the bytes of the visible K/V rows, each used
// for ~4*G flops per element, far under the ~295 flops per byte at which
// the bf16 tensor cores would become the limit.  At a decode tick those
// bytes are few (B 8 slots of 60-1000 keys at qwen2-0.5b's widths: 2 MB,
// 0.6 us at 3.35 TB/s), so what the design has to beat is latency: one
// CTA per (slot, kv head) would run 16 CTAs on 132 SMs, each walking its
// slot's whole context twice.  For bf16 queries (every bf16 serving path,
// bf16 and int8 pools):
//   * split-KV: the grid is (split, kv head, slot).  The NB*bs keys of the
//     table are cut into splits of split_keys (whole tiles of
//     key_tile(D) = 64 keys, 32 past D 128) so that a call runs about two
//     CTAs per SM, at most 32 splits.  The plan comes from the shapes
//     alone (kernels/paged_decode.py:plan, the rule paged verify's plan
//     uses at T = 1): pos is never read on the host.  A CTA whose split
//     lies wholly past pos, or before the window, exits at once;
//   * two launches.  Pass 1 (scores): q.k over the split's visible keys,
//     scaled (to exp2 units) and masked, and each query head's
//     split-local max m_i and sum l_i of exp2(s - m_i) to an fp32 scratch.
//     Pass 2 (values): every CTA merges all splits' (m_i, l_i) of its
//     heads in split order (every CTA gets the same m and l; a split with
//     no visible key gives (NEG_INF, 0) and is skipped), recomputes its
//     split's scores with pass 1's instructions (bitwise the same), forms
//     p = exp2(s - m) * (1 / l), rounds it to the page type and
//     accumulates p v into an fp32 [G, D] partial.  The last pass-2 CTA of
//     each (slot, kv head) to arrive (a counter zeroed by pass 1, raised
//     after a __threadfence) sums the partials in split order, so the
//     result does not depend on which CTA is last, and writes bf16; with
//     one split pass 2 writes the output itself.  Rounding p needs the
//     row's final m and l, so one online pass will not do (paged_verify.cu
//     records how far a running-max rounding departs);
//   * rows with no visible key: every split's pass 2 takes p = 1/(NB*bs)
//     on each of its keys (-1 entries read page 0, keys past the table
//     give 0), and the mean is summed in split order with the partials;
//   * inside a CTA (four warps): the split's block-table entries are
//     staged first; K, then V, tiles of key_tile(D) keys stream through a
//     two-stage cp.async ring (16-byte copies read in place through the
//     [P, bs, Hkv, D] strides, no gathered copy; one tile in flight while
//     the previous one multiplies); every staged row is used by all G <= 16
//     query heads of its kv head; products and sums are fp32 FMAs on the
//     CUDA cores.  Not the tensor cores: at T = 1 the G = 7 query rows of
//     qwen2-0.5b would fill 7 of an m16n8k16 tile's 16, the work is far
//     under their limit (above), and fp32 products keep int8 pages' fp32
//     p exact without a bf16 hi + lo split.
// fp32 queries (the tests, fp32 parity runs) run the two-walk kernel
// below instead (one CTA per (slot, kv head), scores stored in shared or
// global memory, m and l from the stored scores, then V), whose
// arithmetic paged verify's fp32 kernel shares: test_torch_speculative.py
// holds the two to 1e-4, which sums merged across splits break.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "tc_bf16.cuh"

namespace {

// ------------------------------ fp32 queries: the two-walk kernel

constexpr int kThreads = 128;
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

// Shared memory, in floats: q [G][D], the K then V tile [bs][D+1] (padded
// so that threads reading different rows hit different banks), acc [G][D],
// m and l [G] each, then, unless they go to global memory, the scores
// [G][NB*bs] (score_words of them).
__host__ __device__ inline int smem_floats(int G, int D, int bs,
                                           int score_words) {
  return G * D + bs * (D + 1) + G * D + 2 * G + score_words;
}

template <typename QT, typename PT>
__global__ void __launch_bounds__(kThreads) paged_decode_kernel(
    const QT* __restrict__ q, const PT* __restrict__ k_pages,
    const PT* __restrict__ v_pages, const float* __restrict__ k_scales,
    const float* __restrict__ v_scales,
    const int32_t* __restrict__ block_tables, const int32_t* __restrict__ pos,
    float* scores, QT* __restrict__ out, int H, int Hkv, int D, int bs,
    int NB, int window, float scale) {
  extern __shared__ float smem[];
  const int G = H / Hkv;
  const int h = blockIdx.x;  // kv head
  const int b = blockIdx.y;  // slot
  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int Dp = D + 1;
  const int S = NB * bs;  // keys the table addresses
  float* q_s = smem;
  float* tile = q_s + G * D;
  float* acc = tile + bs * Dp;
  float* m_s = acc + G * D;
  float* l_s = m_s + G;
  // score of head g and key s at sc[g * S + s]: this CTA's own rows
  float* sc = scores != nullptr
                  ? scores + (static_cast<size_t>(b) * Hkv + h) * G * S
                  : l_s + G;

  // the G query heads of kv head h are rows h*G .. h*G+G-1 of q[b]
  const QT* qb = q + (static_cast<size_t>(b) * H + static_cast<size_t>(h) * G) * D;
  for (int i = tid; i < G * D; i += kThreads) {
    q_s[i] = to_float(qb[i]);
    acc[i] = 0.f;
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

  // walk 1: the scores of blocks j_lo .. j_hi (K only); masked keys and
  // unallocated blocks score kNegInf
  for (int j = j_lo; j <= j_hi; ++j) {
    const int page = bt[j];
    if (page >= 0) {
      // row (page, t, h) of the [P, bs, Hkv, D] pool
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
    for (int i = tid; i < G * bs; i += kThreads) {
      const int g = i / bs, t = i % bs;
      const int cpos = j * bs + t;
      const bool valid =
          page >= 0 && cpos <= p && (window == 0 || p - cpos < window);
      float s = kNegInf;
      if (valid) {
        const float* qr = q_s + g * D;
        const float* kr = tile + t * Dp;
        float dot = 0.f;
        for (int d = 0; d < D; ++d) dot = fmaf(qr[d], kr[d], dot);
        s = dot * scale;
      }
      sc[g * S + cpos] = s;
    }
    __syncthreads();  // the tile is overwritten by the next block
  }

  // max and sum of each head over its stored scores, one warp per head;
  // masked keys add 0, so a head that sees no key keeps l = 0
  const int lo = j_lo * bs, hi = (j_hi + 1) * bs;
  for (int g = warp; g < G; g += kWarps) {
    const float* sr = sc + g * S;
    float mx = kNegInf;
    for (int s = lo + lane; s < hi; s += 32) mx = fmaxf(mx, sr[s]);
    mx = warp_max(mx);
    float sum = 0.f;
    for (int s = lo + lane; s < hi; s += 32)
      sum += sr[s] > kMasked ? expf(sr[s] - mx) : 0.f;
    sum = warp_sum(sum);
    if (lane == 0) {
      m_s[g] = mx;
      l_s[g] = sum;
    }
  }
  __syncthreads();

  QT* ob = out + (static_cast<size_t>(b) * H + static_cast<size_t>(h) * G) * D;
  if (l_s[0] == 0.f) {  // no visible key (for every head alike)
    const float w = round_p<PT>(1.f / static_cast<float>(S));
    for (int d = tid; d < D; d += kThreads) {
      float a = 0.f;
      for (int j = 0; j < NB; ++j) {
        const size_t row0 = static_cast<size_t>(max(bt[j], 0)) * bs * Hkv + h;
        for (int t = 0; t < bs; ++t) {
          const size_t row = row0 + static_cast<size_t>(t) * Hkv;
          const float vs = v_scales != nullptr ? v_scales[row] : 1.f;
          a = fmaf(w, value(v_pages, row * D + d) * vs, a);
        }
      }
      for (int g = 0; g < G; ++g) ob[g * D + d] = from_float<QT>(a);
    }
    return;
  }

  // walk 2: V only; each stored score becomes its rounded probability
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
    for (int i = tid; i < G * bs; i += kThreads) {
      const int g = i / bs;
      float* s = sc + g * S + j * bs + i % bs;
      *s = *s > kMasked ? round_p<PT>(expf(*s - m_s[g]) / l_s[g]) : 0.f;
    }
    __syncthreads();
    for (int i = tid; i < G * D; i += kThreads) {
      const int d = i % D;
      const float* pr = sc + (i / D) * S + j * bs;
      float a = acc[i];
      for (int t = 0; t < bs; ++t) a = fmaf(pr[t], tile[t * Dp + d], a);
      acc[i] = a;
    }
    __syncthreads();  // the tile is overwritten by the next block
  }
  for (int i = tid; i < G * D; i += kThreads) ob[i] = from_float<QT>(acc[i]);
}

template <typename QT, typename PT>
int launch(const void* q, const void* k_pages, const void* v_pages,
           const void* k_scales, const void* v_scales,
           const void* block_tables, const void* pos, void* scores, void* out,
           int B, int H, int Hkv, int D, int bs, int NB, int window,
           float scale, cudaStream_t stream) {
  const int G = H / Hkv;
  const int score_words = scores != nullptr ? 0 : G * NB * bs;
  const size_t bytes = sizeof(float) * smem_floats(G, D, bs, score_words);
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
      static_cast<const int32_t*>(pos), static_cast<float*>(scores),
      static_cast<QT*>(out), H, Hkv, D, bs, NB, window, scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename QT>
int launch_pages(int page_dtype, const void* q, const void* k_pages,
                 const void* v_pages, const void* k_scales,
                 const void* v_scales, const void* block_tables,
                 const void* pos, void* scores, void* out, int B, int H,
                 int Hkv, int D, int bs, int NB, int window, float scale,
                 cudaStream_t stream) {
  switch (page_dtype) {
    case 0:
      return launch<QT, __nv_bfloat16>(q, k_pages, v_pages, nullptr, nullptr,
                                       block_tables, pos, scores, out, B, H,
                                       Hkv, D, bs, NB, window, scale, stream);
    case 1:
      return launch<QT, int8_t>(q, k_pages, v_pages, k_scales, v_scales,
                                block_tables, pos, scores, out, B, H, Hkv, D,
                                bs, NB, window, scale, stream);
    default:
      return -1;
  }
}


// ----------------------------------------- bf16 queries: split-KV passes

using tc::bf16;

constexpr int kMaxGroup = 16;   // query heads per kv head
constexpr int kMaxSplits = 32;  // splits a call may have (a bit each)
constexpr int kPad = 8;         // bf16 elements of padding per staged row
constexpr int kNoKey = -2;      // page entry of a key past the table

// Keys per staged tile at head dim D; a split is a whole number of them
// (kernels/paged_decode.py:key_tile).
__host__ __device__ constexpr int key_tile(int D) { return D > 128 ? 32 : 64; }

struct Args {
  const bf16* q;
  const void* k_pages;
  const void* v_pages;
  const float* k_scales;
  const float* v_scales;
  const int32_t* block_tables;
  const int32_t* pos;
  float* m;        // [B*Hkv][splits][G]: split-local max (exp2 units)
  float* l;        // the same: sum of exp2(s - m) over the split
  float* partial;  // [B*Hkv][splits][G][D]; null with one split
  int* arrived;    // [B*Hkv]: pass-2 CTAs done (zeroed by pass 1)
  bf16* out;
  int H, Hkv, bs, NB, window;
  int split_keys;  // keys per split, a multiple of key_tile(D)
  int splits;
  float scale_log2;  // D^-0.5 * log2(e)
  float inv_keys;    // 1 / (NB * bs), divided once on the host
};

__host__ __device__ inline int align16(int x) { return (x + 15) & ~15; }

// Byte offsets into dynamic shared memory.
struct Smem {
  int q, k_raw, v_raw, sc, page, k_scale, v_scale, bt, m, l, mf, il, bytes;
};

// quant: int8 pages (staged as they are, widened when read).
__host__ __device__ inline Smem smem_layout(bool quant, int D, int G,
                                            int split_keys, int splits,
                                            int bs) {
  const int KT = key_tile(D);
  const int raw_row = quant ? D + 16 : (D + kPad) * 2;
  const int sizes[12] = {
      G * D * 4,                  // q, widened to fp32
      2 * KT * raw_row,           // K ring
      2 * KT * raw_row,           // V ring
      G * (KT + 1) * 4,           // scores, then probabilities
      2 * KT * 4,                 // page entries of both stages
      quant ? 2 * KT * 4 : 0,     // k scales
      quant ? 2 * KT * 4 : 0,     // v scales
      (split_keys / bs + 2) * 4,  // the split's block-table entries
      splits * G * 4,             // every split's m
      splits * G * 4,             // and l
      G * 4,                      // merged m
      G * 4};                     // 1 / merged l
  int at[12];
  int total = 0;
  for (int i = 0; i < 12; ++i) {
    at[i] = total;
    total += align16(sizes[i]);
  }
  return Smem{at[0], at[1], at[2], at[3], at[4],  at[5],  at[6],
              at[7], at[8], at[9], at[10], at[11], total};
}

// 4 bytes from global src to shared dst (src_bytes 0: zero-filled).
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   tc::smem_addr(dst)),
               "l"(src), "r"(src_bytes));
}

// Four page elements from shared memory, widened to fp32.
__device__ __forceinline__ void load4(const bf16* p, float (&x)[4]) {
  const uint2 r = *reinterpret_cast<const uint2*>(p);
  const __nv_bfloat162* e = reinterpret_cast<const __nv_bfloat162*>(&r);
  const float2 a = __bfloat1622float2(e[0]);
  const float2 b = __bfloat1622float2(e[1]);
  x[0] = a.x;
  x[1] = a.y;
  x[2] = b.x;
  x[3] = b.y;
}
__device__ __forceinline__ void load4(const int8_t* p, float (&x)[4]) {
  const char4 r = *reinterpret_cast<const char4*>(p);
  x[0] = static_cast<float>(r.x);
  x[1] = static_cast<float>(r.y);
  x[2] = static_cast<float>(r.z);
  x[3] = static_cast<float>(r.w);
}

__device__ __forceinline__ void store2(bf16* dst, float x, float y) {
  *reinterpret_cast<__nv_bfloat162*>(dst) = __floats2bfloat162_rn(x, y);
}

// Query heads one thread of the value product holds at head dim D (its
// four columns of up to 16 heads, threads spread over the column quads).
__host__ __device__ constexpr int value_heads(int D) {
  return kMaxGroup * D / 4 / kThreads > 0 ? kMaxGroup * D / 4 / kThreads : 1;
}

// The scores of a staged K tile: thread (key t, head group) forms q.k of
// its key for heads hg, hg + HG, ... in fp32 FMAs, d ascending; scaled
// (int8: times the key's scale first) to exp2 units, NEG_INF where the key
// is not visible (unallocated, past the table or outside [lo, hi]).
// Passes 1 and 2 call it alike, so their scores are bitwise the same.
template <typename PT, int D>
__device__ __forceinline__ void tile_scores(const float* q_s,
                                            const unsigned char* k_t,
                                            const int* pg, const float* ks,
                                            int kt0, int lo, int hi, int G,
                                            float scale_log2, float* sc,
                                            int tid) {
  constexpr bool kQuant = std::is_same<PT, int8_t>::value;
  constexpr int KT = key_tile(D), HG = kThreads / KT, NH = kMaxGroup / HG;
  constexpr int RAW = kQuant ? D + 16 : (D + kPad) * 2;
  constexpr int VEC = PageLoad<PT>::kVec;
  const int t = tid % KT, hg = tid / KT;
  float acc[NH];
#pragma unroll
  for (int i = 0; i < NH; ++i) acc[i] = 0.f;
  const PT* kr = reinterpret_cast<const PT*>(k_t + t * RAW);
#pragma unroll 2
  for (int c = 0; c < D; c += VEC) {
    float kv[VEC];
    PageLoad<PT>::run(kr + c, kv, 1.f);
#pragma unroll
    for (int i = 0; i < NH; ++i) {
      const int g = hg + i * HG;
      if (g < G) {
        const float* qr = q_s + g * D + c;
#pragma unroll
        for (int e = 0; e < VEC; ++e) acc[i] = fmaf(qr[e], kv[e], acc[i]);
      }
    }
  }
  const int k = kt0 + t;
  const bool ok = pg[t] >= 0 && k >= lo && k <= hi;
#pragma unroll
  for (int i = 0; i < NH; ++i) {
    const int g = hg + i * HG;
    if (g < G) {
      float x = acc[i];
      if constexpr (kQuant) x = __fmul_rn(x, ks[t]);
      sc[g * (KT + 1) + t] = ok ? __fmul_rn(x, scale_log2) : kNegInf;
    }
  }
}

// o += p v over a staged V tile: thread (column quad, head group) holds
// four columns of heads hg, hg + HG, ...; pr [G][KT + 1] the
// probabilities (int8 pages: times the row's v scale).
template <typename PT, int D>
__device__ __forceinline__ void tile_values(float (&o)[value_heads(D)][4],
                                            const float* pr,
                                            const unsigned char* v_t, int G,
                                            int tid) {
  constexpr bool kQuant = std::is_same<PT, int8_t>::value;
  constexpr int KT = key_tile(D), CQ = D / 4, HG = kThreads / CQ;
  constexpr int RAW = kQuant ? D + 16 : (D + kPad) * 2;
  const int cq = tid % CQ, hg = tid / CQ;
#pragma unroll 4
  for (int t = 0; t < KT; ++t) {
    float v[4];
    load4(reinterpret_cast<const PT*>(v_t + t * RAW) + cq * 4, v);
#pragma unroll
    for (int i = 0; i < value_heads(D); ++i) {
      const int g = hg + i * HG;
      if (g < G) {
        const float p = pr[g * (KT + 1) + t];
#pragma unroll
        for (int e = 0; e < 4; ++e) o[i][e] = fmaf(p, v[e], o[i][e]);
      }
    }
  }
}

// Pass 1 (kValues false: scores, split-local m and l) or pass 2 (kValues:
// merge, rounded p, p v, and the combine in the last CTA to arrive) of one
// (split, kv head, slot); PT: bf16 or int8 pages.
template <typename PT, int D, bool kValues>
// (a minimum of one CTA an SM lifts ptxas's register cap for 128 threads,
// under which pass 2 spilled 4-12 bytes at D 16-256)
__global__ void __launch_bounds__(kThreads, 1) decode_split(const Args a) {
  constexpr bool kQuant = std::is_same<PT, int8_t>::value;
  constexpr int KT = key_tile(D), SCP = KT + 1;
  constexpr int RAW = kQuant ? D + 16 : (D + kPad) * 2;  // bytes a row
  constexpr int CH = D * int(sizeof(PT)) / 16;  // 16-byte copies a row
  extern __shared__ __align__(16) unsigned char sm[];
  __shared__ int flag;
  const int G = a.H / a.Hkv;
  const Smem L = smem_layout(kQuant, D, G, a.split_keys, a.splits, a.bs);
  const int s = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int bh = b * a.Hkv + h;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int S = a.NB * a.bs;
  const int k0 = s * a.split_keys, k1 = min(k0 + a.split_keys, S);
  const size_t ml0 = static_cast<size_t>(bh) * a.splits;  // split 0's row
  if (!kValues && a.splits > 1 && s == 0 && tid == 0) a.arrived[bh] = 0;

  float* m_s = reinterpret_cast<float*>(sm + L.m);
  float* l_s = reinterpret_cast<float*>(sm + L.l);
  if constexpr (kValues) {
    // every split's (m_i, l_i), in flight before anything waits
    for (int i = tid; i < a.splits * G; i += kThreads) {
      cp_async4(m_s + i, a.m + ml0 * G + i, 4);
      cp_async4(l_s + i, a.l + ml0 * G + i, 4);
    }
    tc::cp_async_commit();
  }
  // pos, the split's block-table entries and q are loaded together (none
  // waits on another), before a CTA whose split holds no visible key
  // leaves
  const int p0 = a.pos[b];
  int* bt_s = reinterpret_cast<int*>(sm + L.bt);
  const int e0 = k0 / a.bs, ne = (k1 - 1) / a.bs - e0 + 1;
  for (int i = tid; i < ne; i += kThreads)
    bt_s[i] = a.block_tables[static_cast<size_t>(b) * a.NB + e0 + i];
  float* q_s = reinterpret_cast<float*>(sm + L.q);
  const uint4* qb = reinterpret_cast<const uint4*>(
      a.q + (static_cast<size_t>(b) * a.H + static_cast<size_t>(h) * G) * D);
  for (int i = tid; i < G * D / 8; i += kThreads) {
    const uint4 r = qb[i];
    const bf16* e = reinterpret_cast<const bf16*>(&r);
#pragma unroll
    for (int x = 0; x < 8; ++x) q_s[8 * i + x] = __bfloat162float(e[x]);
  }
  // the keys the query sees: [lo, hi] (none where hi < lo)
  const int hi = min(p0, S - 1);
  const int lo = a.window > 0 ? max(0, p0 - a.window + 1) : 0;
  const bool live = max(k0, lo) <= min(k1 - 1, hi);
  if (!kValues && !live) {  // (NEG_INF, 0): the merge skips the split
    if (tid < G) {
      a.m[(ml0 + s) * G + tid] = kNegInf;
      a.l[(ml0 + s) * G + tid] = 0.f;
    }
    return;
  }
  __syncthreads();  // bt_s, q_s

  int* page_s = reinterpret_cast<int*>(sm + L.page);
  float* ks_s = reinterpret_cast<float*>(sm + L.k_scale);
  float* vs_s = reinterpret_cast<float*>(sm + L.v_scale);
  unsigned char* k_raw = sm + L.k_raw;
  unsigned char* v_raw = sm + L.v_raw;
  const PT* kp = static_cast<const PT*>(a.k_pages);
  const PT* vp = static_cast<const PT*>(a.v_pages);
  // tile j of the split into ring stage st: K rows of allocated entries
  // (want_k), V rows of every key of the table, -1 entries from the null
  // page 0 (want_v), and their scales, the rest zero-filled; and each
  // key's page entry (-1 unallocated, kNoKey past the table), read after
  // the barrier that follows the copies' wait.  No barrier of its own: a
  // thread finds the page of each row it copies in bt_s.
  auto load_tile = [&](int j, int st, bool want_k, bool want_v) {
    const int kt0 = k0 + j * KT;
    for (int i = tid; i < KT * CH; i += kThreads) {
      const int t = i / CH, c = i % CH, k = kt0 + t;
      const int page = k < S ? bt_s[k / a.bs - e0] : kNoKey;
      const int row = (max(page, 0) * a.bs + k % a.bs) * a.Hkv + h;
      if (c == 0) {
        page_s[st * KT + t] = page;
        if constexpr (kQuant) {
          if (want_k)
            cp_async4(ks_s + st * KT + t, a.k_scales + (page >= 0 ? row : 0),
                      page >= 0 ? 4 : 0);
          if (want_v)
            cp_async4(vs_s + st * KT + t,
                      a.v_scales + (page >= -1 ? row : 0),
                      page >= -1 ? 4 : 0);
        }
      }
      const size_t el = static_cast<size_t>(row) * D +
                        c * (16 / int(sizeof(PT)));
      const int dst = (st * KT + t) * RAW + c * 16;
      if (want_k)
        tc::cp_async16(k_raw + dst, kp + (page >= 0 ? el : 0),
                       page >= 0 ? 16 : 0);
      if (want_v)
        tc::cp_async16(v_raw + dst, vp + (page >= -1 ? el : 0),
                       page >= -1 ? 16 : 0);
    }
  };

  // the key tiles (of KT keys from k0) that hold a visible key
  const int jv_lo = live ? (max(k0, lo) - k0) / KT : 0;
  const int jv_hi = live ? (min(k1 - 1, hi) - k0) / KT : -1;
  if (live) load_tile(jv_lo, 0, true, kValues);
  tc::cp_async_commit();

  float* mf_s = reinterpret_cast<float*>(sm + L.mf);
  float* il_s = reinterpret_cast<float*>(sm + L.il);
  bool dead = false;  // the slot sees no key at all
  if constexpr (kValues) {
    // every split's (m_i, l_i) of each head merged in split order, a warp
    // a head: lane t takes split t, then every lane adds the terms in
    // split order
    tc::cp_async_wait<1>();
    __syncthreads();
#pragma unroll
    for (int i = 0; i < kMaxGroup / kWarps; ++i) {
      const int g = warp + i * kWarps;
      if (g < G) {
        const bool in = lane < a.splits;
        const float mi = in ? m_s[lane * G + g] : kNegInf;
        const float li = in ? l_s[lane * G + g] : 0.f;
        const float mx = warp_max(li > 0.f ? mi : kNegInf);
        const float term = li > 0.f ? li * exp2f(mi - mx) : 0.f;
        float sum = 0.f;  // every shuffle issued before the adds wait
#pragma unroll
        for (int t = 0; t < kMaxSplits; ++t) {
          const float x = __shfl_sync(0xffffffffu, term, t);
          if (t < a.splits) sum += x;
        }
        if (lane == 0) {
          // sum >= 1 where it is not 0 (the split holding the max adds
          // l_i >= 1 at exp2(0)): the fast reciprocal is within 2 ulp
          mf_s[g] = mx;
          il_s[g] = sum > 0.f ? __fdividef(1.f, sum) : 0.f;
          if (g == 0) flag = sum == 0.f;
        }
      }
    }
    __syncthreads();
    dead = flag;
  }
  // pass 2 of a slot with no visible key reads every key of the split
  // (their mean) instead of scoring; the tile prefetched above is reloaded
  // unless it is the split's first
  const bool scores = live && !dead;
  int j_lo = jv_lo, j_hi = jv_hi;
  if (kValues && dead) {
    j_lo = 0;
    j_hi = (k1 - 1 - k0) / KT;
    if (!live || jv_lo != 0) {
      tc::cp_async_wait<0>();
      __syncthreads();
      load_tile(0, 0, false, true);
      tc::cp_async_commit();
    }
  }

  float* sc = reinterpret_cast<float*>(sm + L.sc);
  const float uniform = round_p<PT>(a.inv_keys);
  constexpr int NW = kMaxGroup / kWarps;  // heads a warp reduces (pass 1)
  float m_run[NW], l_run[NW];
#pragma unroll
  for (int i = 0; i < NW; ++i) {
    m_run[i] = kNegInf;
    l_run[i] = 0.f;
  }
  float o[value_heads(D)][4] = {};
  for (int j = j_lo; j <= j_hi; ++j) {
    const int st = (j - j_lo) & 1;
    if (j < j_hi) load_tile(j + 1, st ^ 1, scores, kValues);
    tc::cp_async_commit();
    tc::cp_async_wait<1>();
    __syncthreads();
    const int* pg = page_s + st * KT;
    if (scores)
      tile_scores<PT, D>(q_s, k_raw + st * KT * RAW, pg, ks_s + st * KT,
                         k0 + j * KT, lo, hi, G, a.scale_log2, sc, tid);
    __syncthreads();
    if constexpr (!kValues) {
      // split-local max and sum of each head, online over the tiles, a
      // warp a head; masked keys add 0
#pragma unroll
      for (int i = 0; i < NW; ++i) {
        const int g = warp + i * kWarps;
        if (g < G) {
          const float* sr = sc + g * SCP;
          float mx = kNegInf;
          for (int t = lane; t < KT; t += 32) mx = fmaxf(mx, sr[t]);
          mx = warp_max(mx);
          const float m_new = fmaxf(m_run[i], mx);
          const float corr =
              m_run[i] > kMasked ? exp2f(m_run[i] - m_new) : 1.f;
          float sum = 0.f;
          for (int t = lane; t < KT; t += 32)
            sum += sr[t] > kMasked ? exp2f(sr[t] - m_new) : 0.f;
          l_run[i] = l_run[i] * corr + warp_sum(sum);
          m_run[i] = m_new;
        }
      }
    } else {
      // p with the merged (m, l), rounded as the plain version rounds it
      // (a masked score gives exp2(-1e30 - m) = 0); a slot with no visible
      // key takes 1/S on every key of the table
      for (int i = tid; i < G * KT; i += kThreads) {
        const int g = i / KT, t = i % KT;
        float pr = scores ? round_p<PT>(exp2f(sc[g * SCP + t] - mf_s[g]) *
                                        il_s[g])
                          : (pg[t] >= -1 ? uniform : 0.f);
        if constexpr (kQuant) pr *= vs_s[st * KT + t];
        sc[g * SCP + t] = pr;
      }
      __syncthreads();
      tile_values<PT, D>(o, sc, v_raw + st * KT * RAW, G, tid);
    }
    __syncthreads();  // this stage is overwritten by the tile after next
  }
  tc::cp_async_wait<0>();

  if constexpr (!kValues) {
    if (lane == 0) {
#pragma unroll
      for (int i = 0; i < NW; ++i) {
        const int g = warp + i * kWarps;
        if (g < G) {
          a.m[(ml0 + s) * G + g] = m_run[i];
          a.l[(ml0 + s) * G + g] = l_run[i];
        }
      }
    }
  } else {
    constexpr int CQ = D / 4, HG = kThreads / CQ;
    const int cq = tid % CQ, hg = tid / CQ;
    if (j_lo <= j_hi) {  // this split's partial (or, alone, the output)
#pragma unroll
      for (int i = 0; i < value_heads(D); ++i) {
        const int g = hg + i * HG;
        if (g >= G) continue;
        if (a.splits == 1) {
          bf16* dst = a.out + (static_cast<size_t>(b) * a.H + h * G + g) *
                                  D + cq * 4;
          store2(dst, o[i][0], o[i][1]);
          store2(dst + 2, o[i][2], o[i][3]);
        } else {
          *reinterpret_cast<float4*>(a.partial + ((ml0 + s) * G + g) * D +
                                     cq * 4) =
              make_float4(o[i][0], o[i][1], o[i][2], o[i][3]);
        }
      }
    }
    if (a.splits == 1) return;
    // the last CTA of the (slot, kv head) to arrive sums the partials
    __threadfence();
    __syncthreads();
    if (tid == 0) flag = atomicAdd(a.arrived + bh, 1) == a.splits - 1;
    __syncthreads();
    if (!flag) return;
    __threadfence();
    // the splits that wrote a partial: those holding a visible key, every
    // split for a slot with none
    unsigned writers = 0;
    for (int t = 0; t < a.splits; ++t) {
      const int t0 = t * a.split_keys, t1 = min(t0 + a.split_keys, S);
      writers |= unsigned(dead || max(t0, lo) <= min(t1 - 1, hi)) << t;
    }
    const size_t stride = static_cast<size_t>(G) * D;
    const float4* src =
        reinterpret_cast<const float4*>(a.partial + ml0 * stride);
    bf16* dst = a.out + (static_cast<size_t>(b) * a.H + h * G) * D;
    constexpr int kUnroll = 8;  // loads issued before their sums
    for (int i = tid; i < G * D / 4; i += kThreads) {
      float4 sum = make_float4(0.f, 0.f, 0.f, 0.f);
      for (int t0 = 0; t0 < a.splits; t0 += kUnroll) {
        float4 x[kUnroll];
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          const int t = t0 + u;
          x[u] = t < a.splits && (writers >> t & 1u)
                     ? __ldcg(src + t * stride / 4 + i)
                     : make_float4(0.f, 0.f, 0.f, 0.f);
        }
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          sum.x += x[u].x;
          sum.y += x[u].y;
          sum.z += x[u].z;
          sum.w += x[u].w;
        }
      }
      store2(dst + 4 * i, sum.x, sum.y);
      store2(dst + 4 * i + 2, sum.z, sum.w);
    }
  }
}

template <typename PT, int D>
int launch_split(const Args& a, int B, cudaStream_t stream) {
  const int bytes = smem_layout(std::is_same<PT, int8_t>::value, D,
                                a.H / a.Hkv, a.split_keys, a.splits, a.bs)
                        .bytes;
  auto scores = decode_split<PT, D, false>;
  auto values = decode_split<PT, D, true>;
  if (bytes > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        scores, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(
          values, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const dim3 grid(a.splits, a.Hkv, B);
  scores<<<grid, kThreads, bytes, stream>>>(a);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  values<<<grid, kThreads, bytes, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <typename PT>
int launch_dim(const Args& a, int B, int D, cudaStream_t s) {
  switch (D) {
    case 16:
      return launch_split<PT, 16>(a, B, s);
    case 32:
      return launch_split<PT, 32>(a, B, s);
    case 64:
      return launch_split<PT, 64>(a, B, s);
    case 128:
      return launch_split<PT, 128>(a, B, s);
    case 256:
      return launch_split<PT, 256>(a, B, s);
    default:
      return -1;
  }
}

}  // namespace

extern "C" {

// Keys per staged tile of the bf16-q kernel at head dim D (its split keys
// are a multiple).
int paged_decode_key_tile(int D) { return key_tile(D); }

// Bytes of dynamic shared memory one CTA of the bf16-q passes needs
// (page_dtype: 0 bf16, 1 int8); the wrapper checks it against the card's
// 227 KB before launching.
int paged_decode_smem_bytes(int page_dtype, int D, int G, int split_keys,
                            int splits, int bs) {
  return smem_layout(page_dtype == 1, D, G, split_keys, splits, bs).bytes;
}

// Which hand-written instantiation runs for q's dtype (0 fp32, 1 bf16).
const char* paged_decode_variant(int q_dtype) {
  return q_dtype == 1
             ? "bf16 CUDA-core split-KV, two launches (scores; values with "
               "p rounded against the merged max and sum, the last CTA "
               "summing the partials in split order)"
             : "fp32 CUDA-core FMAs, two walks (one CTA a slot and kv head)";
}

// bf16 queries.  q [B, H, D] bf16 (the output too); page_dtype: 0 bf16,
// 1 int8 (k_scales/v_scales then point at fp32 [P, bs, Hkv]).  All tensors
// contiguous; block_tables [B, NB] and pos [B] int32.  The plan
// (kernels/paged_decode.py:plan): split_keys a multiple of
// paged_decode_key_tile(D), splits = ceil(NB * bs / split_keys) <= 32.
// m and l: fp32 scratch of B * Hkv * splits * G floats each; partial: of
// that times D, 16-byte aligned; arrived: B * Hkv ints (both unused with
// one split).  Returns cudaGetLastError() after the launches, or -1 for a
// bad code or plan.
int paged_decode_launch(int page_dtype, const void* q, const void* k_pages,
                        const void* v_pages, const void* k_scales,
                        const void* v_scales, const void* block_tables,
                        const void* pos, void* m, void* l, void* partial,
                        void* arrived, void* out, int B, int H, int Hkv,
                        int D, int bs, int NB, int window, int split_keys,
                        int splits, float scale, void* stream) {
  const int S = NB * bs;
  if (S <= 0 || Hkv <= 0 || H % Hkv || H / Hkv > kMaxGroup ||
      split_keys <= 0 || split_keys % key_tile(D) ||
      splits != (S + split_keys - 1) / split_keys || splits > kMaxSplits ||
      (splits > 1 && (partial == nullptr || arrived == nullptr)))
    return -1;
  const Args a{static_cast<const bf16*>(q),
               k_pages,
               v_pages,
               static_cast<const float*>(k_scales),
               static_cast<const float*>(v_scales),
               static_cast<const int32_t*>(block_tables),
               static_cast<const int32_t*>(pos),
               static_cast<float*>(m),
               static_cast<float*>(l),
               static_cast<float*>(partial),
               static_cast<int*>(arrived),
               static_cast<bf16*>(out),
               H,
               Hkv,
               bs,
               NB,
               window,
               split_keys,
               splits,
               scale * 1.4426950408889634f,
               1.f / static_cast<float>(S)};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (page_dtype) {
    case 0:
      return launch_dim<bf16>(a, B, D, s);
    case 1:
      return launch_dim<int8_t>(a, B, D, s);
    default:
      return -1;
  }
}

// fp32 queries: bytes of dynamic shared memory one CTA of the two-walk
// kernel needs, with score_words floats of scores kept there (G*NB*bs, or
// 0 when they go to global memory).
int paged_decode_fp32_smem_bytes(int G, int D, int bs, int score_words) {
  return static_cast<int>(sizeof(float)) * smem_floats(G, D, bs, score_words);
}

// fp32 queries: q and out [B, H, D] fp32, pages and tables as above.
// scores: null keeps the scores in shared memory; else fp32 scratch of
// B*H*NB*bs floats in global memory.  Returns cudaGetLastError() after the
// launch, or -1 for a bad dtype code.
int paged_decode_fp32_launch(int page_dtype, const void* q,
                             const void* k_pages, const void* v_pages,
                             const void* k_scales, const void* v_scales,
                             const void* block_tables, const void* pos,
                             void* scores, void* out, int B, int H, int Hkv,
                             int D, int bs, int NB, int window, float scale,
                             void* stream) {
  return launch_pages<float>(page_dtype, q, k_pages, v_pages, k_scales,
                             v_scales, block_tables, pos, scores, out, B, H,
                             Hkv, D, bs, NB, window, scale,
                             static_cast<cudaStream_t>(stream));
}

}  // extern "C"
