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
// bf16 and int8 pools) the keys are split across CTAs: the grid is
// (split, kv head, slot), the NB*bs keys of the table cut into splits of
// whole key tiles so that a call runs about two CTAs per SM, at most 32
// splits, by a plan from the shapes alone (kernels/paged_decode.py:plan,
// the rule paged verify's plan uses at T = 1: pos is never read on the
// host), in two launches: split-local max and sum; then the merge, p
// rounded against the merged max and sum, p v, and the last CTA of each
// (slot, kv head) summing the partials in split order.  Those passes are
// split_decode.cuh's, which flash_decode.cu shares; this file gives them
// their key source (PagedKeys below: the block-table entries of the
// split are staged first, K and V rows read in place through the
// [P, bs, Hkv, D] strides, and a CTA whose split lies wholly past pos, or
// before the window, exits at once).  Rows with no visible key take
// p = 1/(NB*bs) on each key of the table (-1 entries read page 0).
// fp32 queries (the tests, fp32 parity runs) run the two-walk kernel
// below instead (one CTA per (slot, kv head), scores stored in shared or
// global memory, m and l from the stored scores, then V), whose
// arithmetic paged verify's fp32 kernel shares: test_torch_speculative.py
// holds the two to 1e-4, which sums merged across splits break.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "split_decode.cuh"

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

// Keys through the block table (the key source of split_decode.cuh's
// passes): key k lies in page block_tables[b, k / bs], row k % bs.  Its
// entry is the page (-1 unallocated, kNoKey past the table); K rows are
// read from allocated pages, V rows also for -1 entries, from the null page
// 0 (a row with no visible key averages them, as the plain version's
// gather does).  The keys the query may see follow from pos and the
// window alone: [max(0, pos - window + 1), min(pos, S - 1)].
struct PagedKeys {
  static constexpr int kMinLiveV = -1;
  // the split's block-table entries
  __host__ __device__ static int map_words(int split_keys, int bs) {
    return split_keys / bs + 2;
  }
  const int* bt_s;
  int e0, h;

  __device__ void stage(const split_kv::Args& a, int b, int h_, int k0,
                        int k1, int, int* map_s, int tid) {
    bt_s = map_s;
    h = h_;
    e0 = k0 / a.bs;
    const int ne = (k1 - 1) / a.bs - e0 + 1;
    for (int i = tid; i < ne; i += split_kv::kThreads)
      map_s[i] = a.map[static_cast<size_t>(b) * a.NB + e0 + i];
  }
  __device__ void visible(const split_kv::Args& a, int p0, int, int, int& lo,
                          int& hi) const {
    hi = min(p0, a.S - 1);
    lo = a.window > 0 ? max(0, p0 - a.window + 1) : 0;
  }
  __device__ int entry(const split_kv::Args& a, int k) const {
    return k < a.S ? bt_s[k / a.bs - e0] : split_kv::kNoKey;
  }
  __device__ int row(const split_kv::Args& a, int k, int e) const {
    return (max(e, 0) * a.bs + k % a.bs) * a.Hkv + h;
  }
};

template <typename PT>
int launch_dim(const split_kv::Args& a, int B, int D, cudaStream_t s) {
  using split_kv::launch_split;
  switch (D) {
    case 16:
      return launch_split<PagedKeys, PT, 16>(a, B, s);
    case 32:
      return launch_split<PagedKeys, PT, 32>(a, B, s);
    case 64:
      return launch_split<PagedKeys, PT, 64>(a, B, s);
    case 128:
      return launch_split<PagedKeys, PT, 128>(a, B, s);
    case 256:
      return launch_split<PagedKeys, PT, 256>(a, B, s);
    default:
      return -1;
  }
}


}  // namespace

extern "C" {

// Keys per staged tile of the bf16-q kernel at head dim D (its split keys
// are a multiple).
int paged_decode_key_tile(int D) { return split_kv::key_tile(D); }

// Bytes of dynamic shared memory one CTA of the bf16-q passes needs
// (page_dtype: 0 bf16, 1 int8); the wrapper checks it against the card's
// 227 KB before launching.
int paged_decode_smem_bytes(int page_dtype, int D, int G, int split_keys,
                            int splits, int bs) {
  return split_kv::smem_bytes<PagedKeys>(page_dtype == 1, D, G, split_keys,
                                         splits, bs);
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
  if (!split_kv::plan_ok(S, H, Hkv, D, split_keys, splits, partial, arrived))
    return -1;
  const split_kv::Args a{static_cast<const split_kv::bf16*>(q),
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
                         static_cast<split_kv::bf16*>(out),
                         H,
                         Hkv,
                         S,
                         window,
                         bs,
                         NB,
                         split_keys,
                         splits,
                         scale * 1.4426950408889634f,
                         1.f / static_cast<float>(S)};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (page_dtype) {
    case 0:
      return launch_dim<split_kv::bf16>(a, B, D, s);
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
