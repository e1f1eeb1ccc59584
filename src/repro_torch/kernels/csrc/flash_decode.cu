// Flash decode for Hopper (sm_90a): one query token per slot against a
// contiguous per-slot KV cache, masked by the position each cache entry
// holds.
//
// Replaces the Pallas TPU kernels flash_decode_tpu and
// flash_decode_quant_tpu (repro/kernels/flash_decode.py:71,125).  One
// source covers both: the cache type is a template parameter (bf16 caches,
// the dense serving cache and the speculative draft's; int8 caches with
// fp32 per-row scales multiplied in right after the load, as the JAX
// package's _quant_kernel reuses _kernel; fp32 caches, which the JAX
// kernel tests sweep), and q is fp32 or bf16.
//
// What it computes, per slot b and query head h (kv head h / G):
//   key s (cache row s of slot b) is visible iff cpos = cache_positions
//   [b, s] >= 0, cpos <= pos[b] and, when window > 0, pos[b] - cpos <
//   window; out = softmax(q.k * D^-0.5) . v over the visible keys, with
//   the softmax in fp32 and each probability rounded to the cache type
//   before the value product, as the plain version (the JAX package's
//   decode_attention) does: bf16 for bf16 caches, fp32 for fp32 and
//   dequantized int8 ones.  The Pallas kernel keeps fp32 probabilities;
//   the plain version's rounding is what the CPU computes, and an MoE
//   router amplifies the ~1e-3 difference into other experts.  A row with
//   no visible key (a free slot) gets what the plain version and the
//   Pallas kernel give it: the uniform softmax over the NEG_INF fills of
//   all S entries, i.e. the mean of the slot's S value rows (the weight
//   1/S rounded as above).  Nobody reads such a row's attention, but an
//   MoE layer routes its token, which competes with the live tokens for
//   each expert's capacity.  pos is only compared, never used as an
//   index: a parked slot at pos = max_seq reads nothing out of bounds.
//
// What bounds it on an H100: the bytes of the visible K/V rows, each used
// for ~4*G flops per element, far under the ~295 flops per byte at which
// the bf16 tensor cores would become the limit.  At a decode tick those
// bytes are few (B 8 slots of 60-1000 keys at qwen2-0.5b's widths: 2 MB,
// 0.6 us at 3.35 TB/s), so what the design has to beat is latency.  Two
// hand-written instantiations, chosen by the types (kernels/
// flash_decode.py:variant names them):
//   * bf16 queries over bf16 or int8 caches (every serving path: the dense
//     backend's decode, the speculative draft's, zamba2's shared
//     attention): split_decode.cuh's split-KV passes, which paged decode
//     shares.  The grid is (split, kv head, slot), the S keys of a row cut
//     into splits of whole key tiles so that a call runs about two CTAs an
//     SM, at most 32 splits, by a plan from the shapes alone
//     (kernels/flash_decode.py:plan, paged decode's rule; pos and
//     cache_positions are never read on the host); two launches: each
//     split's local max and sum, then the merge, p rounded against the
//     merged max and sum, p v, and the last CTA of each (slot, kv head)
//     summing the partials in split order.  Which keys a query sees comes
//     from the data, not the shape (-1 past each prompt, holes, stale
//     entries past pos after a rejected draft chain), so the key source
//     (DenseKeys below) stages the split's cache_positions first, with pos
//     and q, and marks each key visible or not: a split with no visible
//     key exits at once in pass 1, a tile with none loads nothing, K and V
//     rows of masked keys are never read (zero-filled), and the splits that
//     wrote a partial are those whose merged sum l_i > 0.  K and V rows are
//     read in place through the [B, S, Hkv, D] strides (row (b*S + s)*Hkv
//     + h), each staged row serving all G query heads of its kv head.  A row
//     with no visible key reads every value row (and, int8, its scale) of
//     its slot.
//   * fp32 queries (the tests, fp32 parity engines) or fp32 caches (the JAX
//     kernel sweep, which no serving path runs): the two-walk kernel below.
//     One CTA per (slot, kv head) walks the tiles twice.  The first walk
//     reads each tile's cache_positions, loads only visible K rows and
//     keeps every fp32 score of its G heads in a scratch row (shared
//     memory, G*S*4 bytes: 28 KB at G 7 and S 1024; global memory, written
//     and read by this CTA alone, where that does not fit); the max m and
//     sum l of each head then come from the stored scores as the plain
//     version's softmax computes them.  The second walk reads V only, forms
//     each probability exp(s - m) / l from the stored score, rounds it, and
//     accumulates p * v in fp32.  The ragged tail of S is masked per
//     element.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

#include "split_decode.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kTile = 64;  // keys per staged tile
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

// One 16-byte load of cache elements, widened to fp32 (times the row scale
// for int8 caches, the same product as dequantize_kv).
template <typename CT>
struct CacheLoad;

template <>
struct CacheLoad<float> {
  static constexpr int kVec = 4;
  __device__ static void run(const float* src, float* dst, float) {
    const float4 raw = *reinterpret_cast<const float4*>(src);
    dst[0] = raw.x;
    dst[1] = raw.y;
    dst[2] = raw.z;
    dst[3] = raw.w;
  }
};

template <>
struct CacheLoad<__nv_bfloat16> {
  static constexpr int kVec = 8;
  __device__ static void run(const __nv_bfloat16* src, float* dst, float) {
    const uint4 raw = *reinterpret_cast<const uint4*>(src);
    const __nv_bfloat16* e = reinterpret_cast<const __nv_bfloat16*>(&raw);
#pragma unroll
    for (int i = 0; i < kVec; ++i) dst[i] = __bfloat162float(e[i]);
  }
};

template <>
struct CacheLoad<int8_t> {
  static constexpr int kVec = 16;
  __device__ static void run(const int8_t* src, float* dst, float scale) {
    const uint4 raw = *reinterpret_cast<const uint4*>(src);
    const int8_t* e = reinterpret_cast<const int8_t*>(&raw);
#pragma unroll
    for (int i = 0; i < kVec; ++i) dst[i] = static_cast<float>(e[i]) * scale;
  }
};

__device__ __forceinline__ float value(const float* p, size_t i) {
  return p[i];
}
__device__ __forceinline__ float value(const __nv_bfloat16* p, size_t i) {
  return __bfloat162float(p[i]);
}
__device__ __forceinline__ float value(const int8_t* p, size_t i) {
  return static_cast<float>(p[i]);
}

// A probability as it multiplies v: rounded to the cache type where the
// cache is bf16, as the plain version rounds it (int8 caches are
// dequantized to fp32 first, fp32 caches stay fp32).
template <typename CT>
__device__ __forceinline__ float round_p(float p) {
  return p;
}
template <>
__device__ __forceinline__ float round_p<__nv_bfloat16>(float p) {
  return __bfloat162float(__float2bfloat16(p));
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

// Keys one CTA keeps scores for: S rounded up to whole tiles.
__host__ __device__ inline int padded_keys(int S) {
  return (S + kTile - 1) / kTile * kTile;
}

// Shared memory, in 4-byte words: q [G][D], the K then V tile [kTile][D+1]
// (padded so that threads reading different keys hit different banks),
// acc [G][D], m and l [G] each, the tile's visibility flags [kTile], then,
// unless they go to global memory, the scores [G][padded_keys(S)]
// (score_words of them).
__host__ __device__ inline int smem_words(int G, int D, int score_words) {
  return G * D + kTile * (D + 1) + G * D + 2 * G + kTile + score_words;
}

template <typename QT, typename CT>
__global__ void __launch_bounds__(kThreads) flash_decode_kernel(
    const QT* __restrict__ q, const CT* __restrict__ k_cache,
    const CT* __restrict__ v_cache, const float* __restrict__ k_scales,
    const float* __restrict__ v_scales,
    const int32_t* __restrict__ cache_positions,
    const int32_t* __restrict__ pos, float* scores, QT* __restrict__ out,
    int H, int Hkv, int D, int S, int window, float scale) {
  extern __shared__ float smem[];
  const int G = H / Hkv;
  const int h = blockIdx.x;  // kv head
  const int b = blockIdx.y;  // slot
  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int Dp = D + 1;
  const int Sp = padded_keys(S);
  float* q_s = smem;
  float* tile = q_s + G * D;
  float* acc = tile + kTile * Dp;
  float* m_s = acc + G * D;
  float* l_s = m_s + G;
  int* ok_s = reinterpret_cast<int*>(l_s + G);
  // score of head g and key s at sc[g * Sp + s]: this CTA's own rows
  float* sc = scores != nullptr
                  ? scores + (static_cast<size_t>(b) * Hkv + h) * G * Sp
                  : reinterpret_cast<float*>(ok_s + kTile);

  // the G query heads of kv head h are rows h*G .. h*G+G-1 of q[b]
  const QT* qb = q + (static_cast<size_t>(b) * H + static_cast<size_t>(h) * G) * D;
  for (int i = tid; i < G * D; i += kThreads) {
    q_s[i] = to_float(qb[i]);
    acc[i] = 0.f;
  }
  __syncthreads();

  const int p = pos[b];
  const int32_t* cp = cache_positions + static_cast<size_t>(b) * S;
  // row (b, s, h) of the [B, S, Hkv, D] cache is row0 + s * Hkv
  const size_t row0 = static_cast<size_t>(b) * S * Hkv + h;
  constexpr int kVec = CacheLoad<CT>::kVec;
  const int vecs_per_row = D / kVec;

  // walk 1: the scores of every tile (K only); masked keys score kNegInf
  for (int s0 = 0; s0 < S; s0 += kTile) {
    int any = 0;
    for (int t = tid; t < kTile; t += kThreads) {
      int ok = 0;
      if (s0 + t < S) {
        const int c = cp[s0 + t];
        ok = c >= 0 && c <= p && (window == 0 || p - c < window);
      }
      ok_s[t] = ok;
      any |= ok;
    }
    // a tile with no visible key loads nothing
    if (__syncthreads_or(any)) {
      for (int i = tid; i < kTile * vecs_per_row; i += kThreads) {
        const int t = i / vecs_per_row;
        if (!ok_s[t]) continue;
        const int c = (i % vecs_per_row) * kVec;
        const size_t row = row0 + static_cast<size_t>(s0 + t) * Hkv;
        const float ks = k_scales != nullptr ? k_scales[row] : 1.f;
        CacheLoad<CT>::run(k_cache + row * D + c, tile + t * Dp + c, ks);
      }
      __syncthreads();
    }
    for (int i = tid; i < G * kTile; i += kThreads) {
      const int g = i / kTile, t = i % kTile;
      float s = kNegInf;
      if (ok_s[t]) {
        const float* qr = q_s + g * D;
        const float* kr = tile + t * Dp;
        float dot = 0.f;
        for (int d = 0; d < D; ++d) dot = fmaf(qr[d], kr[d], dot);
        s = dot * scale;
      }
      sc[g * Sp + s0 + t] = s;
    }
    __syncthreads();  // the tile and flags are overwritten by the next one
  }

  // max and sum of each head over its stored scores, one warp per head;
  // masked keys add 0, so a head that sees no key keeps l = 0
  for (int g = warp; g < G; g += kWarps) {
    const float* sr = sc + g * Sp;
    float mx = kNegInf;
    for (int s = lane; s < Sp; s += 32) mx = fmaxf(mx, sr[s]);
    mx = warp_max(mx);
    float sum = 0.f;
    for (int s = lane; s < Sp; s += 32)
      sum += sr[s] > kNegInf ? expf(sr[s] - mx) : 0.f;
    sum = warp_sum(sum);
    if (lane == 0) {
      m_s[g] = mx;
      l_s[g] = sum;
    }
  }
  __syncthreads();

  QT* ob = out + (static_cast<size_t>(b) * H + static_cast<size_t>(h) * G) * D;
  if (l_s[0] == 0.f) {  // no visible key (for every head alike)
    const float w = round_p<CT>(1.f / static_cast<float>(S));
    for (int d = tid; d < D; d += kThreads) {
      float a = 0.f;
      for (int s = 0; s < S; ++s) {
        const size_t row = row0 + static_cast<size_t>(s) * Hkv;
        const float vs = v_scales != nullptr ? v_scales[row] : 1.f;
        a = fmaf(w, value(v_cache, row * D + d) * vs, a);
      }
      for (int g = 0; g < G; ++g) ob[g * D + d] = from_float<QT>(a);
    }
    return;
  }

  // walk 2: V only, over the tiles with a visible key (a key is visible
  // iff its score is not kNegInf, for every head alike); each stored score
  // becomes its rounded probability
  for (int s0 = 0; s0 < S; s0 += kTile) {
    int any = 0;
    for (int t = tid; t < kTile; t += kThreads) {
      const int ok = sc[s0 + t] > kNegInf;
      ok_s[t] = ok;
      any |= ok;
    }
    if (!__syncthreads_or(any)) continue;
    for (int i = tid; i < kTile * vecs_per_row; i += kThreads) {
      const int t = i / vecs_per_row;
      const int c = (i % vecs_per_row) * kVec;
      float* vd = tile + t * Dp + c;
      if (ok_s[t]) {
        const size_t row = row0 + static_cast<size_t>(s0 + t) * Hkv;
        const float vs = v_scales != nullptr ? v_scales[row] : 1.f;
        CacheLoad<CT>::run(v_cache + row * D + c, vd, vs);
      } else {  // not loaded: zeros, so p = 0 times it stays 0
#pragma unroll
        for (int e = 0; e < kVec; ++e) vd[e] = 0.f;
      }
    }
    for (int i = tid; i < G * kTile; i += kThreads) {
      const int g = i / kTile;
      float* s = sc + g * Sp + s0 + i % kTile;
      *s = *s > kNegInf ? round_p<CT>(expf(*s - m_s[g]) / l_s[g]) : 0.f;
    }
    __syncthreads();
    for (int i = tid; i < G * D; i += kThreads) {
      const int d = i % D;
      const float* pr = sc + (i / D) * Sp + s0;
      float a = acc[i];
      for (int t = 0; t < kTile; ++t) a = fmaf(pr[t], tile[t * Dp + d], a);
      acc[i] = a;
    }
    __syncthreads();  // the tile and flags are overwritten by the next one
  }
  for (int i = tid; i < G * D; i += kThreads) ob[i] = from_float<QT>(acc[i]);
}

template <typename QT, typename CT>
int launch(const void* q, const void* k_cache, const void* v_cache,
           const void* k_scales, const void* v_scales,
           const void* cache_positions, const void* pos, void* scores,
           void* out, int B, int H, int Hkv, int D, int S, int window,
           float scale, cudaStream_t stream) {
  const int G = H / Hkv;
  const int score_words = scores != nullptr ? 0 : G * padded_keys(S);
  const size_t bytes = sizeof(float) * smem_words(G, D, score_words);
  auto kernel = flash_decode_kernel<QT, CT>;
  if (bytes > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(bytes));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const dim3 grid(Hkv, B);
  kernel<<<grid, kThreads, bytes, stream>>>(
      static_cast<const QT*>(q), static_cast<const CT*>(k_cache),
      static_cast<const CT*>(v_cache), static_cast<const float*>(k_scales),
      static_cast<const float*>(v_scales),
      static_cast<const int32_t*>(cache_positions),
      static_cast<const int32_t*>(pos), static_cast<float*>(scores),
      static_cast<QT*>(out), H, Hkv, D, S, window, scale);
  return static_cast<int>(cudaGetLastError());
}

// fp32 queries over any cache; bf16 queries over fp32 caches (bf16 queries
// over bf16 or int8 caches take the split-KV passes).
template <typename QT>
int launch_cache(int cache_dtype, const void* q, const void* k_cache,
                 const void* v_cache, const void* k_scales,
                 const void* v_scales, const void* cache_positions,
                 const void* pos, void* scores, void* out, int B, int H,
                 int Hkv, int D, int S, int window, float scale,
                 cudaStream_t stream) {
  constexpr bool kBf16Q = std::is_same<QT, __nv_bfloat16>::value;
  switch (cache_dtype) {
    case 0:
      if constexpr (kBf16Q) return -1;
      else
        return launch<QT, __nv_bfloat16>(
            q, k_cache, v_cache, nullptr, nullptr, cache_positions, pos,
            scores, out, B, H, Hkv, D, S, window, scale, stream);
    case 1:
      if constexpr (kBf16Q) return -1;
      else
        return launch<QT, int8_t>(q, k_cache, v_cache, k_scales, v_scales,
                                  cache_positions, pos, scores, out, B, H,
                                  Hkv, D, S, window, scale, stream);
    case 2:
      return launch<QT, float>(q, k_cache, v_cache, nullptr, nullptr,
                               cache_positions, pos, scores, out, B, H, Hkv,
                               D, S, window, scale, stream);
    default:
      return -1;
  }
}

// ------------------------------ bf16 queries: split-KV passes

// The dense cache as split_decode.cuh's key source: key s of slot b is row
// (b*S + s)*Hkv + h, visible iff cpos = cache_positions[b, s] >= 0,
// cpos <= pos[b] and, with a window, pos[b] - cpos < window.  The staged
// map holds each key's entry (0 visible, -1 not; kNoKey past S), then one
// word a warp for the least and greatest visible key of the split.  A row
// that sees a key reads K and V rows of its visible keys only
// (kMinLiveV 0); a row that sees none reads every value row of its slot.
struct DenseKeys {
  static constexpr int kMinLiveV = 0;
  __host__ __device__ static int map_words(int split_keys, int) {
    return split_keys + 2 * split_kv::kWarps;
  }
  int* vis_s;
  int k0, b, h, vlo, vhi;

  __device__ void stage(const split_kv::Args& a, int b_, int h_, int k0_,
                        int k1, int p0, int* map_s, int tid) {
    vis_s = map_s;
    b = b_;
    h = h_;
    k0 = k0_;
    vlo = INT_MAX;
    vhi = -1;
    const int32_t* cp = a.map + static_cast<size_t>(b) * a.S;
    for (int i = tid; i < k1 - k0; i += split_kv::kThreads) {
      const int c = cp[k0 + i];
      const bool ok =
          c >= 0 && c <= p0 && (a.window == 0 || p0 - c < a.window);
      map_s[i] = ok ? 0 : -1;
      if (ok) {
        vlo = min(vlo, k0 + i);
        vhi = max(vhi, k0 + i);
      }
    }
  }
  // [lo, hi]: the least and greatest visible key of the split (hi < lo:
  // none), reduced over the CTA; every thread reaches its barrier
  __device__ void visible(const split_kv::Args& a, int, int, int, int& lo,
                          int& hi) const {
    constexpr int W = split_kv::kWarps;
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    int* red = vis_s + a.split_keys;
    const int wlo = __reduce_min_sync(0xffffffffu, vlo);
    const int whi = __reduce_max_sync(0xffffffffu, vhi);
    if (lane == 0) {
      red[warp] = wlo;
      red[W + warp] = whi;
    }
    __syncthreads();
    lo = red[0];
    hi = red[W];
#pragma unroll
    for (int w = 1; w < W; ++w) {
      lo = min(lo, red[w]);
      hi = max(hi, red[W + w]);
    }
  }
  __device__ int entry(const split_kv::Args& a, int k) const {
    return k < a.S ? vis_s[k - k0] : split_kv::kNoKey;
  }
  __device__ int row(const split_kv::Args& a, int k, int) const {
    return (b * a.S + k) * a.Hkv + h;
  }
};

template <typename CT>
int launch_dim(const split_kv::Args& a, int B, int D, cudaStream_t s) {
  using split_kv::launch_split;
  switch (D) {
    case 16:
      return launch_split<DenseKeys, CT, 16>(a, B, s);
    case 32:
      return launch_split<DenseKeys, CT, 32>(a, B, s);
    case 64:
      return launch_split<DenseKeys, CT, 64>(a, B, s);
    case 80:
      return launch_split<DenseKeys, CT, 80>(a, B, s);
    case 128:
      return launch_split<DenseKeys, CT, 128>(a, B, s);
    case 256:
      return launch_split<DenseKeys, CT, 256>(a, B, s);
    default:
      return -1;
  }
}

}  // namespace

extern "C" {

// Which hand-written instantiation runs for q's dtype (0 fp32, 1 bf16) and
// the cache's (0 bf16, 1 int8, 2 fp32).
const char* flash_decode_variant(int q_dtype, int cache_dtype) {
  return q_dtype == 1 && cache_dtype != 2
             ? "bf16 CUDA-core split-KV, two launches (scores; values with "
               "p rounded against the merged max and sum, the last CTA "
               "summing the partials in split order)"
             : "fp32 CUDA-core FMAs, two walks (one CTA a slot and kv head)";
}

// Keys per staged tile of the split-KV passes at head dim D (their split
// keys are a multiple).
int flash_decode_key_tile(int D) { return split_kv::key_tile(D); }

// Bytes of dynamic shared memory one CTA of the split-KV passes needs
// (cache_dtype: 0 bf16, 1 int8); the wrapper checks it against the card's
// 227 KB before launching.
int flash_decode_smem_bytes(int cache_dtype, int D, int G, int split_keys,
                            int splits) {
  return split_kv::smem_bytes<DenseKeys>(cache_dtype == 1, D, G, split_keys,
                                         splits, 0);
}

// bf16 queries over bf16 or int8 caches.  q [B, H, D] bf16 (the output
// too); cache_dtype: 0 bf16, 1 int8 (k_scales/v_scales then point at fp32
// [B, S, Hkv]).  All tensors contiguous; cache_positions [B, S] and pos
// [B] int32.  The plan (kernels/flash_decode.py:plan): split_keys a
// multiple of flash_decode_key_tile(D), splits = ceil(S / split_keys) <=
// 32.  m and l: fp32 scratch of B * Hkv * splits * G floats each;
// partial: of that times D, 16-byte aligned; arrived: B * Hkv ints (both
// unused with one split).  Returns cudaGetLastError() after the launches,
// or -1 for a bad code or plan.
int flash_decode_launch(int cache_dtype, const void* q, const void* k_cache,
                        const void* v_cache, const void* k_scales,
                        const void* v_scales, const void* cache_positions,
                        const void* pos, void* m, void* l, void* partial,
                        void* arrived, void* out, int B, int H, int Hkv,
                        int D, int S, int window, int split_keys, int splits,
                        float scale, void* stream) {
  if (!split_kv::plan_ok(S, H, Hkv, D, split_keys, splits, partial, arrived))
    return -1;
  const split_kv::Args a{static_cast<const split_kv::bf16*>(q),
                         k_cache,
                         v_cache,
                         static_cast<const float*>(k_scales),
                         static_cast<const float*>(v_scales),
                         static_cast<const int32_t*>(cache_positions),
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
                         0,
                         0,
                         split_keys,
                         splits,
                         scale * 1.4426950408889634f,
                         1.f / static_cast<float>(S)};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (cache_dtype) {
    case 0:
      return launch_dim<split_kv::bf16>(a, B, D, s);
    case 1:
      return launch_dim<int8_t>(a, B, D, s);
    default:
      return -1;
  }
}

// The two-walk kernel: bytes of dynamic shared memory one CTA needs, with
// score_words words of scores kept there (G*padded_keys(S), or 0 when they
// go to global memory); the wrapper checks it against the card's 227 KB
// before launching.
int flash_decode_walk_smem_bytes(int G, int D, int score_words) {
  return static_cast<int>(sizeof(float)) * smem_words(G, D, score_words);
}

// Keys one CTA of the two-walk kernel stages per tile.
int flash_decode_walk_tile_keys() { return kTile; }

// The two-walk kernel: fp32 q over bf16, int8 or fp32 caches, or bf16 q
// over fp32 caches (q_dtype: 0 fp32, 1 bf16, the output in q's type;
// cache_dtype: 0 bf16, 1 int8 with k_scales/v_scales fp32 [B, S, Hkv], 2
// fp32).  All tensors contiguous; cache_positions [B, S] and pos [B]
// int32.  scores: null keeps the scores in shared memory; else fp32
// scratch of B*H*padded_keys(S) floats in global memory, S rounded up to
// whole tiles.  Returns cudaGetLastError() after the launch, or -1 for a
// bad dtype code (bf16 q over a bf16 or int8 cache among them).
int flash_decode_walk_launch(int q_dtype, int cache_dtype, const void* q,
                             const void* k_cache, const void* v_cache,
                             const void* k_scales, const void* v_scales,
                             const void* cache_positions, const void* pos,
                             void* scores, void* out, int B, int H, int Hkv,
                             int D, int S, int window, float scale,
                             void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (q_dtype) {
    case 0:
      return launch_cache<float>(cache_dtype, q, k_cache, v_cache, k_scales,
                                 v_scales, cache_positions, pos, scores, out,
                                 B, H, Hkv, D, S, window, scale, s);
    case 1:
      return launch_cache<__nv_bfloat16>(cache_dtype, q, k_cache, v_cache,
                                         k_scales, v_scales, cache_positions,
                                         pos, scores, out, B, H, Hkv, D, S,
                                         window, scale, s);
    default:
      return -1;
  }
}

}  // extern "C"
