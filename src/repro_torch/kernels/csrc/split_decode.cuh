// Split-KV decode attention for Hopper (sm_90a), bf16 queries: the two
// passes shared by paged decode (paged_decode.cu, keys read through a
// block table) and flash decode (flash_decode.cu, a dense cache read in
// place and masked by the position each entry holds).  The key source is
// the template parameter Src; everything else (the split, the merge of the
// splits' maxima and sums, the rounded probabilities, the value tile and
// the last-arriving combine) is the same arithmetic for both.
//
// One query token per slot b and query head (kv head h, G query heads a kv
// head); out = softmax(q.k * D^-0.5) . v over the visible keys, the
// softmax in fp32, each probability rounded to the cache type against the
// row's final max and sum (bf16 caches; int8 caches are dequantized to
// fp32 and keep it fp32).  A row with no visible key gets the mean of the
// value rows of every key the row addresses (weight 1/S, rounded the same
// way), as the plain versions' uniform softmax over NEG_INF fills gives.
//
// The grid is (split, kv head, slot).  The S keys of a row are cut into
// splits of split_keys, whole tiles of key_tile(D) keys (the plan of
// kernels/paged_decode.py:split_rule, made from the shapes alone).
//   * Pass 1 (scores): q.k over the split's visible keys, scaled to exp2
//     units and masked; each query head's split-local max m_i and sum l_i
//     of exp2(s - m_i), online over the tiles, to an fp32 scratch.  A split
//     with no visible key writes (NEG_INF, 0) and exits at once.
//   * Pass 2 (values): every CTA merges all splits' (m_i, l_i) of its heads
//     in split order (every CTA gets the same m and l; a split with l_i = 0
//     is skipped), recomputes its split's scores with pass 1's
//     instructions (bitwise the same), forms p = exp2(s - m) * (1 / l),
//     rounds it to the cache type and accumulates p v into an fp32 [G, D]
//     partial.  The last pass-2 CTA of each (slot, kv head) to arrive (a
//     counter zeroed by pass 1, raised after a __threadfence) sums the
//     partials of the splits that wrote one (l_i > 0 in the merge's table,
//     every split for a row with no visible key) in split order, so the
//     result does not depend on which CTA is last, and writes bf16; with
//     one split pass 2 writes the output itself.  Rounding p needs the
//     row's final m and l, so one online pass will not do (paged_verify.cu
//     records how far a running-max rounding departs).
//   * A row with no visible key: every split's pass 2 takes p = 1/S on each
//     of its keys (Src says which value rows exist), summed in split order
//     with the partials.
//   * Inside a CTA (four warps): the split's key map (block-table entries,
//     or the visibility of each key from cache_positions) is staged first,
//     with pos and q; K, then V, tiles stream through a two-stage cp.async
//     ring (16-byte copies read in place, no gathered copy; one tile in
//     flight while the previous one multiplies; rows that are not read are
//     zero-filled); every staged row serves all G <= 16 query heads of its
//     kv head (with few heads, G <= HG / 2 below, the value product cuts
//     each tile's keys into slices instead, so its threads do not idle:
//     zamba2-2.7b's G 1 took pass 2 from 0.0525 to 0.0364 ms on an H100);
//     products and sums are fp32 FMAs on the CUDA cores.  Not the
//     tensor cores: at T = 1 the G = 7 query rows of qwen2-0.5b would fill
//     7 of an m16n8k16 tile's 16, the work is far under their limit (bytes
//     bound it: ~4*G flops an element against the ~295 flops a byte at
//     which the bf16 tensor cores would), and fp32 products keep int8
//     caches' fp32 p exact without a bf16 hi + lo split.
//
// Src, the key source, provides:
//   kMinLiveV        the least key entry whose V row a row with visible
//                    keys loads (entries: >= 0 a K row to read, -1 a key
//                    that exists but is not read, kNoKey past the row);
//   map_words(split_keys, bs)  4-byte words of its staged key map;
//   stage(a, b, h, k0, k1, p0, map_s, tid)  loads the split's key map
//                    (no barrier of its own);
//   visible(a, p0, k0, k1, lo, hi)  [lo, hi]: keys outside it are not
//                    visible (hi < lo: none in the split); may hold a
//                    barrier, which every thread reaches;
//   entry(a, k), row(a, k, e)  key k's entry and its row of the
//                    [rows, Hkv, D] cache (row(k, e) for e >= -1).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "tc_bf16.cuh"

namespace split_kv {

using tc::bf16;

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxGroup = 16;   // query heads per kv head
constexpr int kMaxSplits = 32;  // splits a call may have (a bit each)
constexpr int kPad = 8;         // bf16 elements of padding per staged row
constexpr int kNoKey = -2;      // entry of a key past the row
constexpr float kNegInf = -1e30f;
constexpr float kMasked = -1e29f;  // scores at or below this are masked

// Keys per staged tile at head dim D; a split is a whole number of them
// (kernels/paged_decode.py:key_tile).
__host__ __device__ constexpr int key_tile(int D) { return D > 128 ? 32 : 64; }

struct Args {
  const bf16* q;
  const void* k;  // K pages or cache
  const void* v;
  const float* k_scales;  // int8: fp32 row scales, indexed like the rows
  const float* v_scales;
  const int32_t* map;  // block_tables [B, NB] or cache_positions [B, S]
  const int32_t* pos;
  float* m;        // [B*Hkv][splits][G]: split-local max (exp2 units)
  float* l;        // the same: sum of exp2(s - m) over the split
  float* partial;  // [B*Hkv][splits][G][D]; null with one split
  int* arrived;    // [B*Hkv]: pass-2 CTAs done (zeroed by pass 1)
  bf16* out;
  int H, Hkv, S, window;
  int bs, NB;      // paged: page size and table width (S = NB * bs)
  int split_keys;  // keys per split, a multiple of key_tile(D)
  int splits;
  float scale_log2;  // D^-0.5 * log2(e)
  float inv_keys;    // 1 / S, divided once on the host
};

__host__ __device__ inline int align16(int x) { return (x + 15) & ~15; }

// Byte offsets into dynamic shared memory.
struct Smem {
  int q, k_raw, v_raw, sc, ent, k_scale, v_scale, map, m, l, mf, il, bytes;
};

// quant: int8 caches (staged as they are, widened when read).
__host__ __device__ inline Smem smem_layout(bool quant, int D, int G,
                                            int splits, int map_words) {
  const int KT = key_tile(D);
  const int raw_row = quant ? D + 16 : (D + kPad) * 2;
  const int sizes[12] = {
      G * D * 4,               // q, widened to fp32
      2 * KT * raw_row,        // K ring
      2 * KT * raw_row,        // V ring
      G * (KT + 1) * 4,        // scores, then probabilities
      2 * KT * 4,              // key entries of both stages
      quant ? 2 * KT * 4 : 0,  // k scales
      quant ? 2 * KT * 4 : 0,  // v scales
      map_words * 4,           // the split's key map
      splits * G * 4,          // every split's m
      splits * G * 4,          // and l
      G * 4,                   // merged m
      G * 4};                  // 1 / merged l
  int at[12];
  int total = 0;
  for (int i = 0; i < 12; ++i) {
    at[i] = total;
    total += align16(sizes[i]);
  }
  return Smem{at[0], at[1], at[2], at[3], at[4],  at[5],  at[6],
              at[7], at[8], at[9], at[10], at[11], total};
}

// Dynamic shared memory of one CTA of either pass.
template <typename Src>
__host__ __device__ inline int smem_bytes(bool quant, int D, int G,
                                          int split_keys, int splits,
                                          int bs) {
  return smem_layout(quant, D, G, splits, Src::map_words(split_keys, bs))
      .bytes;
}

// One 16-byte load of cache elements, widened to fp32 (times the row scale
// for int8, the same product as dequantize_kv).
template <typename PT>
struct Widen;

template <>
struct Widen<bf16> {
  static constexpr int kVec = 8;
  __device__ static void run(const bf16* src, float* dst, float) {
    const uint4 raw = *reinterpret_cast<const uint4*>(src);
    const bf16* e = reinterpret_cast<const bf16*>(&raw);
#pragma unroll
    for (int i = 0; i < kVec; ++i) dst[i] = __bfloat162float(e[i]);
  }
};

template <>
struct Widen<int8_t> {
  static constexpr int kVec = 16;
  __device__ static void run(const int8_t* src, float* dst, float scale) {
    const uint4 raw = *reinterpret_cast<const uint4*>(src);
    const int8_t* e = reinterpret_cast<const int8_t*>(&raw);
#pragma unroll
    for (int i = 0; i < kVec; ++i) dst[i] = static_cast<float>(e[i]) * scale;
  }
};

// A probability as it multiplies v: rounded to bf16 where the cache is
// bf16, as the plain version rounds it (int8 caches are dequantized to
// fp32 first, so it stays fp32).
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

// 4 bytes from global src to shared dst (src_bytes 0: zero-filled).
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   tc::smem_addr(dst)),
               "l"(src), "r"(src_bytes));
}

// Four cache elements from shared memory, widened to fp32.
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

// The value product's layout at head dim D: thread (column quad cq, head
// group hg) holds four columns of heads hg, hg + HG, ...; D / 4 quads, HG
// head groups (threads past HG * CQ idle: 8 of 128 at D 80), so each
// thread holds value_heads(D) heads to cover every G <= 16.
__host__ __device__ constexpr int value_quads(int D) { return D / 4; }
__host__ __device__ constexpr int value_groups(int D) {
  return kThreads / value_quads(D);
}
__host__ __device__ constexpr int value_heads(int D) {
  return (kMaxGroup + value_groups(D) - 1) / value_groups(D);
}
// Key slices of the value product: with G <= HG / 2 query heads most head
// groups would idle (zamba2-2.7b's G 1 at D 80 leaves 5 of 6), so thread
// (cq, hg) takes head hg % G over keys hg / G, hg / G + KS, ... of each
// tile instead (KS = HG / G slices), and the slices' sums are added in
// slice order after the last tile.
__device__ __forceinline__ int key_slices(int HG, int G) {
  return 2 * G <= HG ? HG / G : 1;
}

// The scores of a staged K tile: thread (key t, head group) forms q.k of
// its key for heads hg, hg + HG, ... in fp32 FMAs, d ascending; scaled
// (int8: times the key's scale first) to exp2 units, NEG_INF where the key
// is not visible (entry < 0 or outside [lo, hi]).  Passes 1 and 2 call it
// alike, so their scores are bitwise the same.
template <typename PT, int D>
__device__ __forceinline__ void tile_scores(const float* q_s,
                                            const unsigned char* k_t,
                                            const int* ent, const float* ks,
                                            int kt0, int lo, int hi, int G,
                                            float scale_log2, float* sc,
                                            int tid) {
  constexpr bool kQuant = std::is_same<PT, int8_t>::value;
  constexpr int KT = key_tile(D), HG = kThreads / KT, NH = kMaxGroup / HG;
  constexpr int RAW = kQuant ? D + 16 : (D + kPad) * 2;
  constexpr int VEC = Widen<PT>::kVec;
  const int t = tid % KT, hg = tid / KT;
  float acc[NH];
#pragma unroll
  for (int i = 0; i < NH; ++i) acc[i] = 0.f;
  const PT* kr = reinterpret_cast<const PT*>(k_t + t * RAW);
#pragma unroll 2
  for (int c = 0; c < D; c += VEC) {
    float kv[VEC];
    Widen<PT>::run(kr + c, kv, 1.f);
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
  const bool ok = ent[t] >= 0 && k >= lo && k <= hi;
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

// o += p v over a staged V tile (value_heads' layout, or KS > 1 key
// slices); pr [G][KT + 1] the probabilities (int8: times the row's v
// scale).
template <typename PT, int D>
__device__ __forceinline__ void tile_values(float (&o)[value_heads(D)][4],
                                            const float* pr,
                                            const unsigned char* v_t, int G,
                                            int KS, int tid) {
  constexpr bool kQuant = std::is_same<PT, int8_t>::value;
  constexpr int KT = key_tile(D), CQ = value_quads(D), HG = value_groups(D);
  constexpr int RAW = kQuant ? D + 16 : (D + kPad) * 2;
  const int cq = tid % CQ, hg = tid / CQ;
  if (hg >= HG) return;
  if (KS > 1) {
    if (hg >= KS * G) return;
    const int g = hg % G;
#pragma unroll 4
    for (int t = hg / G; t < KT; t += KS) {
      float v[4];
      load4(reinterpret_cast<const PT*>(v_t + t * RAW) + cq * 4, v);
      const float p = pr[g * (KT + 1) + t];
#pragma unroll
      for (int e = 0; e < 4; ++e) o[0][e] = fmaf(p, v[e], o[0][e]);
    }
    return;
  }
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
// (split, kv head, slot); PT: bf16 or int8 caches.
template <typename Src, typename PT, int D, bool kValues>
// (a minimum of one CTA an SM lifts ptxas's register cap for 128 threads,
// under which pass 2 spilled 4-12 bytes at D 16-256)
__global__ void __launch_bounds__(kThreads, 1) decode_split(const Args a) {
  constexpr bool kQuant = std::is_same<PT, int8_t>::value;
  constexpr int KT = key_tile(D), SCP = KT + 1;
  constexpr int RAW = kQuant ? D + 16 : (D + kPad) * 2;  // bytes a row
  constexpr int CH = D * int(sizeof(PT)) / 16;  // 16-byte copies a row
  extern __shared__ __align__(16) unsigned char sm[];
  __shared__ int flag;
  __shared__ unsigned writers;  // splits with l_i > 0 (pass 2)
  const int G = a.H / a.Hkv;
  const Smem L = smem_layout(kQuant, D, G, a.splits,
                             Src::map_words(a.split_keys, a.bs));
  const int s = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int bh = b * a.Hkv + h;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int S = a.S;
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
  // pos, the split's key map and q are loaded together (none waits on
  // another), before a CTA whose split holds no visible key leaves
  const int p0 = a.pos[b];
  Src src;
  src.stage(a, b, h, k0, k1, p0, reinterpret_cast<int*>(sm + L.map), tid);
  float* q_s = reinterpret_cast<float*>(sm + L.q);
  const uint4* qb = reinterpret_cast<const uint4*>(
      a.q + (static_cast<size_t>(b) * a.H + static_cast<size_t>(h) * G) * D);
  for (int i = tid; i < G * D / 8; i += kThreads) {
    const uint4 r = qb[i];
    const bf16* e = reinterpret_cast<const bf16*>(&r);
#pragma unroll
    for (int x = 0; x < 8; ++x) q_s[8 * i + x] = __bfloat162float(e[x]);
  }
  // the keys the query may see: [lo, hi] (none in the split where the two
  // do not overlap)
  int lo, hi;
  src.visible(a, p0, k0, k1, lo, hi);
  const bool live = max(k0, lo) <= min(k1 - 1, hi);
  if (!kValues && !live) {  // (NEG_INF, 0): the merge skips the split
    if (tid < G) {
      a.m[(ml0 + s) * G + tid] = kNegInf;
      a.l[(ml0 + s) * G + tid] = 0.f;
    }
    return;
  }
  __syncthreads();  // the key map, q_s

  int* ent_s = reinterpret_cast<int*>(sm + L.ent);
  float* ks_s = reinterpret_cast<float*>(sm + L.k_scale);
  float* vs_s = reinterpret_cast<float*>(sm + L.v_scale);
  unsigned char* k_raw = sm + L.k_raw;
  unsigned char* v_raw = sm + L.v_raw;
  const PT* kp = static_cast<const PT*>(a.k);
  const PT* vp = static_cast<const PT*>(a.v);
  // the least entry whose V row a tile loads: Src's for a row that sees a
  // key, every existing key's (-1) for a row that sees none
  int v_min = Src::kMinLiveV;
  // tile j of the split into ring stage st: K rows of entries >= 0
  // (want_k), V rows of entries >= v_min (want_v), and their scales, the
  // rest zero-filled; and each key's entry, read after the barrier that
  // follows the copies' wait.  No barrier of its own: a thread finds the
  // entry of each row it copies in the staged key map.
  auto load_tile = [&](int j, int st, bool want_k, bool want_v) {
    const int kt0 = k0 + j * KT;
    for (int i = tid; i < KT * CH; i += kThreads) {
      const int t = i / CH, c = i % CH, k = kt0 + t;
      const int e = src.entry(a, k);
      const int row = src.row(a, k, e);
      const bool kk = e >= 0, vv = e >= v_min;
      if (c == 0) {
        ent_s[st * KT + t] = e;
        if constexpr (kQuant) {
          if (want_k)
            cp_async4(ks_s + st * KT + t, a.k_scales + (kk ? row : 0),
                      kk ? 4 : 0);
          if (want_v)
            cp_async4(vs_s + st * KT + t, a.v_scales + (vv ? row : 0),
                      vv ? 4 : 0);
        }
      }
      const size_t el = static_cast<size_t>(row) * D +
                        c * (16 / int(sizeof(PT)));
      const int dst = (st * KT + t) * RAW + c * 16;
      if (want_k)
        tc::cp_async16(k_raw + dst, kp + (kk ? el : 0), kk ? 16 : 0);
      if (want_v)
        tc::cp_async16(v_raw + dst, vp + (vv ? el : 0), vv ? 16 : 0);
    }
  };

  // the key tiles (of KT keys from k0) that may hold a visible key
  const int jv_lo = live ? (max(k0, lo) - k0) / KT : 0;
  const int jv_hi = live ? (min(k1 - 1, hi) - k0) / KT : -1;
  if (live) load_tile(jv_lo, 0, true, kValues);
  tc::cp_async_commit();

  float* mf_s = reinterpret_cast<float*>(sm + L.mf);
  float* il_s = reinterpret_cast<float*>(sm + L.il);
  bool dead = false;  // the row sees no key at all
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
        // the splits that hold a visible key (the same for every head of
        // the kv head): the combine's writers
        if (g == 0) {
          const unsigned w = __ballot_sync(0xffffffffu, li > 0.f);
          if (lane == 0) writers = w;
        }
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
  // pass 2 of a row with no visible key reads the value rows of every key
  // of the split (their mean) instead of scoring; the tile prefetched
  // above is reloaded unless it is the split's first
  const bool scores = live && !dead;
  int j_lo = jv_lo, j_hi = jv_hi;
  if (kValues && dead) {
    j_lo = 0;
    j_hi = (k1 - 1 - k0) / KT;
    v_min = -1;
    if (!live || jv_lo != 0 || Src::kMinLiveV != -1) {
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
  const int KS = key_slices(value_groups(D), G);
  for (int j = j_lo; j <= j_hi; ++j) {
    const int st = (j - j_lo) & 1;
    if (j < j_hi) load_tile(j + 1, st ^ 1, scores, kValues);
    tc::cp_async_commit();
    tc::cp_async_wait<1>();
    __syncthreads();
    const int* ent = ent_s + st * KT;
    if (scores)
      tile_scores<PT, D>(q_s, k_raw + st * KT * RAW, ent, ks_s + st * KT,
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
      // (a masked score gives exp2(-1e30 - m) = 0); a row with no visible
      // key takes 1/S on every key that exists
      for (int i = tid; i < G * KT; i += kThreads) {
        const int g = i / KT, t = i % KT;
        float pr = scores ? round_p<PT>(exp2f(sc[g * SCP + t] - mf_s[g]) *
                                        il_s[g])
                          : (ent[t] >= -1 ? uniform : 0.f);
        if constexpr (kQuant) pr *= vs_s[st * KT + t];
        sc[g * SCP + t] = pr;
      }
      __syncthreads();
      tile_values<PT, D>(o, sc, v_raw + st * KT * RAW, G, KS, tid);
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
    constexpr int CQ = value_quads(D), HG = value_groups(D);
    const int cq = tid % CQ, hg = tid / CQ;
    if (j_lo <= j_hi && KS > 1) {
      // the key slices' sums into slice 0's threads (hg < G), in slice
      // order, through the K ring (no copy is in flight any more)
      float* red = reinterpret_cast<float*>(k_raw);  // [KS * G][D]
      if (hg < KS * G)
        *reinterpret_cast<float4*>(red + hg * D + cq * 4) =
            make_float4(o[0][0], o[0][1], o[0][2], o[0][3]);
      __syncthreads();
      if (hg < G) {
        for (int ks = 1; ks < KS; ++ks) {
          const float4 x = *reinterpret_cast<const float4*>(
              red + (ks * G + hg) * D + cq * 4);
          o[0][0] += x.x;
          o[0][1] += x.y;
          o[0][2] += x.z;
          o[0][3] += x.w;
        }
      }
    }
    if (j_lo <= j_hi && hg < HG) {  // the partial (or, alone, the output)
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
    // split for a row with none
    const unsigned wrote = dead ? ~0u : writers;
    const size_t stride = static_cast<size_t>(G) * D;
    const float4* src4 =
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
          x[u] = t < a.splits && (wrote >> t & 1u)
                     ? __ldcg(src4 + t * stride / 4 + i)
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

// Both passes of one call on the stream; returns cudaGetLastError().
template <typename Src, typename PT, int D>
int launch_split(const Args& a, int B, cudaStream_t stream) {
  const int bytes = smem_bytes<Src>(std::is_same<PT, int8_t>::value, D,
                                    a.H / a.Hkv, a.split_keys, a.splits,
                                    a.bs);
  auto scores = decode_split<Src, PT, D, false>;
  auto values = decode_split<Src, PT, D, true>;
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

// The checks both C entry points make of a call's shapes and plan.
inline bool plan_ok(int S, int H, int Hkv, int D, int split_keys, int splits,
                    const void* partial, const void* arrived) {
  return S > 0 && Hkv > 0 && H % Hkv == 0 && H / Hkv <= kMaxGroup &&
         split_keys > 0 && split_keys % key_tile(D) == 0 &&
         splits == (S + split_keys - 1) / split_keys &&
         splits <= kMaxSplits &&
         (splits == 1 || (partial != nullptr && arrived != nullptr));
}

}  // namespace split_kv
