// Flash attention (forward) for Hopper (sm_90a): q [B, Sq, H, D] against
// k, v [B, Sk, Hkv, D], causal or not, with an optional sliding window and
// grouped kv heads (query head h reads kv head h / G, G = H / Hkv).
//
// Replaces the Pallas TPU kernel flash_attention_tpu
// (repro/kernels/flash_attention.py:84).  The port calls it for the
// non-causal attention of the multimodal encoder's trunk
// (models/mm_encoder.py, fp32, D 448 at qwen2-0.5b's width with two
// heads) and for the causal attention of the monolithic forward
// (models/lm.py:_attn_layer), which every whole-prompt prefill runs: the
// engine's monolithic admission, a suffix against its cached prefix, and
// the draft model's bucketed prefill.
//
// What it computes, per batch b, head h and query row i at position
// qpos = q_offset + i: key j is visible iff j < Sk, j <= qpos when causal,
// and qpos - j < window when window > 0; out = softmax(q.k * scale) . v
// over the visible keys, with scores, softmax and products in fp32 and
// the output normalized by max(l, 1e-30) (the Pallas kernel's finalize).
// A row with no visible key writes zeros.
//
// What bounds it on an H100: operations at the prefill and encoder
// shapes.  A 1024-token causal prefill at qwen2-0.5b's heads does ~0.95 G
// multiply-adds per layer over 4.6 MB of q, k, v and o, ~400 flops per
// byte, above the ~295 where the bf16 tensor cores, not HBM, set the
// bound; the encoder's fp32 S 256, D 448 does 0.94 GFLOP over 14.7 MB,
// 64 flops per byte, against the 67 TFLOP/s fp32 rate (20 flops per byte
// at 3.35 TB/s).
//
// Which instantiation runs is chosen by (dtype, D) in flash_attention_launch
// (flash_attention_variant names it):
//   * bf16 at D 16, 32, 64, 80, 128, 256 (every serving path in bf16): the
//     tensor-core kernel, FlashAttention-2 in shape.  A CTA of 4 warps
//     takes 64 query rows, 16 a warp, of one (head, batch); S = Q K^T is
//     mma.sync m16n8k16 on bf16 fragments from ldmatrix (exact products,
//     fp32 sums); the online softmax (m, l, the rescale) stays in
//     registers, two rows a thread; the score accumulators become the A
//     fragments of P V, with V through ldmatrix.trans.  The key tiles (64
//     keys; 32 at D 256, to keep the [16 x 256] fp32 output a warp holds
//     in registers without spilling) are double-buffered with cp.async;
//     Q stays in registers up to D 128 and is re-read from shared memory
//     at D 256.  The probabilities stay fp32 as in the plain version and
//     the JAX package (models/attention.py, the Pallas kernel's
//     p.astype(float32)): each p is split into bf16 hi = bf16(p) and lo =
//     bf16(p - hi) and both go through the mma into the same fp32
//     accumulator, which carries p to within 2^-16 of its value (one bf16
//     rounding would be off by up to 2^-8, and hold the output to its fp32
//     plain version 35-81 times less tightly than EXACT_TOL asks: the CPU
//     emulation in tests/test_torch_multimodal.py);
//   * fp32 at every D, and bf16 at D 448 (the encoder's width, which no
//     bf16 path serves; widened to fp32 as it is staged): the CUDA-core
//     kernel below, full fp32 FMAs (never TF32), register-tiled as an
//     SGEMM is, one instantiation per head dim.  A CTA of 128 threads
//     takes 32 query rows and walks 64-key tiles.  S = Q K^T: each thread
//     holds a 4 x 4 block of scores (rows rg + 8i, keys kg + 16j) and sums
//     q.k over D from 16-byte shared loads; the tile's scores go to a
//     [64, 36] shared tile, where four threads a row take the online max,
//     rescale and sum (shuffles).  O = P V: each thread holds RO rows x
//     D / CW columns of the [32, D] output in registers (16 x 7 at D 448),
//     reads the rows' p as broadcast vectors and one float of V per column
//     and key, and rescales in registers.  Shared memory holds only what is
//     shared: a six-stage cp.async ring (five chunks in flight) whose
//     chunks are a tile's Q rows and K keys in 32-dim slices [32 + 64, 36],
//     then V in key slices [KC, D] (8 keys at D 448), so K and V of a whole
//     tile never sit there at once, and the probability tile: 94 KB at
//     D 448, 108 KB at most (two CTAs an SM; the kernel it replaced took
//     174 KB at D 448, one).  Q is streamed with K, once per key tile,
//     rather than kept: the 58 KB it would hold buy the ring's depth.  A
//     thread's copies sit at fixed offsets from a few base pointers (no
//     per-copy division or branch).  The last tile's V chunks stop at its
//     last visible key.  What holds it on an H100: shared-memory bandwidth,
//     32 floats a cycle into registers against 128 FMAs a cycle; the 4 x 4
//     score block does 2 FMAs per float loaded (8 x 8 would do 4 but needs
//     64 more registers beside the output's 112), the 16 x 7 output block
//     4.9.  With fewer (row tile, head, batch) CTAs than half the card's
//     SMs the keys are split over a cluster of 2, 4 or 8 CTAs
//     (flash_attention.py:plan, from the shapes alone): each walks its
//     share of the visible tiles, then the cluster merges through
//     distributed shared memory in split order, each CTA writing a slice
//     of the rows (the encoder's B 4, S 256, 2 heads: 64 row tiles, 2
//     splits, 128 CTAs).
// Both walk only the key tiles a query tile can see: from the first tile
// inside the window of its earliest row to the tile of its latest row when
// causal (the Pallas kernel's pl.when(live_block) skip), so a causal
// prefill does about half the tiles; both start the heaviest causal tiles
// first (the last query tiles, with every head of the batch before the
// next tile).  The ragged edges of Sq and Sk are masked per element (and
// zero-filled by cp.async's source size): no host-side padding or
// transposed copy; q, k and v are read in place.  For training, both
// instantiations also write each row's logsumexp (flash_attention_launch_lse,
// [B, H, Sq] fp32, natural units, after the split merge in the CUDA-core
// kernel), the residual from which the backward (flash_attention_bwd.cu)
// recomputes p; serving passes no lse.  Later work: wgmma with TMA, and
// one CTA per kv head for all G query heads.
#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "tc_bf16.cuh"

namespace {

constexpr int kThreads = 128;
constexpr float kNegInf = -1e30f;
constexpr float kMasked = -1e29f;  // scores at or below this are masked
constexpr float kLn2 = 0.6931471805599453f;  // lse from log2 to natural units

// ------------------------------------ fp32: register-tiled CUDA-core kernel

namespace cc {

constexpr int BM = 32;       // query rows per CTA
constexpr int BN = 64;       // keys per tile
constexpr int kStages = 6;   // cp.async ring depth: 5 chunks in flight
constexpr int kMaxSplits = 8;  // CTAs of a cluster (the portable most)

// O = P V's columns at head dim D: (lanes across them, floats a lane reads
// at once).  64 lanes of single floats where D is a multiple of 64 (16 rows
// a thread: one p vector serves more FMAs), else the largest power of two
// up to 32 that divides D / 2, of float2.
__host__ __device__ constexpr int col_lanes(int D) {
  if (D % 64 == 0) return 64;
  int w = 32;
  while ((D / 2) % w) w /= 2;
  return w;
}
__host__ __device__ constexpr int col_width(int D) {
  return D % 64 == 0 ? 1 : 2;
}

// Keys per V chunk: the fewest, as a power of two up to a tile, whose
// [keys, D] is at least a Q and K chunk's floats (`qk`).
__host__ __device__ constexpr int v_keys(int D, int qk) {
  int kc = 1;
  while (kc < BN && kc * D < qk) kc *= 2;
  return kc;
}

template <int D>
struct Cfg {
  static constexpr int DC = D % 32 == 0 ? 32 : 16;  // dims per Q/K chunk
  static constexpr int KLD = DC + 4;  // Q/K chunk row stride (conflict-free)
  static constexpr int KC = v_keys(D, (BM + BN) * KLD);  // keys per V chunk
  static constexpr int STAGE =  // floats per ring stage
      (BM + BN) * KLD > KC * D ? (BM + BN) * KLD : KC * D;
  static constexpr int NKC = D / DC;  // Q/K chunks per tile
  static constexpr int CHUNKS = NKC + BN / KC;  // ring chunks per tile
  static constexpr int PLD = BM + 4;  // probability tile row stride
  static constexpr int CW = col_lanes(D);  // O = P V: column lanes,
  static constexpr int CV = col_width(D);  // floats a lane reads at once,
  static constexpr int NCV = D / (CV * CW);  // such reads a thread,
  static constexpr int RO = BM * CW / kThreads;  // rows a thread
  static constexpr int SMEM_FLOATS = kStages * STAGE + BN * PLD + 4 * BM;
  static_assert(D % DC == 0 && BN % KC == 0 && D % (CV * CW) == 0, "D");
  static_assert(RO == 2 || RO % 4 == 0, "rows a thread");
  static_assert(BM * D <= kStages * STAGE, "the partial reuses the ring");
};

__device__ __forceinline__ float4 widen4(const __nv_bfloat16* src) {
  const uint2 raw = *reinterpret_cast<const uint2*>(src);
  const float2 a =
      __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.x));
  const float2 b =
      __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.y));
  return make_float4(a.x, a.y, b.x, b.y);
}

// Four values from global src to four floats at shared dst (16-byte
// aligned), zeros when !in: fp32 through cp.async (src read only when in),
// bf16 widened through registers.
__device__ __forceinline__ void stage4(float* dst, const float* src,
                                       bool in) {
  tc::cp_async16(dst, src, in ? 16 : 0);
}
__device__ __forceinline__ void stage4(float* dst, const __nv_bfloat16* src,
                                       bool in) {
  *reinterpret_cast<float4*>(dst) =
      in ? widen4(src) : make_float4(0.f, 0.f, 0.f, 0.f);
}

__device__ __forceinline__ void store1(float* dst, float a) { *dst = a; }
__device__ __forceinline__ void store1(__nv_bfloat16* dst, float a) {
  *dst = __float2bfloat16(a);
}
__device__ __forceinline__ void store2(float* dst, float a, float b) {
  *reinterpret_cast<float2*>(dst) = make_float2(a, b);
}
__device__ __forceinline__ void store2(__nv_bfloat16* dst, float a,
                                       float b) {
  *reinterpret_cast<__nv_bfloat162*>(dst) = __floats2bfloat162_rn(a, b);
}
__device__ __forceinline__ void store4(float* dst, float4 o) {
  *reinterpret_cast<float4*>(dst) = o;
}
__device__ __forceinline__ void store4(__nv_bfloat16* dst, float4 o) {
  store2(dst, o.x, o.y);
  store2(dst + 2, o.z, o.w);
}

// Grid (splits, row tiles * H, B), clusters of `splits` CTAs along x.
template <int D, typename T>
__global__ void __launch_bounds__(kThreads, 1) flash_fp32(
    const T* __restrict__ q, const T* __restrict__ k,
    const T* __restrict__ v, T* __restrict__ out, float* __restrict__ lse,
    int Sq, int Sk, int H, int Hkv, int causal, int window, int q_offset,
    float scale_log2) {
  using C = Cfg<D>;
  extern __shared__ __align__(16) float smem[];
  float* ring = smem;                      // [kStages][STAGE]
  float* p_s = ring + kStages * C::STAGE;  // [BN][PLD], key-major
  float* c_s = p_s + BN * C::PLD;          // [BM] the tile's rescale
  float* m_s = c_s + BM;                   // [BM] final max (log2 units)
  float* l_s = m_s + BM;                   // [BM] final sum
  float* L_s = l_s + BM;                   // [BM] sum merged over splits

  const int splits = gridDim.x, split = blockIdx.x;
  const int h = blockIdx.y % H, b = blockIdx.z;
  const int i0 = (gridDim.y / H - 1 - blockIdx.y / H) * BM;  // heaviest first
  const int hk = h / (H / Hkv);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int rows = min(BM, Sq - i0);

  // the key tiles this tile's rows can see, and this split's share
  const int q_lo = q_offset + i0;
  const int q_hi = q_offset + i0 + rows - 1;
  int j_hi = (Sk + BN - 1) / BN - 1;
  if (causal) j_hi = q_hi < 0 ? -1 : min(j_hi, q_hi / BN);
  int j_lo = 0;
  if (window > 0) {
    const int first = q_lo - window + 1;  // earliest key of the earliest row
    if (first > 0) j_lo = first / BN;
  }
  const int n = max(j_hi - j_lo + 1, 0);
  const int per = (n + splits - 1) / splits;
  const int t_lo = j_lo + split * per;
  const int ntiles = max(min(per, j_lo + n - t_lo), 0);
  // the last tile's V chunks stop at its last visible key
  int total = 0;
  if (ntiles > 0) {
    const int k_last = (t_lo + ntiles - 1) * BN;
    int k_end = min(Sk, k_last + BN);
    if (causal) k_end = min(k_end, q_hi + 1);
    total = (ntiles - 1) * C::CHUNKS + C::NKC +
            (k_end - k_last + C::KC - 1) / C::KC;
  }

  // chunk c of the walk: dims [DC x part, +DC) of the tile's Q rows and 64
  // keys, then V rows of KC keys at a time.  A thread's copies of a Q/K
  // chunk are rows t0 + RS n at column c4 (Q for n < NQ, then K), of a V
  // chunk the floats 4 (tid + 128 n): fixed offsets, no branches.
  constexpr int QKN = (BM + BN) * (C::DC / 4) / kThreads;
  constexpr int RS = kThreads / (C::DC / 4);
  constexpr int NQ = BM / RS;
  constexpr int VN = C::KC * (D / 4) / kThreads;
  static_assert(QKN * kThreads == (BM + BN) * (C::DC / 4) && NQ * RS == BM &&
                    VN * kThreads == C::KC * (D / 4),
                "whole copies a thread");
  const int t0 = tid / (C::DC / 4), c4 = (tid % (C::DC / 4)) * 4;
  const size_t q_row = static_cast<size_t>(H) * D;
  const size_t kv_row = static_cast<size_t>(Hkv) * D;
  const T* q_src = q + (static_cast<size_t>(b) * Sq + i0 + t0) * q_row +
                   static_cast<size_t>(h) * D + c4;
  const T* k_src = k + (static_cast<size_t>(b) * Sk + t0) * kv_row +
                   static_cast<size_t>(hk) * D + c4;
  const T* v_src =
      v + static_cast<size_t>(b) * Sk * kv_row + static_cast<size_t>(hk) * D;
  auto issue = [&](int c) {
    if (c >= total) return;
    float* st = ring + (c % kStages) * C::STAGE;
    const int k0 = (t_lo + c / C::CHUNKS) * BN, part = c % C::CHUNKS;
    if (part < C::NKC) {
      const int d0 = part * C::DC;
      const T* kt = k_src + static_cast<size_t>(k0) * kv_row + d0;
#pragma unroll
      for (int n = 0; n < QKN; ++n) {
        const bool in = n < NQ ? t0 + RS * n < rows
                               : k0 + t0 + RS * (n - NQ) < Sk;
        const T* src =
            n < NQ ? q_src + (RS * n) * q_row + d0
                   : kt + static_cast<size_t>(RS * (n - NQ)) * kv_row;
        stage4(st + (t0 + RS * n) * C::KLD + c4, in ? src : q, in);
      }
    } else {
      const int key0 = k0 + (part - C::NKC) * C::KC;
      const T* vk = v_src + static_cast<size_t>(key0) * kv_row;
#pragma unroll
      for (int n = 0; n < VN; ++n) {
        const int i = tid + kThreads * n;
        const int t = i / (D / 4);
        const bool in = key0 + t < Sk;
        stage4(st + 4 * i, in ? vk + t * kv_row + (i % (D / 4)) * 4 : v, in);
      }
    }
  };
#pragma unroll
  for (int c = 0; c < kStages - 1; ++c) {
    issue(c);
    tc::cp_async_commit();
  }

  // scores: rows rg + 8i, keys kg + 16j; a warp takes 4 row groups of 8
  // key groups (a Q and a K load each fill one shared-memory wavefront)
  const int rg = 4 * (warp >> 1) + (lane >> 3);
  const int kg = (lane & 7) + 8 * (warp & 1);
  // softmax: row sr's keys 4 u + sq, four threads a row
  const int sr = tid >> 2, sq = tid & 3;
  // output: rows r0 .. r0 + RO - 1, columns CV (cl + CW j) (+1)
  const int cl = tid % C::CW, r0 = (tid / C::CW) * C::RO;
  float s[4][4];
  float m = kNegInf, l = 0.f;  // row sr's running max and sum
  float acc[C::RO][C::NCV][C::CV];
#pragma unroll
  for (int i = 0; i < C::RO; ++i)
#pragma unroll
    for (int j = 0; j < C::NCV; ++j)
#pragma unroll
      for (int e = 0; e < C::CV; ++e) acc[i][j][e] = 0.f;

  for (int c = 0; c < total; ++c) {
    tc::cp_async_wait<kStages - 2>();
    __syncthreads();  // chunk c landed; chunk c - 1's stage is free
    issue(c + kStages - 1);
    tc::cp_async_commit();
    const float* st = ring + (c % kStages) * C::STAGE;
    const int part = c % C::CHUNKS;
    if (part < C::NKC) {
      if (part == 0) {
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
      }
      const float* ks = st + BM * C::KLD;
#pragma unroll
      for (int d = 0; d < C::DC; d += 4) {
        float4 qv[4], kv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
          qv[i] = *reinterpret_cast<const float4*>(st + (rg + 8 * i) * C::KLD
                                                   + d);
#pragma unroll
        for (int j = 0; j < 4; ++j)
          kv[j] = *reinterpret_cast<const float4*>(ks + (kg + 16 * j) * C::KLD
                                                   + d);
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            s[i][j] = fmaf(qv[i].x, kv[j].x, s[i][j]);
            s[i][j] = fmaf(qv[i].y, kv[j].y, s[i][j]);
            s[i][j] = fmaf(qv[i].z, kv[j].z, s[i][j]);
            s[i][j] = fmaf(qv[i].w, kv[j].w, s[i][j]);
          }
      }
      if (part == C::NKC - 1) {
        // scale to log2 units and mask (tiles on an edge only) into the
        // probability tile; then the online softmax, four threads a row.
        // Masked keys get probability 0, so a row that has seen no key yet
        // keeps l = 0 and acc = 0.
        const int k0 = (t_lo + c / C::CHUNKS) * BN;
        const bool edge = k0 + BN > Sk || (causal && k0 + BN - 1 > q_lo) ||
                          (window > 0 && q_hi - k0 >= window);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int qpos = q_lo + rg + 8 * i;
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            float x = s[i][j] * scale_log2;
            if (edge) {
              const int kpos = k0 + kg + 16 * j;
              const bool ok = kpos < Sk && (!causal || kpos <= qpos) &&
                              (window == 0 || qpos - kpos < window);
              if (!ok) x = kNegInf;
            }
            p_s[(kg + 16 * j) * C::PLD + rg + 8 * i] = x;
          }
        }
        __syncthreads();
        float x[BN / 4];
        float mx = kNegInf;
#pragma unroll
        for (int u = 0; u < BN / 4; ++u) {
          x[u] = p_s[(4 * u + sq) * C::PLD + sr];
          mx = fmaxf(mx, x[u]);
        }
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
        const float m_new = fmaxf(m, mx);
        const float corr = m > kMasked ? exp2f(m - m_new) : 1.f;
        float sum = 0.f;
#pragma unroll
        for (int u = 0; u < BN / 4; ++u) {
          const float p = x[u] > kMasked ? exp2f(x[u] - m_new) : 0.f;
          p_s[(4 * u + sq) * C::PLD + sr] = p;
          sum += p;
        }
        sum += __shfl_xor_sync(0xffffffffu, sum, 1);
        sum += __shfl_xor_sync(0xffffffffu, sum, 2);
        l = l * corr + sum;
        m = m_new;
        if (sq == 0) c_s[sr] = corr;
      }
    } else {
      const int kc = part - C::NKC;
      if (kc == 0) {  // the tile's rescale, published with its p
#pragma unroll
        for (int i = 0; i < C::RO; ++i) {
          const float corr = c_s[r0 + i];
#pragma unroll
          for (int j = 0; j < C::NCV; ++j)
#pragma unroll
            for (int e = 0; e < C::CV; ++e) acc[i][j][e] *= corr;
        }
      }
      const float* pk = p_s + kc * C::KC * C::PLD + r0;
#pragma unroll
      for (int t = 0; t < C::KC; ++t) {
        float pr[C::RO];
        if constexpr (C::RO == 2) {
          const float2 f = *reinterpret_cast<const float2*>(pk + t * C::PLD);
          pr[0] = f.x;
          pr[1] = f.y;
        } else {
#pragma unroll
          for (int u = 0; u < C::RO; u += 4) {
            const float4 f =
                *reinterpret_cast<const float4*>(pk + t * C::PLD + u);
            pr[u] = f.x;
            pr[u + 1] = f.y;
            pr[u + 2] = f.z;
            pr[u + 3] = f.w;
          }
        }
        float vv[C::NCV][C::CV];
#pragma unroll
        for (int j = 0; j < C::NCV; ++j) {
          const float* src = st + t * D + C::CV * (cl + C::CW * j);
          if constexpr (C::CV == 2) {
            const float2 f = *reinterpret_cast<const float2*>(src);
            vv[j][0] = f.x;
            vv[j][1] = f.y;
          } else {
            vv[j][0] = *src;
          }
        }
#pragma unroll
        for (int i = 0; i < C::RO; ++i)
#pragma unroll
          for (int j = 0; j < C::NCV; ++j)
#pragma unroll
            for (int e = 0; e < C::CV; ++e)
              acc[i][j][e] = fmaf(pr[i], vv[j][e], acc[i][j][e]);
      }
    }
  }
  tc::cp_async_wait<0>();
  if (sq == 0) {
    m_s[sr] = m;
    l_s[sr] = l;
  }
  __syncthreads();

  if (splits == 1) {
    if (lse != nullptr && tid < rows)
      lse[(static_cast<size_t>(b) * H + h) * Sq + i0 + tid] =
          (m_s[tid] + log2f(fmaxf(l_s[tid], 1e-30f))) * kLn2;
#pragma unroll
    for (int i = 0; i < C::RO; ++i) {
      const int row = r0 + i;
      if (row >= rows) continue;
      const float L = fmaxf(l_s[row], 1e-30f);
      T* dst = out + ((static_cast<size_t>(b) * Sq + i0 + row) * H + h) * D;
#pragma unroll
      for (int j = 0; j < C::NCV; ++j) {
        if constexpr (C::CV == 2)
          store2(dst + 2 * (cl + C::CW * j), acc[i][j][0] / L,
                 acc[i][j][1] / L);
        else
          store1(dst + cl + C::CW * j, acc[i][j][0] / L);
      }
    }
    return;
  }

  // The split's merge, through distributed shared memory: a warp reads
  // every split's max and sum of its row (loads issued together), weighs
  // split r by w_r = exp2(m_r - M) against the merged max M and adds the
  // merged sum L = sum of w_r l_r in split order; each CTA stores its
  // partial times its w over the ring; CTA s then writes its slice of the
  // rows, adding the partials in split order.  No CTA leaves before the
  // last read.
  namespace cg = cooperative_groups;
  cg::cluster_group cluster = cg::this_cluster();
  cluster.sync();  // every split's m and l are final
  if (tid < BM) {
    float mr[kMaxSplits], lr[kMaxSplits];
#pragma unroll
    for (int r = 0; r < kMaxSplits; ++r) {
      if (r < splits) {
        mr[r] = cluster.map_shared_rank(m_s, r)[tid];
        lr[r] = cluster.map_shared_rank(l_s, r)[tid];
      }
    }
    float M = kNegInf;
#pragma unroll
    for (int r = 0; r < kMaxSplits; ++r)
      if (r < splits) M = fmaxf(M, mr[r]);
    float L = 0.f, w_own = 0.f;
#pragma unroll
    for (int r = 0; r < kMaxSplits; ++r) {
      if (r < splits) {
        const float w = mr[r] > kMasked ? exp2f(mr[r] - M) : 0.f;
        L += w * lr[r];
        if (r == split) w_own = w;
      }
    }
    L_s[tid] = L;
    c_s[tid] = w_own;
    if (lse != nullptr && split == 0 && tid < rows)
      lse[(static_cast<size_t>(b) * H + h) * Sq + i0 + tid] =
          (M + log2f(fmaxf(L, 1e-30f))) * kLn2;
  }
  __syncthreads();
  float* part_s = ring;  // [BM][D]
#pragma unroll
  for (int i = 0; i < C::RO; ++i) {
    const float w = c_s[r0 + i];
#pragma unroll
    for (int j = 0; j < C::NCV; ++j)
#pragma unroll
      for (int e = 0; e < C::CV; ++e)
        part_s[(r0 + i) * D + C::CV * (cl + C::CW * j) + e] =
            acc[i][j][e] * w;
  }
  cluster.sync();  // every partial stored
  const int slice = BM / splits;
#pragma unroll 2
  for (int i = tid; i < slice * (D / 4); i += kThreads) {
    const int row = split * slice + i / (D / 4), c4 = (i % (D / 4)) * 4;
    if (row >= rows) continue;
    float4 p[kMaxSplits];
#pragma unroll
    for (int r = 0; r < kMaxSplits; ++r)
      if (r < splits)
        p[r] = *reinterpret_cast<const float4*>(
            cluster.map_shared_rank(part_s, r) + row * D + c4);
    float4 o = p[0];
#pragma unroll
    for (int r = 1; r < kMaxSplits; ++r) {
      if (r < splits) {
        o.x += p[r].x;
        o.y += p[r].y;
        o.z += p[r].z;
        o.w += p[r].w;
      }
    }
    const float L = fmaxf(L_s[row], 1e-30f);
    store4(out + ((static_cast<size_t>(b) * Sq + i0 + row) * H + h) * D + c4,
           make_float4(o.x / L, o.y / L, o.z / L, o.w / L));
  }
  cluster.sync();  // the other CTAs' partials are read
}

template <int D, typename T>
int launch(const void* q, const void* k, const void* v, void* out,
           float* lse, int B, int Sq, int Sk, int H, int Hkv, int causal,
           int window, int q_offset, float scale, int splits,
           cudaStream_t stream) {
  if (splits < 1 || splits > kMaxSplits || (splits & (splits - 1)))
    return -2;  // a power of two, so that it divides BM
  constexpr int bytes = Cfg<D>::SMEM_FLOATS * static_cast<int>(sizeof(float));
  auto kernel = flash_fp32<D, T>;
  if (bytes > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(splits, ((Sq + BM - 1) / BM) * H, B);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = bytes;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = splits;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = splits > 1 ? 1 : 0;
  const cudaError_t err = cudaLaunchKernelEx(
      &cfg, kernel, static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), lse, Sq, Sk, H, Hkv,
      causal, window, q_offset, scale * 1.4426950408889634f);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

int smem_bytes(int D) {
  switch (D) {
#define FLASH_CC_CASE(d) \
  case d:                \
    return Cfg<d>::SMEM_FLOATS * static_cast<int>(sizeof(float));
    FLASH_CC_CASE(16)
    FLASH_CC_CASE(32)
    FLASH_CC_CASE(64)
    FLASH_CC_CASE(80)
    FLASH_CC_CASE(128)
    FLASH_CC_CASE(256)
    FLASH_CC_CASE(448)
#undef FLASH_CC_CASE
    default:
      return -1;
  }
}

int launch_fp32(const void* q, const void* k, const void* v, void* out,
                float* lse, int B, int Sq, int Sk, int H, int Hkv, int D,
                int causal, int window, int q_offset, float scale,
                int splits, cudaStream_t s) {
  switch (D) {
#define FLASH_CC_CASE(d)                                                   \
  case d:                                                                  \
    return launch<d, float>(q, k, v, out, lse, B, Sq, Sk, H, Hkv, causal,  \
                            window, q_offset, scale, splits, s);
    FLASH_CC_CASE(16)
    FLASH_CC_CASE(32)
    FLASH_CC_CASE(64)
    FLASH_CC_CASE(80)
    FLASH_CC_CASE(128)
    FLASH_CC_CASE(256)
    FLASH_CC_CASE(448)
#undef FLASH_CC_CASE
    default:
      return -1;
  }
}

}  // namespace cc

// ------------------------------------------- bf16: tensor-core kernel

using tc::bf16;
constexpr int kTcRows = 64;  // query rows per CTA, 16 per warp
constexpr int kPad = 8;      // bf16 elements of padding per shared row

// Keys per K/V tile at head dim D.
__host__ __device__ constexpr int tc_keys(int D) { return D > 128 ? 32 : 64; }

// Shared memory: Q [64][D + kPad], then K and V [2][keys][D + kPad] each.
__host__ __device__ constexpr int tc_smem_bytes(int D) {
  return (kTcRows + 4 * tc_keys(D)) * (D + kPad) * 2;
}

// The explicit minimum of one CTA per SM lets ptxas go past 128 registers
// (without it D 64 was held to 128 and spilled; D 256 takes 254).
template <int D>
__global__ void __launch_bounds__(kThreads, 1) flash_attention_tc(
    const bf16* __restrict__ q, const bf16* __restrict__ k,
    const bf16* __restrict__ v, bf16* __restrict__ out,
    float* __restrict__ lse, int Sq, int Sk, int H, int Hkv, int causal,
    int window, int q_offset, float scale_log2) {
  constexpr int BKV = tc_keys(D), LD = D + kPad, RUNS = D / 8;
  constexpr int KD = D / 16;        // 16-deep steps of q.k
  constexpr bool QREG = D <= 128;   // Q fragments kept in registers
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* q_s = reinterpret_cast<bf16*>(smem_raw);
  bf16* k_s = q_s + kTcRows * LD;
  bf16* v_s = k_s + 2 * BKV * LD;
  const int h = blockIdx.x, b = blockIdx.y;
  const int i0 = (gridDim.z - 1 - blockIdx.z) * kTcRows;  // heaviest first
  const int hk = h / (H / Hkv);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t4 = lane & 3;
  const int rows = min(kTcRows, Sq - i0);

  for (int i = tid; i < kTcRows * RUNS; i += kThreads) {
    const int r = i / RUNS, c = (i % RUNS) * 8;
    const bool in = r < rows;
    tc::cp_async16(
        q_s + r * LD + c,
        in ? q + ((static_cast<size_t>(b) * Sq + i0 + r) * H + h) * D + c : q,
        in ? 16 : 0);
  }
  auto load_kv = [&](int j, int st) {
    const int k0 = j * BKV;
    for (int i = tid; i < BKV * RUNS; i += kThreads) {
      const int t = i / RUNS, c = (i % RUNS) * 8;
      const bool in = k0 + t < Sk;
      const size_t off =
          in ? ((static_cast<size_t>(b) * Sk + k0 + t) * Hkv + hk) * D + c : 0;
      tc::cp_async16(k_s + (st * BKV + t) * LD + c, k + off, in ? 16 : 0);
      tc::cp_async16(v_s + (st * BKV + t) * LD + c, v + off, in ? 16 : 0);
    }
  };

  // the key range this tile's rows can see
  const int q_lo = q_offset + i0;
  const int q_hi = q_offset + i0 + rows - 1;
  const int nk = (Sk + BKV - 1) / BKV;
  int j_hi = nk - 1;
  if (causal) j_hi = q_hi < 0 ? -1 : min(j_hi, q_hi / BKV);
  int j_lo = 0;
  if (window > 0) {
    const int first = q_lo - window + 1;  // earliest key of the earliest row
    if (first > 0) j_lo = first / BKV;
  }
  if (j_lo <= j_hi) load_kv(j_lo, 0);
  tc::cp_async_commit();

  // this thread's rows: warp * 16 + g and + 8 of the tile
  const int qpos0 = q_offset + i0 + warp * 16 + g;
  float o[D / 8][4] = {};
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
  unsigned qf[QREG ? KD : 1][4];
  for (int j = j_lo; j <= j_hi; ++j) {
    const int st = (j - j_lo) & 1;
    if (j < j_hi) load_kv(j + 1, st ^ 1);  // in flight during this tile
    tc::cp_async_commit();
    tc::cp_async_wait<1>();
    __syncthreads();
    const bf16* ks = k_s + st * BKV * LD;
    const bf16* vs = v_s + st * BKV * LD;
    if constexpr (QREG) {
      if (j == j_lo) {
#pragma unroll
        for (int kk = 0; kk < KD; ++kk)
          tc::ldsm_x4(qf[kk], q_s + (warp * 16 + (lane & 15)) * LD +
                                  kk * 16 + (lane >> 4) * 8);
      }
    }

    // S = Q K^T: [16 rows x BKV keys] a warp
    float s[BKV / 8][4] = {};
#pragma unroll
    for (int kk = 0; kk < KD; ++kk) {
      unsigned a[4];
      if constexpr (QREG) {
#pragma unroll
        for (int r = 0; r < 4; ++r) a[r] = qf[kk][r];
      } else {
        tc::ldsm_x4(a, q_s + (warp * 16 + (lane & 15)) * LD + kk * 16 +
                           (lane >> 4) * 8);
      }
#pragma unroll
      for (int p = 0; p < BKV / 16; ++p) {  // two blocks of 8 keys
        unsigned kb[4];
        tc::ldsm_x4(kb, ks + (p * 16 + (lane & 7) + (lane >> 4) * 8) * LD +
                            kk * 16 + ((lane >> 3) & 1) * 8);
        tc::mma_bf16(s[2 * p], a, kb[0], kb[1]);
        tc::mma_bf16(s[2 * p + 1], a, kb[2], kb[3]);
      }
    }

    // scale (to log2 units) and mask; only tiles on an edge need the mask
    const int k0 = j * BKV;
    const bool edge = k0 + BKV > Sk || (causal && k0 + BKV - 1 > q_lo) ||
                      (window > 0 && q_lo + kTcRows - 1 - k0 >= window);
#pragma unroll
    for (int nf = 0; nf < BKV / 8; ++nf)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        float x = s[nf][i] * scale_log2;
        if (edge) {
          const int kpos = k0 + nf * 8 + t4 * 2 + (i & 1);
          const int qpos = qpos0 + (i >> 1) * 8;
          const bool ok = kpos < Sk && (!causal || kpos <= qpos) &&
                          (window == 0 || qpos - kpos < window);
          if (!ok) x = kNegInf;
        }
        s[nf][i] = x;
      }

    // online softmax, row r of this thread in s[.][2r], s[.][2r + 1]; the
    // four threads of a quad hold one row.  Masked keys get probability 0,
    // so a row that has seen no key yet keeps l = 0 and o = 0.
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float mx = kNegInf;
#pragma unroll
      for (int nf = 0; nf < BKV / 8; ++nf)
        mx = fmaxf(mx, fmaxf(s[nf][2 * r], s[nf][2 * r + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m[r], mx);
      const float corr = m[r] > kMasked ? exp2f(m[r] - m_new) : 1.f;
      float sum = 0.f;
#pragma unroll
      for (int nf = 0; nf < BKV / 8; ++nf)
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const float x = s[nf][2 * r + c];
          const float p = x > kMasked ? exp2f(x - m_new) : 0.f;
          s[nf][2 * r + c] = p;
          sum += p;
        }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      l[r] = l[r] * corr + sum;
      m[r] = m_new;
#pragma unroll
      for (int df = 0; df < D / 8; ++df) {
        o[df][2 * r] *= corr;
        o[df][2 * r + 1] *= corr;
      }
    }

    // O += P V with P = hi + lo in bf16: the score fragments of keys
    // 16kk .. 16kk + 15 are the A fragment of that 16-deep step
#pragma unroll
    for (int kk = 0; kk < BKV / 16; ++kk) {
      unsigned ph[4], pl[4];
      tc::split_bf16(s[2 * kk][0], s[2 * kk][1], ph[0], pl[0]);
      tc::split_bf16(s[2 * kk][2], s[2 * kk][3], ph[1], pl[1]);
      tc::split_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1], ph[2], pl[2]);
      tc::split_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3], ph[3], pl[3]);
#pragma unroll
      for (int dq = 0; dq < D / 16; ++dq) {  // two blocks of 8 columns
        unsigned vb[4];
        tc::ldsm_x4_trans(
            vb, vs + (kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * LD +
                    dq * 16 + (lane >> 4) * 8);
        tc::mma_bf16(o[2 * dq], ph, vb[0], vb[1]);
        tc::mma_bf16(o[2 * dq], pl, vb[0], vb[1]);
        tc::mma_bf16(o[2 * dq + 1], ph, vb[2], vb[3]);
        tc::mma_bf16(o[2 * dq + 1], pl, vb[2], vb[3]);
      }
    }
    __syncthreads();  // this stage is overwritten by the tile after next
  }
  tc::cp_async_wait<0>();

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = warp * 16 + g + 8 * r;
    if (row >= rows) continue;
    const float L = fmaxf(l[r], 1e-30f);
    if (lse != nullptr && t4 == 0)
      lse[(static_cast<size_t>(b) * H + h) * Sq + i0 + row] =
          (m[r] + log2f(L)) * kLn2;
    bf16* dst = out + ((static_cast<size_t>(b) * Sq + i0 + row) * H + h) * D;
#pragma unroll
    for (int df = 0; df < D / 8; ++df)
      *reinterpret_cast<__nv_bfloat162*>(dst + df * 8 + t4 * 2) =
          __floats2bfloat162_rn(o[df][2 * r] / L, o[df][2 * r + 1] / L);
  }
}

template <int D>
int launch_tc(const void* q, const void* k, const void* v, void* out,
              float* lse, int B, int Sq, int Sk, int H, int Hkv, int causal,
              int window, int q_offset, float scale, cudaStream_t stream) {
  constexpr int bytes = tc_smem_bytes(D);
  auto kernel = flash_attention_tc<D>;
  if (bytes > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const dim3 grid(H, B, (Sq + kTcRows - 1) / kTcRows);
  kernel<<<grid, kThreads, bytes, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<bf16*>(out), lse, Sq, Sk, H,
      Hkv, causal, window, q_offset, scale * 1.4426950408889634f);
  return static_cast<int>(cudaGetLastError());
}

// The bf16 head dims the tensor-core kernel takes (every other D in the
// wrapper's HEAD_DIMS, 448, runs the CUDA-core kernel).
bool tc_head_dim(int D) {
  return D == 16 || D == 32 || D == 64 || D == 80 || D == 128 || D == 256;
}


int launch_bf16(const void* q, const void* k, const void* v, void* out,
                float* lse, int B, int Sq, int Sk, int H, int Hkv, int D,
                int causal, int window, int q_offset, float scale,
                int splits, cudaStream_t s) {
  switch (D) {
#define FLASH_TC_CASE(d)                                                   \
  case d:                                                                  \
    return launch_tc<d>(q, k, v, out, lse, B, Sq, Sk, H, Hkv, causal,      \
                        window, q_offset, scale, s);
    FLASH_TC_CASE(16)
    FLASH_TC_CASE(32)
    FLASH_TC_CASE(64)
    FLASH_TC_CASE(80)
    FLASH_TC_CASE(128)
    FLASH_TC_CASE(256)
#undef FLASH_TC_CASE
    case 448:
      return cc::launch<448, __nv_bfloat16>(q, k, v, out, lse, B, Sq, Sk, H,
                                            Hkv, causal, window, q_offset,
                                            scale, splits, s);
    default:
      return -1;
  }
}

}  // namespace

extern "C" {

// Bytes of dynamic shared memory one CTA needs for dtype (0 fp32, 1 bf16)
// and head dim D (-1 for a D without an instantiation); the wrapper checks
// it against the card's 227 KB before launching.
int flash_attention_smem_bytes(int dtype, int D) {
  if (dtype == 1 && tc_head_dim(D)) return tc_smem_bytes(D);
  return cc::smem_bytes(D);
}

// Query rows one CTA takes for dtype and D.
int flash_attention_tile_rows(int dtype, int D) {
  return dtype == 1 && tc_head_dim(D) ? kTcRows : cc::BM;
}

// Which hand-written instantiation runs for dtype and D.
const char* flash_attention_variant(int dtype, int D) {
  if (dtype == 1 && tc_head_dim(D))
    return "bf16 mma.sync (FlashAttention-2 tiles of 64 rows, p = hi + lo)";
  return dtype == 1
             ? "bf16 widened to fp32, register-tiled CUDA-core FMAs (32 rows "
               "a CTA, 64-key tiles, keys split over a cluster)"
             : "fp32 register-tiled CUDA-core FMAs (32 rows a CTA, 64-key "
               "tiles, keys split over a cluster)";
}

// q [B, Sq, H, D], k/v [B, Sk, Hkv, D], out [B, Sq, H, D], all contiguous,
// 16-byte aligned and of one type, dtype: 0 fp32, 1 bf16.  D one of 16,
// 32, 64, 80, 128, 256, 448; H a multiple of Hkv.  Query row i sits at
// q_offset + i.  splits (1, 2, 4 or 8: the CTAs of a cluster that share
// one query tile's keys) is read by the CUDA-core kernel only (fp32, and
// bf16 at D 448).  lse, when not null, is [B, H, Sq] fp32: each row's
// logsumexp of its visible scaled scores in natural units, m + log(max(l,
// 1e-30)) after the split merge (the backward's saved residual; serving
// passes null and writes none).  Returns cudaGetLastError() after the
// launch, -1 for a bad dtype code or D, -2 for a bad splits.
int flash_attention_launch_lse(int dtype, const void* q, const void* k,
                               const void* v, void* out, void* lse, int B,
                               int Sq, int Sk, int H, int Hkv, int D,
                               int causal, int window, int q_offset,
                               float scale, int splits, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* lp = static_cast<float*>(lse);
  switch (dtype) {
    case 0:
      return cc::launch_fp32(q, k, v, out, lp, B, Sq, Sk, H, Hkv, D, causal,
                             window, q_offset, scale, splits, s);
    case 1:
      return launch_bf16(q, k, v, out, lp, B, Sq, Sk, H, Hkv, D, causal,
                         window, q_offset, scale, splits, s);
    default:
      return -1;
  }
}

// flash_attention_launch_lse without the lse (the serving entry point).
int flash_attention_launch(int dtype, const void* q, const void* k,
                           const void* v, void* out, int B, int Sq, int Sk,
                           int H, int Hkv, int D, int causal, int window,
                           int q_offset, float scale, int splits,
                           void* stream) {
  return flash_attention_launch_lse(dtype, q, k, v, out, nullptr, B, Sq, Sk,
                                    H, Hkv, D, causal, window, q_offset,
                                    scale, splits, stream);
}

}  // extern "C"
