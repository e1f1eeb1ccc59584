// Paged multi-token verify attention for Hopper (sm_90a): T query tokens
// per slot, at positions pos .. pos+T-1, against a paged K/V pool
// addressed through a block table, causal per query row.
//
// Replaces the Pallas TPU kernels paged_verify_tpu and
// paged_verify_quant_tpu (repro/kernels/paged_verify.py:95,147).  One
// source covers both: the page type is a template parameter (bf16 pages,
// or int8 pages with fp32 per-row scales), as the JAX package's
// _quant_kernel reuses _kernel.  The serving path calls it for the T = k+1
// rows of a speculative verify pass and for the C rows of every
// chunked-prefill chunk (qpos = pos + arange(C)).
//
// What it computes, per slot b, token t and query head h (kv head h / G):
//   key j*bs + i (page block_tables[b, j], row i) is visible to row t iff
//   the table entry is >= 0, j*bs + i <= pos[b] + t and, when window > 0,
//   pos[b] + t - (j*bs + i) < window; out = softmax(q.k * D^-0.5) . v over
//   the visible keys, with the softmax in fp32 and each probability
//   rounded to the page type before the value product (bf16 pages; int8
//   pages are dequantized to fp32 and keep it fp32), as the plain version
//   (the JAX package's chunk attention) does: an MoE router turns the
//   ~1e-3 difference of unrounded probabilities into other experts.  The
//   rounding needs the row's final max m and sum l, so a running max (one
//   pass, online) will not do.  A row with no visible key (a free slot's
//   rows: its table is all -1) gets what the plain version gives it: the
//   uniform softmax over the NEG_INF fills of every key the table
//   addresses, i.e. the mean of the NB*bs value rows, -1 entries read from
//   the null page 0 (the weight 1/(NB*bs) rounded as above).  Nobody reads
//   such a row's attention, but an MoE layer routes its token.
//
// What bounds it on an H100: bytes at the verify shape (B 8, T 4, G 7:
// each K/V element is used by 28 rows, far under the ~295 flops per byte
// where the bf16 tensor cores take over), operations at long chunks.
// One CTA per (row tile, kv head, slot) would run 32 CTAs on 132 SMs at
// the verify shape, each walking its slot's whole context twice.  The
// design, for bf16 queries (what every bf16 serving path sends):
//   * split-KV: the grid is (split, row tile, slot x kv head).  The T*G
//     rows of a (slot, kv head) are flattened token-major (row r is token
//     r / G, query head r % G; all G heads share each K/V tile) and cut
//     into tiles of 16, 32 or 64 rows (a warp a 16), and the NB*bs keys of
//     the table into splits of split_keys (a multiple of the 64- or 32-key
//     staged tile), so that a verify pass runs about two CTAs per SM.  The
//     plan (tile rows, split keys) comes from the shapes alone
//     (kernels/paged_verify.py:plan): pos is never read on the host.  A
//     CTA whose split lies wholly past its rows' positions, or before
//     their window, exits at once;
//   * three passes from one C call.  Pass 1 (scores): S = Q K^T over the
//     split's visible keys, scaled (to exp2 units) and masked, and each
//     row's split-local max m_i and sum l_i of exp2(s - m_i) to an fp32
//     scratch.  Pass 2 (values): each CTA merges all splits' (m_i, l_i) of
//     its rows in split order (every CTA gets the same m and l; a split
//     with no visible key gives (NEG_INF, 0) and is skipped), recomputes
//     its split's scores with pass 1's instructions (bitwise the same),
//     forms p = exp2(s - m) * (1 / l), rounds it to the page type and
//     accumulates p V: the [rows, D] fp32 partial goes to scratch (or,
//     with one split, the output).  Pass 3 sums the partials in split
//     order and writes bf16;
//   * rows with no visible key: every split's pass 2 takes p = 1/(NB*bs)
//     on each of its keys (table entries -1 read page 0, keys past the
//     table give 0), so the mean is spread over the split CTAs and summed
//     in split order by pass 3;
//   * K and V tiles stream through a two-stage cp.async ring (16-byte
//     copies read in place through the [P, bs, Hkv, D] strides, no
//     gathered copy; one tile in flight while the previous one
//     multiplies); the block-table entries of the split are staged first;
//   * bf16 queries multiply on the tensor cores: mma.sync m16n8k16 with
//     bf16 operands from ldmatrix and fp32 accumulators (csrc/tc_bf16.cuh);
//     the score accumulators become the A fragments of P V, V through
//     ldmatrix.trans.  int8 pages are widened to bf16 in shared memory
//     (|x| <= 127 is exact), the scores of key j scaled by k_scales[j] *
//     D^-0.5 after the product, and since the plain version keeps fp32 p
//     for int8 pages, p' = p * v_scales[j] is split into bf16 hi + lo and
//     both go through the mma (p' to within 2^-16);
//   * fp32 queries (the tests, fp32 parity runs) run the CUDA-core kernel
//     of namespace fp32q below instead, whose arithmetic is the paged-decode
//     kernel's.
// Later work: wgmma with TMA for long chunks.  Paged decode (T = 1) splits
// its keys by the same rule (kernels/paged_decode.py:split_rule).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "tc_bf16.cuh"

namespace {

using tc::bf16;

constexpr int kMaxThreads = 128;  // four warps: a 64-row tile
constexpr int kPad = 8;           // bf16 elements of padding per shared row
constexpr float kNegInf = -1e30f;
constexpr float kMasked = -1e29f;  // scores at or below this are masked
constexpr int kNoKey = -2;         // page entry of a key past the table
constexpr int kMaxSplits = 32;     // splits a call may have (a bit each)

// Keys per staged tile at head dim D (32 past D 128 keeps a warp's [16, D]
// fp32 output in registers).
__host__ __device__ constexpr int key_tile(int D) { return D > 128 ? 32 : 64; }

struct Args {
  const void* q;
  const void* k_pages;
  const void* v_pages;
  const float* k_scales;
  const float* v_scales;
  const int32_t* block_tables;
  const int32_t* pos;
  float* m;        // [B*Hkv][tiles][splits][rows]: split-local row max
  float* l;        // the same: sum of exp(s - m) over the split
  float* partial;  // [B*Hkv][tiles][splits][rows][D]; null with 1 split
  void* out;
  int T, H, Hkv, D, bs, NB, window;
  int rows;        // query rows per tile: 16, 32 or 64
  int tiles;       // row tiles per (slot, kv head)
  int split_keys;  // keys per split, a multiple of key_tile(D)
  int splits;
  float scale;
};

__host__ __device__ inline int align16(int x) { return (x + 15) & ~15; }

// Byte offsets into dynamic shared memory.
struct Smem {
  int q, k_raw, v_raw, k_op, v_op, page, k_scale, v_scale, bt, m, l, bytes;
};

// quant: int8 pages (staged raw, then widened into the bf16 operand tiles
// k_op, v_op).
__host__ __device__ inline Smem smem_layout(bool quant, int D, int rows,
                                            int split_keys, int splits,
                                            int bs) {
  const int KT = key_tile(D);
  const int raw_row = quant ? D + 16 : (D + kPad) * 2;
  const int op_tile = quant ? KT * (D + kPad) * 2 : 0;
  const int sizes[11] = {
      rows * (D + kPad) * 2,       // q
      2 * KT * raw_row,            // k_raw ring
      2 * KT * raw_row,            // v_raw ring
      op_tile,                     // k_op
      op_tile,                     // v_op
      4 * KT * 4,                  // pages, rows
      quant ? 2 * KT * 4 : 0,      // k_scale
      quant ? 2 * KT * 4 : 0,      // v_scale
      (split_keys / bs + 2) * 4,   // block table
      splits * rows * 4,           // m
      splits * rows * 4};          // l
  int at[11];
  int total = 0;
  for (int i = 0; i < 11; ++i) {
    at[i] = total;
    total += align16(sizes[i]);
  }
  return Smem{at[0], at[1], at[2], at[3], at[4],  at[5],
              at[6], at[7], at[8], at[9], at[10], total};
}

__device__ __forceinline__ void store2(float* dst, float x, float y) {
  *reinterpret_cast<float2*>(dst) = make_float2(x, y);
}
__device__ __forceinline__ void store2(bf16* dst, float x, float y) {
  *reinterpret_cast<__nv_bfloat162*>(dst) = __floats2bfloat162_rn(x, y);
}

// 4 bytes from global src to shared dst (src_bytes 0: zero-filled).
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   tc::smem_addr(dst)),
               "l"(src), "r"(src_bytes));
}

// What a row tile can see: its valid rows, the slot's pos, the union
// [lo, hi] of its rows' visible key ranges (hi < lo: none) and the S keys
// the table addresses.  Passes 1-3 compute it alike.
struct Span {
  int rows, p0, lo, hi, S;
  // Bit s: split s holds a key of [lo, hi] (splits <= 32).
  __device__ unsigned live_mask(int splits, int split_keys) const {
    unsigned mask = 0;
    for (int s = 0; s < splits; ++s) {
      const int k0 = s * split_keys, k1 = min(k0 + split_keys, S);
      mask |= unsigned(max(k0, lo) <= min(k1 - 1, hi)) << s;
    }
    return mask;
  }
};

__device__ __forceinline__ Span tile_span(const Args& a, int b, int tile) {
  const int G = a.H / a.Hkv, r0 = tile * a.rows;
  Span sp;
  sp.rows = min(a.rows, a.T * G - r0);
  sp.p0 = a.pos[b];
  sp.S = a.NB * a.bs;
  const int first = sp.p0 + r0 / G, last = sp.p0 + (r0 + sp.rows - 1) / G;
  sp.lo = a.window > 0 ? max(0, first - a.window + 1) : 0;
  sp.hi = min(last, sp.S - 1);
  return sp;
}

// Raw dot products of a warp's 16 query rows with a tile's KT keys on the
// tensor cores, in the mma.sync C layout: sc[nf][i] is row g + 8 * (i >>
// 1), key nf * 8 + 2 * t4 + (i & 1) (lane = 4 g + t4).
template <int D>
__device__ __forceinline__ void tile_scores(float (&sc)[key_tile(D) / 8][4],
                                            const bf16* q_s, const bf16* k_t,
                                            int warp, int lane) {
  constexpr int KT = key_tile(D), LD = D + kPad;
#pragma unroll
  for (int nf = 0; nf < KT / 8; ++nf)
#pragma unroll
    for (int i = 0; i < 4; ++i) sc[nf][i] = 0.f;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    unsigned a[4];
    tc::ldsm_x4(a, q_s + (warp * 16 + (lane & 15)) * LD + kk * 16 +
                       (lane >> 4) * 8);
#pragma unroll
    for (int p = 0; p < KT / 16; ++p) {  // two blocks of 8 keys
      unsigned kb[4];
      tc::ldsm_x4(kb, k_t + (p * 16 + (lane & 7) + (lane >> 4) * 8) * LD +
                          kk * 16 + ((lane >> 3) & 1) * 8);
      tc::mma_bf16(sc[2 * p], a, kb[0], kb[1]);
      tc::mma_bf16(sc[2 * p + 1], a, kb[2], kb[3]);
    }
  }
}

// o += P V for a warp's 16 rows over a tile's KT keys on the tensor cores;
// pr holds P in the layout of tile_scores and becomes the A fragment (bf16
// pages: p, rounded to bf16 by the operand's conversion; int8 pages: p *
// v_scale, split into bf16 hi + lo, two products), V through
// ldmatrix.trans.
template <bool kQuant, int D>
__device__ __forceinline__ void tile_values(float (&o)[D / 8][4],
                                            float (&pr)[key_tile(D) / 8][4],
                                            const bf16* v_t, int lane) {
  constexpr int KT = key_tile(D), LD = D + kPad;
#pragma unroll
  for (int kk = 0; kk < KT / 16; ++kk) {
    unsigned ph[4], pl[4];
    if constexpr (kQuant) {
      tc::split_bf16(pr[2 * kk][0], pr[2 * kk][1], ph[0], pl[0]);
      tc::split_bf16(pr[2 * kk][2], pr[2 * kk][3], ph[1], pl[1]);
      tc::split_bf16(pr[2 * kk + 1][0], pr[2 * kk + 1][1], ph[2], pl[2]);
      tc::split_bf16(pr[2 * kk + 1][2], pr[2 * kk + 1][3], ph[3], pl[3]);
    } else {
      ph[0] = tc::pack_bf16(pr[2 * kk][0], pr[2 * kk][1]);
      ph[1] = tc::pack_bf16(pr[2 * kk][2], pr[2 * kk][3]);
      ph[2] = tc::pack_bf16(pr[2 * kk + 1][0], pr[2 * kk + 1][1]);
      ph[3] = tc::pack_bf16(pr[2 * kk + 1][2], pr[2 * kk + 1][3]);
    }
#pragma unroll
    for (int dq = 0; dq < D / 16; ++dq) {  // two blocks of 8 columns
      unsigned vb[4];
      tc::ldsm_x4_trans(
          vb, v_t + (kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * LD +
                  dq * 16 + (lane >> 4) * 8);
      tc::mma_bf16(o[2 * dq], ph, vb[0], vb[1]);
      tc::mma_bf16(o[2 * dq + 1], ph, vb[2], vb[3]);
      if constexpr (kQuant) {
        tc::mma_bf16(o[2 * dq], pl, vb[0], vb[1]);
        tc::mma_bf16(o[2 * dq + 1], pl, vb[2], vb[3]);
      }
    }
  }
}

// 16 int8 page elements a thread, widened to bf16 (exact for |x| <= 127):
// the raw [KT][D + 16] stage into the [KT][D + kPad] operand tile.
template <int D>
__device__ __forceinline__ void widen(const unsigned char* raw, bf16* op,
                                      int tid, int nthr) {
  constexpr int KT = key_tile(D), LD = D + kPad, RAW = D + 16;
  for (int i = tid; i < KT * (D / 16); i += nthr) {
    const int t = i / (D / 16), c = (i % (D / 16)) * 16;
    const uint4 v = *reinterpret_cast<const uint4*>(raw + t * RAW + c);
    const int8_t* e = reinterpret_cast<const int8_t*>(&v);
    uint4 w[2];
    unsigned* u = reinterpret_cast<unsigned*>(w);
#pragma unroll
    for (int x = 0; x < 8; ++x)
      u[x] = tc::pack_bf16(static_cast<float>(e[2 * x]),
                           static_cast<float>(e[2 * x + 1]));
    uint4* dst = reinterpret_cast<uint4*>(op + t * LD + c);
    dst[0] = w[0];
    dst[1] = w[1];
  }
}

// Pass 1 (kValues false: scores, split-local m and l) or pass 2 (kValues:
// merge, rounded p, p V) of one (split, row tile, slot x kv head), bf16
// queries; PT: bf16 or int8 pages.
template <typename PT, int D, bool kValues>
__global__ void __launch_bounds__(kMaxThreads, 1)
    verify_split(const Args a) {
  constexpr bool kQuant = std::is_same<PT, int8_t>::value;
  constexpr int KT = key_tile(D), LD = D + kPad;
  constexpr int RAW = kQuant ? D + 16 : LD * 2;    // bytes of a staged row
  constexpr int CH = D * int(sizeof(PT)) / 16;     // 16-byte copies a row
  extern __shared__ __align__(16) unsigned char smem[];
  const Smem L = smem_layout(kQuant, D, a.rows, a.split_keys, a.splits,
                             a.bs);
  const int s = blockIdx.x, tile = blockIdx.y, bh = blockIdx.z;
  const int b = bh / a.Hkv, h = bh % a.Hkv, G = a.H / a.Hkv;
  const int tid = threadIdx.x, nthr = blockDim.x;
  const int lane = tid & 31, warp = tid >> 5, g = lane >> 2, t4 = lane & 3;
  const Span sp = tile_span(a, b, tile);
  const int S = sp.S;
  const int k0 = s * a.split_keys, k1 = min(k0 + a.split_keys, S);
  const int r0 = tile * a.rows;
  // (slot x kv head, tile, split 0) in the [.][tiles][splits][rows] scratch
  const size_t ml0 = (static_cast<size_t>(bh) * a.tiles + tile) * a.splits;

  int* bt_s = reinterpret_cast<int*>(smem + L.bt);
  const int e0 = k0 / a.bs, ne = (k1 - 1) / a.bs - e0 + 1;
  for (int i = tid; i < ne; i += nthr)
    bt_s[i] = a.block_tables[static_cast<size_t>(b) * a.NB + e0 + i];
  const unsigned live_mask = sp.live_mask(a.splits, a.split_keys);
  const bool live = live_mask >> s & 1u;
  if (!kValues && !live) return;  // no row of the tile sees a key here
  __syncthreads();                // bt_s

  int* page_s = reinterpret_cast<int*>(smem + L.page);
  int* row_s = page_s + 2 * KT;  // pool row (page, key % bs, h) of a key
  float* ks_s = reinterpret_cast<float*>(smem + L.k_scale);
  float* vs_s = reinterpret_cast<float*>(smem + L.v_scale);
  unsigned char* k_raw = smem + L.k_raw;
  unsigned char* v_raw = smem + L.v_raw;
  const PT* kp = static_cast<const PT*>(a.k_pages);
  const PT* vp = static_cast<const PT*>(a.v_pages);
  const bool scores = live;  // else pass 2 runs for rows with no key only
  // tile j into ring stage st: page entries (-1 unallocated, kNoKey past
  // the table) and pool rows, one key a thread, then K rows of allocated
  // entries (scores), V rows of every key of the table, -1 entries from
  // the null page 0 (pass 2), and their scales; the rest zero-filled.
  // All threads call it (it holds a barrier).
  auto load_tile = [&](int j, int st) {
    const int kt0 = k0 + j * KT;
    for (int i = tid; i < KT; i += nthr) {
      const int k = kt0 + i;
      const int page = k < S ? bt_s[k / a.bs - e0] : kNoKey;
      const int row = (max(page, 0) * a.bs + k % a.bs) * a.Hkv + h;
      page_s[st * KT + i] = page;
      row_s[st * KT + i] = row;
      if constexpr (kQuant) {
        if (scores)
          cp_async4(ks_s + st * KT + i, a.k_scales + (page >= 0 ? row : 0),
                    page >= 0 ? 4 : 0);
        if (kValues)
          cp_async4(vs_s + st * KT + i, a.v_scales + (page >= -1 ? row : 0),
                    page >= -1 ? 4 : 0);
      }
    }
    __syncthreads();  // page_s, row_s
    for (int i = tid; i < KT * CH; i += nthr) {
      const int t = i / CH, c = i % CH;
      const int page = page_s[st * KT + t];
      const size_t el = static_cast<size_t>(row_s[st * KT + t]) * D +
                        c * (16 / int(sizeof(PT)));
      const int dst = (st * KT + t) * RAW + c * 16;
      if (scores)
        tc::cp_async16(k_raw + dst, kp + (page >= 0 ? el : 0),
                       page >= 0 ? 16 : 0);
      if (kValues)
        tc::cp_async16(v_raw + dst, vp + (page >= -1 ? el : 0),
                       page >= -1 ? 16 : 0);
    }
  };

  // copies in flight before anything waits: (pass 2) every live split's
  // (m_i, l_i) of the tile's rows, then Q and the first visible key tile
  float* m_s = reinterpret_cast<float*>(smem + L.m);
  float* l_s = reinterpret_cast<float*>(smem + L.l);
  if constexpr (kValues) {
    for (int i = tid; i < a.splits * a.rows; i += nthr) {
      const int in = live_mask >> (i / a.rows) & 1u ? 4 : 0;
      cp_async4(m_s + i, a.m + ml0 * a.rows + (in ? i : 0), in);
      cp_async4(l_s + i, a.l + ml0 * a.rows + (in ? i : 0), in);
    }
    tc::cp_async_commit();
  }
  // the key tiles (of KT keys from k0) the tile's rows can see
  const int jv_lo = live ? (max(k0, sp.lo) - k0) / KT : 0;
  const int jv_hi = live ? (min(k1 - 1, sp.hi) - k0) / KT : -1;
  bf16* q_s = reinterpret_cast<bf16*>(smem + L.q);
  if (live) {
    for (int i = tid; i < a.rows * (D / 8); i += nthr) {
      const int r = i / (D / 8), c = (i % (D / 8)) * 8;
      const bool in = r < sp.rows;
      const int gr = r0 + r;
      const size_t off =
          in ? ((static_cast<size_t>(b) * a.T + gr / G) * a.H + h * G +
                gr % G) * D + c
             : 0;
      tc::cp_async16(q_s + r * LD + c, static_cast<const bf16*>(a.q) + off,
                     in ? 16 : 0);
    }
    load_tile(jv_lo, 0);
  }
  tc::cp_async_commit();

  // this lane's rows of the tile: warp * 16 + g and + 8
  bool valid[2];
  int rpos[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = warp * 16 + g + 8 * i;
    valid[i] = r < sp.rows;
    rpos[i] = sp.p0 + (r0 + r) / G;
  }
  float mrow[2] = {kNegInf, kNegInf}, lrow[2] = {0.f, 0.f};
  bool dead[2] = {false, false};
  bool any_dead = false;
  if constexpr (kValues) {
    // every split's (m_i, l_i) of this lane's rows, merged in split order:
    // the four lanes of a quad (they share a row) take every fourth split,
    // then each lane adds all the splits' terms in split order
    tc::cp_async_wait<1>();
    __syncthreads();
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int r = warp * 16 + g + 8 * i;
      float mx = kNegInf;
#pragma unroll
      for (int u = 0; u < kMaxSplits / 4; ++u) {
        const int t = 4 * u + t4;
        if (t < a.splits && (live_mask >> t & 1u))
          mx = fmaxf(mx, m_s[t * a.rows + r]);
      }
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      float term[kMaxSplits / 4];
#pragma unroll
      for (int u = 0; u < kMaxSplits / 4; ++u) {
        const int t = 4 * u + t4;
        float x = 0.f;
        if (t < a.splits && (live_mask >> t & 1u)) {
          const float lt = l_s[t * a.rows + r];
          if (lt > 0.f) x = lt * exp2f(m_s[t * a.rows + r] - mx);
        }
        term[u] = x;
      }
      float sum = 0.f;  // a split with no key adds +0: the sum is unchanged
#pragma unroll
      for (int t = 0; t < kMaxSplits; ++t) {
        const float x =
            __shfl_sync(0xffffffffu, term[t / 4], (lane & ~3) | (t & 3));
        if (t < a.splits) sum += x;
      }
      mrow[i] = mx;
      lrow[i] = sum;
      dead[i] = valid[i] && sum == 0.f;
    }
    any_dead = __syncthreads_or(dead[0] || dead[1]);
    if (!live && !any_dead) return;
  }
  // 0 for padding rows and rows with no key (never used for the latter)
  const float inv_l[2] = {lrow[0] > 0.f ? 1.f / lrow[0] : 0.f,
                          lrow[1] > 0.f ? 1.f / lrow[1] : 0.f};

  // a row of the tile that sees no key at all reads every key of the
  // split (its mean); the tile prefetched above is then reloaded unless it
  // is the split's first
  int j_lo = jv_lo, j_hi = jv_hi;
  if (kValues && any_dead) {
    j_lo = 0;
    j_hi = (k1 - 1 - k0) / KT;
    if (!live || jv_lo != 0) {
      tc::cp_async_wait<0>();
      __syncthreads();
      load_tile(0, 0);
      tc::cp_async_commit();
    }
  }

  const float uniform = 1.f / static_cast<float>(S);
  const float scale_log2 = a.scale * 1.4426950408889634f;  // exp2 units
  float m_run[2] = {kNegInf, kNegInf}, l_run[2] = {0.f, 0.f};
  float o[kValues ? D / 8 : 1][4] = {};
  for (int j = j_lo; j <= j_hi; ++j) {
    const int st = (j - j_lo) & 1;
    if (j < j_hi) load_tile(j + 1, st ^ 1);  // in flight during this tile
    tc::cp_async_commit();
    tc::cp_async_wait<1>();
    __syncthreads();
    const bf16* k_t;
    const bf16* v_t;
    if constexpr (kQuant) {
      bf16* k_op = reinterpret_cast<bf16*>(smem + L.k_op);
      bf16* v_op = reinterpret_cast<bf16*>(smem + L.v_op);
      if (scores) widen<D>(k_raw + st * KT * RAW, k_op, tid, nthr);
      if (kValues) widen<D>(v_raw + st * KT * RAW, v_op, tid, nthr);
      __syncthreads();
      k_t = k_op;
      v_t = v_op;
    } else {
      k_t = reinterpret_cast<const bf16*>(k_raw + st * KT * RAW);
      v_t = reinterpret_cast<const bf16*>(v_raw + st * KT * RAW);
    }
    const int* pg = page_s + st * KT;
    const int kt0 = k0 + j * KT;

    // scores, scaled (int8: times the key's scale) and masked; pass 2
    // repeats pass 1's instructions on the same values
    float sc[KT / 8][4];
    if (scores) {
      tile_scores<D>(sc, q_s, k_t, warp, lane);
#pragma unroll
      for (int nf = 0; nf < KT / 8; ++nf)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int t = nf * 8 + 2 * t4 + (i & 1), k = kt0 + t;
          float x = sc[nf][i];
          if constexpr (kQuant) x *= ks_s[st * KT + t];
          x *= scale_log2;
          const int P = rpos[i >> 1];
          const bool ok = valid[i >> 1] && pg[t] >= 0 && k <= P &&
                          (a.window == 0 || P - k < a.window);
          sc[nf][i] = ok ? x : kNegInf;
        }
    } else {
#pragma unroll
      for (int nf = 0; nf < KT / 8; ++nf)
#pragma unroll
        for (int i = 0; i < 4; ++i) sc[nf][i] = kNegInf;
    }

    if constexpr (!kValues) {
      // split-local max and sum of each row, online over the tiles; the
      // four lanes of a quad hold one row.  Masked keys add 0.
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        float mx = kNegInf;
#pragma unroll
        for (int nf = 0; nf < KT / 8; ++nf)
          mx = fmaxf(mx, fmaxf(sc[nf][2 * r], sc[nf][2 * r + 1]));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
        const float m_new = fmaxf(m_run[r], mx);
        const float corr =
            m_run[r] > kMasked ? exp2f(m_run[r] - m_new) : 1.f;
        float sum = 0.f;
#pragma unroll
        for (int nf = 0; nf < KT / 8; ++nf)
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            const float x = sc[nf][2 * r + c];
            sum += x > kMasked ? exp2f(x - m_new) : 0.f;
          }
        sum += __shfl_xor_sync(0xffffffffu, sum, 1);
        sum += __shfl_xor_sync(0xffffffffu, sum, 2);
        l_run[r] = l_run[r] * corr + sum;
        m_run[r] = m_new;
      }
    } else {
      // p with the merged (m, l), rounded as the plain version rounds it;
      // a row with no visible key takes 1/S on every key of the table
#pragma unroll
      for (int nf = 0; nf < KT / 8; ++nf)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int t = nf * 8 + 2 * t4 + (i & 1), r = i >> 1;
          const float x = sc[nf][i];
          // (a masked x gives exp2(-1e30 - m) = 0)
          float p = dead[r] ? (pg[t] >= -1 ? uniform : 0.f)
                            : exp2f(x - mrow[r]) * inv_l[r];
          if constexpr (kQuant) p *= vs_s[st * KT + t];
          sc[nf][i] = p;  // bf16 pages: rounded as the operand is packed
        }
      tile_values<kQuant, D>(o, sc, v_t, lane);
    }
    __syncthreads();  // this stage is overwritten by the tile after next
  }
  tc::cp_async_wait<0>();

  if constexpr (!kValues) {
    if (t4 == 0) {
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const size_t at = (ml0 + s) * a.rows + warp * 16 + g + 8 * i;
        a.m[at] = m_run[i];
        a.l[at] = l_run[i];
      }
    }
  } else {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      if (!valid[i]) continue;
      const int r = warp * 16 + g + 8 * i, gr = r0 + r;
      if (a.splits == 1) {  // the output itself
        bf16* dst = static_cast<bf16*>(a.out) +
                  ((static_cast<size_t>(b) * a.T + gr / G) * a.H + h * G +
                   gr % G) * D;
#pragma unroll
        for (int df = 0; df < D / 8; ++df)
          store2(dst + df * 8 + 2 * t4, o[df][2 * i], o[df][2 * i + 1]);
      } else {
        float* dst = a.partial + ((ml0 + s) * a.rows + r) * D;
#pragma unroll
        for (int df = 0; df < D / 8; ++df)
          store2(dst + df * 8 + 2 * t4, o[df][2 * i], o[df][2 * i + 1]);
      }
    }
  }
}

// Pass 3 (more than one split): out[row] = the sum, in split order, of the
// partials of the splits that hold a key of the tile (every split for a
// row with no visible key), in q's type.  One thread a 4-column group of a
// row, grid (groups / 128, tile, slot x kv head); the loads of kUnroll
// splits are issued before their sums, and need neither pos nor each
// other.
constexpr int kUnroll = 8;

__global__ void __launch_bounds__(kMaxThreads) verify_combine(const Args a) {
  const int tile = blockIdx.y, bh = blockIdx.z;
  const int b = bh / a.Hkv, h = bh % a.Hkv, G = a.H / a.Hkv, D = a.D;
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const int r = i / (D / 4), d = (i % (D / 4)) * 4;
  if (r >= a.rows) return;
  const size_t ml0 = (static_cast<size_t>(bh) * a.tiles + tile) * a.splits;
  const float* src = a.partial + (ml0 * a.rows + r) * D + d;
  const size_t stride = static_cast<size_t>(a.rows) * D;
  // every split's sum and partial, loaded before pos is known: the sum
  // over the live splits (those that hold a key of the tile), and over all
  // splits for a row with no visible key (no live split has a positive
  // sum; every split then wrote its partial)
  float4 part = make_float4(0.f, 0.f, 0.f, 0.f);
  float4 all = part;
  bool seen = false;
  const Span sp = tile_span(a, b, tile);
  const unsigned live_mask = sp.live_mask(a.splits, a.split_keys);
  for (int t0 = 0; t0 < a.splits; t0 += kUnroll) {
    float lt[kUnroll];
    float4 x[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const bool in = t0 + u < a.splits;
      lt[u] = in ? a.l[(ml0 + t0 + u) * a.rows + r] : 0.f;
      x[u] = in ? *reinterpret_cast<const float4*>(src + (t0 + u) * stride)
                : make_float4(0.f, 0.f, 0.f, 0.f);
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const bool live = live_mask >> (t0 + u) & 1u;
      seen = seen || (live && lt[u] > 0.f);
      all.x += x[u].x;
      all.y += x[u].y;
      all.z += x[u].z;
      all.w += x[u].w;
      if (live) {
        part.x += x[u].x;
        part.y += x[u].y;
        part.z += x[u].z;
        part.w += x[u].w;
      }
    }
  }
  if (r >= sp.rows) return;
  if (!seen) part = all;
  const int gr = tile * a.rows + r;
  bf16* dst = static_cast<bf16*>(a.out) +
            ((static_cast<size_t>(b) * a.T + gr / G) * a.H + h * G +
             gr % G) * D + d;
  store2(dst, part.x, part.y);
  store2(dst + 2, part.z, part.w);
}

template <typename PT, int D>
int launch_passes(const Args& a, int B, cudaStream_t stream) {
  const int bytes = smem_layout(std::is_same<PT, int8_t>::value, D, a.rows,
                                a.split_keys, a.splits, a.bs)
                        .bytes;
  auto scores = verify_split<PT, D, false>;
  auto values = verify_split<PT, D, true>;
  if (bytes > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        scores, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(
          values, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const dim3 grid(a.splits, a.tiles, B * a.Hkv);
  const int threads = a.rows / 16 * 32;
  scores<<<grid, threads, bytes, stream>>>(a);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  values<<<grid, threads, bytes, stream>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess || a.splits == 1) return static_cast<int>(err);
  const int groups = a.rows * (a.D / 4);  // 4-column groups of a tile
  verify_combine<<<dim3((groups + kMaxThreads - 1) / kMaxThreads, a.tiles,
                        B * a.Hkv),
                   kMaxThreads, 0, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <typename PT>
int launch_dim(const Args& a, int B, cudaStream_t s) {
  switch (a.D) {
    case 16:
      return launch_passes<PT, 16>(a, B, s);
    case 32:
      return launch_passes<PT, 32>(a, B, s);
    case 64:
      return launch_passes<PT, 64>(a, B, s);
    case 128:
      return launch_passes<PT, 128>(a, B, s);
    case 256:
      return launch_passes<PT, 256>(a, B, s);
    default:
      return -1;
  }
}

}  // namespace

// ------------------------------------ fp32 queries: the CUDA-core kernel
//
// fp32 queries (the tests, fp32 parity runs of the engine; no bf16 serving
// path sends them) run a two-walk kernel with fp32 products from shared
// memory, whose scores, max, sum and probabilities are formed as the
// paged-decode kernel forms them (csrc/paged_decode.cu), so that a verify
// row t equals a decode step at pos + t to within summation order (sums
// merged across splits would differ from decode's in their last bit, and
// a probability rounded to bf16 can then fall the other way).  A hi/lo
// split of fp32 q onto the tensor cores would hold the scores to about
// 2^-16 of the sum of |q k| (~8e-5 relative at D 64), too close to the
// fp32 tolerance of 1e-4.
//   * the grid is (tile of kRows query rows, kv head, slot); the T*G rows
//     of one (slot, kv head) are flattened token-major as above;
//   * each CTA walks the blocks its rows can see twice: the first walk
//     stores every fp32 score of its rows (shared memory, or a global
//     scratch row written and read by this CTA alone where that does not
//     fit), m and l come from the stored scores, the second walk reads V
//     only and rounds each probability before the product;
//   * -1 table entries are skipped; a row with no visible key gets the
//     mean of the table's value rows, computed by one CTA.
namespace fp32q {

constexpr float kNegInf = -1e30f;
constexpr float kMasked = -1e29f;  // scores at or below this are masked
constexpr int kThreads = 128;
constexpr int kRows = 16;  // query rows (token x query head) per CTA
constexpr int kWarps = kThreads / 32;

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

template <typename PT>
__global__ void __launch_bounds__(kThreads) paged_verify_kernel(
    const float* __restrict__ q, const PT* __restrict__ k_pages,
    const PT* __restrict__ v_pages, const float* __restrict__ k_scales,
    const float* __restrict__ v_scales,
    const int32_t* __restrict__ block_tables, const int32_t* __restrict__ pos,
    float* scores, float* __restrict__ out, int T, int H, int Hkv, int D,
    int bs, int NB, int window, float scale) {
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
      x = q[((static_cast<size_t>(b) * T + t) * H + h * G + g) * D + d];
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
        l_s[r] == 0.f ? tile[d] : acc[i];
  }
}

template <typename PT>
int launch(const void* q, const void* k_pages, const void* v_pages,
           const void* k_scales, const void* v_scales,
           const void* block_tables, const void* pos, void* scores, void* out,
           int B, int T, int H, int Hkv, int D, int bs, int NB, int window,
           float scale, cudaStream_t stream) {
  const int G = H / Hkv;
  const int score_words = scores != nullptr ? 0 : kRows * NB * bs;
  const size_t bytes = sizeof(float) * smem_floats(D, bs, score_words);
  auto kernel = paged_verify_kernel<PT>;
  if (bytes > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(bytes));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const dim3 grid((T * G + kRows - 1) / kRows, Hkv, B);
  kernel<<<grid, kThreads, bytes, stream>>>(
      static_cast<const float*>(q), static_cast<const PT*>(k_pages),
      static_cast<const PT*>(v_pages), static_cast<const float*>(k_scales),
      static_cast<const float*>(v_scales),
      static_cast<const int32_t*>(block_tables),
      static_cast<const int32_t*>(pos), static_cast<float*>(scores),
      static_cast<float*>(out), T, H, Hkv, D, bs, NB, window, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace fp32q

extern "C" {

// Keys per staged tile of the bf16-q kernel at head dim D (its split keys
// are a multiple).
int paged_verify_key_tile(int D) { return key_tile(D); }

// Bytes of dynamic shared memory one CTA of the bf16-q kernel's passes 1-2
// needs (page_dtype: 0 bf16, 1 int8); the wrapper checks it against the
// card's 227 KB before launching.
int paged_verify_smem_bytes(int page_dtype, int D, int rows, int split_keys,
                            int splits, int bs) {
  return smem_layout(page_dtype == 1, D, rows, split_keys, splits, bs).bytes;
}

// Which hand-written instantiation runs for q's dtype (0 fp32, 1 bf16).
const char* paged_verify_variant(int q_dtype) {
  return q_dtype == 1
             ? "bf16 mma.sync split-KV (scores, values, combine; p rounded "
               "to the page type, int8 p * vscale = hi + lo)"
             : "fp32 CUDA-core FMAs, two walks (16 query rows a CTA)";
}

// bf16 queries.  q [B, T, H, D] bf16 (the output too); page_dtype: 0 bf16,
// 1 int8 (k_scales/v_scales then point at fp32 [P, bs, Hkv]).  All
// tensors contiguous; block_tables [B, NB] and pos [B] int32.  The plan
// (kernels/paged_verify.py:plan): rows query rows per tile (16, 32 or 64),
// split_keys a multiple of paged_verify_key_tile(D), splits =
// ceil(NB * bs / split_keys) <= 32.  m and l: fp32 scratch of B * Hkv *
// ceil(T * H / Hkv / rows) * splits * rows floats each; partial: of that
// times D (unused with one split).  Returns cudaGetLastError() after the
// launches, or -1 for a bad code or plan.
int paged_verify_launch(int page_dtype, const void* q, const void* k_pages,
                        const void* v_pages, const void* k_scales,
                        const void* v_scales, const void* block_tables,
                        const void* pos, void* m, void* l, void* partial,
                        void* out, int B, int T, int H, int Hkv, int D,
                        int bs, int NB, int window, int rows, int split_keys,
                        int splits, float scale, void* stream) {
  const int G = H / Hkv, S = NB * bs;
  const int tiles = (T * G + rows - 1) / (rows > 0 ? rows : 1);
  if ((rows != 16 && rows != 32 && rows != 64) || S <= 0 ||
      split_keys <= 0 || split_keys % key_tile(D) ||
      splits != (S + split_keys - 1) / split_keys || splits > kMaxSplits ||
      (splits > 1 && partial == nullptr))
    return -1;
  const Args a{q,    k_pages, v_pages, static_cast<const float*>(k_scales),
               static_cast<const float*>(v_scales),
               static_cast<const int32_t*>(block_tables),
               static_cast<const int32_t*>(pos), static_cast<float*>(m),
               static_cast<float*>(l), static_cast<float*>(partial), out, T,
               H,    Hkv,     D,       bs, NB, window, rows, tiles,
               split_keys, splits, scale};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (page_dtype) {
    case 0:
      return launch_dim<bf16>(a, B, s);
    case 1:
      return launch_dim<int8_t>(a, B, s);
    default:
      return -1;
  }
}

// fp32 queries: bytes of dynamic shared memory one CTA needs, with
// score_words floats of scores kept there (fp32_tile_rows()*NB*bs, or 0
// when they go to global memory).
int paged_verify_fp32_smem_bytes(int D, int bs, int score_words) {
  return static_cast<int>(sizeof(float)) *
         fp32q::smem_floats(D, bs, score_words);
}

// fp32 queries: query rows (token x query head) one CTA takes.
int paged_verify_fp32_tile_rows() { return fp32q::kRows; }

// fp32 queries: q and out [B, T, H, D] fp32, pages and tables as above.
// scores: null keeps the scores in shared memory; else fp32 scratch of
// B*Hkv*ceil(T*G/fp32_tile_rows())*fp32_tile_rows()*NB*bs floats.
// Returns cudaGetLastError() after the launch, or -1 for a bad code.
int paged_verify_fp32_launch(int page_dtype, const void* q,
                             const void* k_pages, const void* v_pages,
                             const void* k_scales, const void* v_scales,
                             const void* block_tables, const void* pos,
                             void* scores, void* out, int B, int T, int H,
                             int Hkv, int D, int bs, int NB, int window,
                             float scale, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (page_dtype) {
    case 0:
      return fp32q::launch<bf16>(q, k_pages, v_pages, nullptr, nullptr,
                                 block_tables, pos, scores, out, B, T, H,
                                 Hkv, D, bs, NB, window, scale, s);
    case 1:
      return fp32q::launch<int8_t>(q, k_pages, v_pages, k_scales, v_scales,
                                   block_tables, pos, scores, out, B, T, H,
                                   Hkv, D, bs, NB, window, scale, s);
    default:
      return -1;
  }
}

}  // extern "C"
