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
// the draft model's bucketed prefill on the speculative path.
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
// bound; the encoder's fp32 S 256, D 448 does ~240 flops per byte against
// the 67 TFLOP/s fp32 rate (20 flops per byte at 3.35 TB/s).
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
//     bf16 path serves): the CUDA-core kernel, fp32 FMAs from shared
//     memory (never TF32), 16 query rows a CTA, [32, D] K and V tiles
//     staged in shared memory and padded to D + 1 floats, the scores and
//     the running (m, l, acc) in shared memory.
// Both walk only the key tiles a query tile can see: from the first tile
// inside the window of its earliest row to the tile of its latest row when
// causal (the Pallas kernel's pl.when(live_block) skip), so a causal
// prefill does about half the tiles; the tensor-core kernel starts the
// heaviest causal tiles first (the last query tiles, with every head of
// the batch before the next tile).  The ragged edges of Sq and Sk are
// masked per element (and zero-filled by cp.async's source size): no
// host-side padding or transposed copy; q, k and v are read in place.
// Later work: wgmma with TMA, and one CTA per kv head for all G query
// heads.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "tc_bf16.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kRows = 16;  // query rows per CTA
constexpr int kCols = 32;  // keys per staged tile (one per lane in softmax)
constexpr int kRowGroup = 4;  // rows one thread carries in the p.v loop
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

// One 16-byte load of kVec values, widened to fp32.
template <typename T>
struct Load16 {
  static constexpr int kVec = 16 / sizeof(T);
  __device__ static void run(const T* src, float* dst) {
    const uint4 raw = *reinterpret_cast<const uint4*>(src);
    const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
    for (int i = 0; i < kVec; ++i) dst[i] = to_float(e[i]);
  }
};

// Shared memory, in floats: q [kRows][D+1], acc [kRows][D], K tile
// [kCols][D+1], V tile [kCols][D], probabilities [kRows][kCols], then m,
// l and the rescale factor [kRows] each.
__host__ __device__ inline int smem_floats(int D) {
  return kRows * (D + 1) + kRows * D + kCols * (D + 1) + kCols * D +
         kRows * kCols + 3 * kRows;
}

template <typename T>
__global__ void __launch_bounds__(kThreads) flash_attention_kernel(
    const T* __restrict__ q, const T* __restrict__ k,
    const T* __restrict__ v, T* __restrict__ out, int Sq, int Sk, int H,
    int Hkv, int D, int causal, int window, int q_offset, float scale) {
  extern __shared__ float smem[];
  const int i0 = blockIdx.x * kRows;  // first query row of this tile
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / (H / Hkv);
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int rows = min(kRows, Sq - i0);
  const int Dp = D + 1;
  float* q_s = smem;
  float* acc = q_s + kRows * Dp;
  float* k_s = acc + kRows * D;
  float* v_s = k_s + kCols * Dp;
  float* p_s = v_s + kCols * D;
  float* m_s = p_s + kRows * kCols;
  float* l_s = m_s + kRows;
  float* c_s = l_s + kRows;

  constexpr int kVec = Load16<T>::kVec;
  const int vecs = D / kVec;  // 16-byte vectors per row
  for (int i = tid; i < kRows * vecs; i += kThreads) {
    const int r = i / vecs, c = (i % vecs) * kVec;
    float* dst = q_s + r * Dp + c;
    if (r < rows) {
      Load16<T>::run(
          q + ((static_cast<size_t>(b) * Sq + i0 + r) * H + h) * D + c, dst);
    } else {
#pragma unroll
      for (int e = 0; e < kVec; ++e) dst[e] = 0.f;
    }
  }
  for (int i = tid; i < kRows * D; i += kThreads) acc[i] = 0.f;
  for (int r = tid; r < kRows; r += kThreads) {
    m_s[r] = kNegInf;
    l_s[r] = 0.f;
  }
  __syncthreads();

  // the key range this tile's rows can see
  const int q_lo = q_offset + i0;
  const int q_hi = q_offset + i0 + rows - 1;
  const int nk = (Sk + kCols - 1) / kCols;
  int j_hi = nk - 1;
  if (causal) j_hi = q_hi < 0 ? -1 : min(j_hi, q_hi / kCols);
  int j_lo = 0;
  if (window > 0) {
    const int first = q_lo - window + 1;  // earliest key of the earliest row
    if (first > 0) j_lo = first / kCols;
  }

  // score work: thread -> row tid / 8, keys (tid % 8) + 8 * u, u < 4
  const int sr = tid >> 3, st = tid & 7;
  for (int j = j_lo; j <= j_hi; ++j) {
    const int k0 = j * kCols;
    for (int i = tid; i < kCols * vecs; i += kThreads) {
      const int t = i / vecs, c = (i % vecs) * kVec;
      float* kd = k_s + t * Dp + c;
      float* vd = v_s + t * D + c;
      if (k0 + t < Sk) {
        const size_t row =
            (static_cast<size_t>(b) * Sk + k0 + t) * Hkv + hk;
        Load16<T>::run(k + row * D + c, kd);
        Load16<T>::run(v + row * D + c, vd);
      } else {  // past Sk: masked below, zeros keep the products finite
#pragma unroll
        for (int e = 0; e < kVec; ++e) {
          kd[e] = 0.f;
          vd[e] = 0.f;
        }
      }
    }
    __syncthreads();

    {
      float dot[kCols / 8] = {};
      const float* qr = q_s + sr * Dp;
      for (int d = 0; d < D; ++d) {
        const float qv = qr[d];
#pragma unroll
        for (int u = 0; u < kCols / 8; ++u)
          dot[u] = fmaf(qv, k_s[(st + 8 * u) * Dp + d], dot[u]);
      }
      const int qpos = q_offset + i0 + sr;
#pragma unroll
      for (int u = 0; u < kCols / 8; ++u) {
        const int t = st + 8 * u;
        const int kpos = k0 + t;
        const bool valid = sr < rows && kpos < Sk &&
                           (!causal || kpos <= qpos) &&
                           (window == 0 || qpos - kpos < window);
        p_s[sr * kCols + t] = valid ? dot[u] * scale : kNegInf;
      }
    }
    __syncthreads();

    // online softmax: warp w takes rows w, w + 4, ...; lane = key.
    // Masked keys get probability 0, so a row that has seen no key yet
    // keeps l = 0 and acc = 0.
    for (int r = warp; r < kRows; r += kThreads / 32) {
      const float s = p_s[r * kCols + lane];
      float mx = s;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_old = m_s[r];
      const float m_new = fmaxf(m_old, mx);
      const float e = s > kMasked ? expf(s - m_new) : 0.f;
      float sum = e;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      p_s[r * kCols + lane] = e;
      if (lane == 0) {
        const float corr = m_old > kMasked ? expf(m_old - m_new) : 1.f;
        l_s[r] = l_s[r] * corr + sum;
        m_s[r] = m_new;
        c_s[r] = corr;
      }
    }
    __syncthreads();

    // acc[r][d] = acc[r][d] * corr[r] + sum_t p[r][t] v[t][d]; each item is
    // kRowGroup rows of one column d, so one V load serves them all
    for (int i = tid; i < (kRows / kRowGroup) * D; i += kThreads) {
      const int r0 = (i / D) * kRowGroup, d = i % D;
      float a[kRowGroup];
#pragma unroll
      for (int g = 0; g < kRowGroup; ++g)
        a[g] = acc[(r0 + g) * D + d] * c_s[r0 + g];
#pragma unroll 8
      for (int t = 0; t < kCols; ++t) {
        const float vv = v_s[t * D + d];
#pragma unroll
        for (int g = 0; g < kRowGroup; ++g)
          a[g] = fmaf(p_s[(r0 + g) * kCols + t], vv, a[g]);
      }
#pragma unroll
      for (int g = 0; g < kRowGroup; ++g) acc[(r0 + g) * D + d] = a[g];
    }
    __syncthreads();  // the tiles are overwritten by the next key tile
  }

  for (int i = tid; i < rows * D; i += kThreads) {
    const int r = i / D, d = i % D;
    out[((static_cast<size_t>(b) * Sq + i0 + r) * H + h) * D + d] =
        from_float<T>(acc[i] / fmaxf(l_s[r], 1e-30f));
  }
}

template <typename T>
int launch(const void* q, const void* k, const void* v, void* out, int B,
           int Sq, int Sk, int H, int Hkv, int D, int causal, int window,
           int q_offset, float scale, cudaStream_t stream) {
  const size_t bytes = sizeof(float) * smem_floats(D);
  auto kernel = flash_attention_kernel<T>;
  if (bytes > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(bytes));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const dim3 grid((Sq + kRows - 1) / kRows, H, B);
  kernel<<<grid, kThreads, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), Sq, Sk, H, Hkv, D,
      causal, window, q_offset, scale);
  return static_cast<int>(cudaGetLastError());
}


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
    const bf16* __restrict__ v, bf16* __restrict__ out, int Sq, int Sk,
    int H, int Hkv, int causal, int window, int q_offset, float scale_log2) {
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
    bf16* dst = out + ((static_cast<size_t>(b) * Sq + i0 + row) * H + h) * D;
#pragma unroll
    for (int df = 0; df < D / 8; ++df)
      *reinterpret_cast<__nv_bfloat162*>(dst + df * 8 + t4 * 2) =
          __floats2bfloat162_rn(o[df][2 * r] / L, o[df][2 * r + 1] / L);
  }
}

template <int D>
int launch_tc(const void* q, const void* k, const void* v, void* out, int B,
              int Sq, int Sk, int H, int Hkv, int causal, int window,
              int q_offset, float scale, cudaStream_t stream) {
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
      static_cast<const bf16*>(v), static_cast<bf16*>(out), Sq, Sk, H, Hkv,
      causal, window, q_offset, scale * 1.4426950408889634f);
  return static_cast<int>(cudaGetLastError());
}

// The bf16 head dims the tensor-core kernel takes (every other D in the
// wrapper's HEAD_DIMS, 448, runs the CUDA-core kernel).
bool tc_head_dim(int D) {
  return D == 16 || D == 32 || D == 64 || D == 80 || D == 128 || D == 256;
}

int launch_bf16(const void* q, const void* k, const void* v, void* out,
                int B, int Sq, int Sk, int H, int Hkv, int D, int causal,
                int window, int q_offset, float scale, cudaStream_t s) {
  switch (D) {
#define FLASH_TC_CASE(d)                                                   \
  case d:                                                                  \
    return launch_tc<d>(q, k, v, out, B, Sq, Sk, H, Hkv, causal, window,   \
                        q_offset, scale, s);
    FLASH_TC_CASE(16)
    FLASH_TC_CASE(32)
    FLASH_TC_CASE(64)
    FLASH_TC_CASE(80)
    FLASH_TC_CASE(128)
    FLASH_TC_CASE(256)
#undef FLASH_TC_CASE
    default:
      return launch<__nv_bfloat16>(q, k, v, out, B, Sq, Sk, H, Hkv, D,
                                   causal, window, q_offset, scale, s);
  }
}

}  // namespace

extern "C" {

// Bytes of dynamic shared memory one CTA needs for dtype (0 fp32, 1 bf16)
// and head dim D; the wrapper checks it against the card's 227 KB before
// launching.
int flash_attention_smem_bytes(int dtype, int D) {
  if (dtype == 1 && tc_head_dim(D)) return tc_smem_bytes(D);
  return static_cast<int>(sizeof(float)) * smem_floats(D);
}

// Query rows one CTA takes for dtype and D.
int flash_attention_tile_rows(int dtype, int D) {
  return dtype == 1 && tc_head_dim(D) ? kTcRows : kRows;
}

// Which hand-written instantiation runs for dtype and D.
const char* flash_attention_variant(int dtype, int D) {
  if (dtype == 1 && tc_head_dim(D))
    return "bf16 mma.sync (FlashAttention-2 tiles of 64 rows, p = hi + lo)";
  return dtype == 1 ? "bf16 CUDA-core fp32 FMAs (16 rows a CTA)"
                    : "fp32 CUDA-core FMAs (16 rows a CTA)";
}

// q [B, Sq, H, D], k/v [B, Sk, Hkv, D], out [B, Sq, H, D], all contiguous,
// 16-byte aligned and of one type, dtype: 0 fp32, 1 bf16.  D a multiple of
// 8; H a multiple of Hkv.  Query row i sits at q_offset + i.  Returns
// cudaGetLastError() after the launch, or -1 for a bad dtype code.
int flash_attention_launch(int dtype, const void* q, const void* k,
                           const void* v, void* out, int B, int Sq, int Sk,
                           int H, int Hkv, int D, int causal, int window,
                           int q_offset, float scale, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return launch<float>(q, k, v, out, B, Sq, Sk, H, Hkv, D, causal,
                           window, q_offset, scale, s);
    case 1:
      return launch_bf16(q, k, v, out, B, Sq, Sk, H, Hkv, D, causal, window,
                         q_offset, scale, s);
    default:
      return -1;
  }
}

}  // extern "C"
