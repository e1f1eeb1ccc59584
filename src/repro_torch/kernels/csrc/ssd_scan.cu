// Mamba2 SSD chunked scan for Hopper (sm_90a): one selective state-space
// layer's scan over a whole prompt,
//   x [b, S, h, p] (bf16 or fp32), dt [b, S, h] fp32 (> 0, softplus'ed),
//   a_neg [h] fp32 (< 0), B, C [b, S, n] (x's type), optional
//   init_state [b, h, p, n] fp32
//   -> y [b, S, h, p] fp32 and final_state [b, h, p, n] fp32,
// in chunks of Q = min(chunk, S) tokens (S a multiple of Q, Q <= 256).
//
// Replaces the Pallas TPU kernel ssd_scan_tpu
// (repro/kernels/mamba2_scan.py:60).  The port calls it from
// models/mamba2.py mamba2_forward, once per Mamba2 layer of every prefill
// (54 calls a zamba2-2.7b prefill).  Its contract is that of the JAX
// package's ssd_chunked (repro/models/mamba2.py:51), which is what
// mamba2_forward consumes, not that of ssd_scan_tpu: y stays fp32 (the
// caller adds the skip term in fp32 before its one cast; ssd_scan_tpu
// rounds y to x's type), the final state is an output (the prefill cache
// that decode continues from; ssd_scan_tpu has none), and an initial
// state may be given (ssd_scan_tpu always starts from zeros).  The
// discretisation is fused: the kernel reads x and dt and forms x * dt and
// dt * a_neg itself, where the TPU wrapper computes both before the call.
//
// What it computes, per batch b, head h and chunk c, with
// a_cum = cumsum(dt * a_neg) over the chunk (fp32) and xd = x * dt:
//   y[t]   = sum_{s <= t} exp(a_cum[t] - a_cum[s]) (C[t] . B[s]) xd[s]
//            + exp(a_cum[t]) (C[t] . s_in[c])
//   s_in[c + 1] = s_in[c] exp(a_cum[Q-1])
//                 + sum_s exp(a_cum[Q-1] - a_cum[s]) xd[s] (x) B[s],
// s_in[0] the initial state (or zeros), the final state s_in[nc].
//
// What bounds it on an H100: bytes, at zamba2-2.7b's prefill (h 80, p 64,
// n 64, Q 256, bf16 x).  At b 1, S 1024 the causal work is about 12.6
// MFLOP per (head, chunk), 4.0 GFLOP a call, 4.1 us at the bf16 peak; the
// bytes are x, y, dt, B, C and the final state, about 33 MB (y in fp32
// is two thirds of it), 10 us at 3.35 TB/s.
//
// bf16 x, B and C (every full-width prefill) run three kernels from one
// C call.  Each chunk is cut into blocks of 64 tokens (the last may be
// shorter); the passes run parallel over the blocks, every product on
// the tensor cores (mma.sync m16n8k16, fp32 accumulators, tc_bf16.cuh).
// The result is ssd_chunked's, computed with 64-token blocks: the same
// sums, split at other points.
//   1. block states, one CTA per (head, block, batch): the block's a_cum
//      (counted from its first token: a one-warp scan), then its own
//      state x^T W [p, n], W[s] = B[s] dt[s] exp(a_cum[e] - a_cum[s]) (e
//      its last token), and its decay exponent a_cum[e], to a scratch the
//      wrapper allocates;
//   2. state passing, one thread per (batch, head, state element),
//      walking the blocks in order: s_in[k + 1] = s_in[k] exp(decay[k])
//      + own[k], writing the state entering each block as bf16 hi + lo
//      and the final state.  Elementwise over 4096 values a head, in a
//      fixed order, so results do not vary from run to run;
//   3. block outputs, one CTA per (head, block, batch): exp(a_cum[t])
//      (C . s_in) (skipped for the first block without an initial state)
//      plus the scores C B^T of the block's rows against its own keys
//      (16 rows a warp, 16 keys a step, the causal half only), times
//      dt[s] exp(a_cum[t] - a_cum[s]) and masked to s <= t in registers,
//      then against x.  C B^T is recomputed by every head.
// Why blocks of 64: the work inside a block grows with its length (a
// 256-token chunk's rows see up to 256 keys; a block's at most 64), so
// the blocks cut the products of pass 3 by about three and balance its
// CTAs; the price is a state per block, 16 KB a head in fp32, written
// and read twice (4096 p n values against 64 tokens' x and y).
// Why bf16 hi + lo: x, B and C are bf16, so C . B^T is exact (bf16
// products are exact in fp32).  Every other product has one fp32 factor:
// the weighted scores P = (C . B) dt exp(..), W and the state s_in.  That
// factor is split into bf16 hi = bf16(v) and lo = bf16(v - hi), within
// 2^-16 of v, and each product is two mma.sync (hi . x + lo . x) against
// the exact bf16 operand.  x is never multiplied by dt before a product
// (dt folds into P and W, where the fp32 rounding is), so no product
// needs the three or four mma.sync that two fp32 operands would.  One
// bf16 rounding of P would be off by up to 2^-8 of it, 60-150 times the
// 1e-4 the comparisons allow (the CPU tests show it).
// What the passes do about latency: an mma.sync waits for the one before
// it on the same accumulator (about 24 cycles) and a warp issues in
// order, so each step issues every hi product before the lo ones and
// keeps partial sums apart; W is split in registers by the warp that
// uses it, once per element; the decay below a key's 16 is two
// exponentials a thread (exp(a_cum[t] - a_cum[ref]) and the keys' own
// factor dt[s] exp(a_cum[ref] - a_cum[s]), ref the 16's last token, both
// <= 1), not one per pair.
// Why fp32 x keeps the walk: its products must stay full fp32 (no TF32,
// no split of x); the fp32 comparisons (1e-4) and the reduced fp32
// zamba2's CPU/CUDA token equality rest on that.  It is the first
// version's kernel, unchanged, in namespace walk: one CTA per (head,
// batch) walks the chunks in order with register-tiled fp32 FMAs over
// shared memory (see its own note below).
// Later work: wgmma and TMA (a 64-row warpgroup tile, the keys in a
// ring), C B^T once per (batch, block) for all heads, fewer scratch
// bytes (the state passing folded into pass 3, or blocks of 128), and
// the lo . lo product, which the bf16 operand makes unnecessary here.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "tc_bf16.cuh"

namespace {

// ------------------------------------------------ fp32: the chunk walk

// The first version's kernel, kept for fp32 x, B and C:
//   * one CTA per (head, batch): 80 CTAs at b 1.  A loop inside the CTA
//     walks the chunks in order, which takes the place of the TPU grid's
//     sequential ("arbitrary") chunk axis;
//   * the fp32 [p, n] state (16 KB at zamba2's width) lives in shared
//     memory for the whole scan: every chunk reads it (C . state) and
//     rewrites it, and no other CTA needs it, so it never goes to device
//     memory until the final state is written;
//   * each chunk stages xd [Q, p] and B [Q, n] in fp32 in shared memory;
//     the Q x Q score block (256 KB in fp32, over the 227 KB a block may
//     have) is never whole: the chunk's query rows are taken kRows at a
//     time against the staged B and xd, and each tile only reaches the
//     keys s <= its last row (the causal half);
//   * the three products (C B^T, scores . xd and C . state; xd^T B for the
//     state) run as register-tiled loops over shared memory, each thread
//     keeping a small block of outputs; rows are padded to an odd number
//     of floats where threads of a warp read down a column.
namespace walk {

constexpr int kThreads = 256;  // a 16 x 16 grid of threads
constexpr int kRows = 32;      // query rows of a chunk per tile
constexpr int kMaxChunk = 256;  // the block-wide scan takes one token a thread
static_assert(kMaxChunk <= kThreads, "one token per thread in the scan");

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// Shared memory, in floats, for chunk Q, head dim P and state N: the state
// [P][N+1], B [Q][N+1], xd [Q][P], the tile's C rows [kRows][N+1] and
// scores [kRows][Q+1], a_cum and dt [Q] each, and one partial sum per warp.
__host__ __device__ inline int smem_floats(int Q, int P, int N) {
  return P * (N + 1) + Q * (N + 1) + Q * P + kRows * (N + 1) +
         kRows * (Q + 1) + 2 * Q + kThreads / 32;
}

// acc[i][j] += sum_{k < K} a(m0 + ty + 16 i, k) * b(k, n0 + tx + 16 j):
// the thread at (ty, tx) of the 16 x 16 grid keeps a TM x TN block of an
// M x N product.  Rows and columns past M and N are clamped to the last
// one, so the loop reads in bounds without a branch; the caller never
// stores them.
template <int TM, int TN, typename FA, typename FB>
__device__ __forceinline__ void mac(float (&acc)[TM][TN], int m0, int n0,
                                    int M, int N, int K, FA a, FB b) {
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
  int rm[TM], cn[TN];
#pragma unroll
  for (int i = 0; i < TM; ++i) rm[i] = min(m0 + ty + 16 * i, M - 1);
#pragma unroll
  for (int j = 0; j < TN; ++j) cn[j] = min(n0 + tx + 16 * j, N - 1);
#pragma unroll 4
  for (int k = 0; k < K; ++k) {
    float av[TM], bv[TN];
#pragma unroll
    for (int i = 0; i < TM; ++i) av[i] = a(rm[i], k);
#pragma unroll
    for (int j = 0; j < TN; ++j) bv[j] = b(k, cn[j]);
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads) ssd_scan_kernel(
    const T* __restrict__ x, const float* __restrict__ dt,
    const float* __restrict__ a_neg, const T* __restrict__ Bm,
    const T* __restrict__ Cm, const float* __restrict__ init,
    float* __restrict__ y, float* __restrict__ final_state, int S, int H,
    int P, int N, int Q) {
  extern __shared__ float smem[];
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int tid = threadIdx.x;
  const int ty = tid >> 4, tx = tid & 15;
  const int lane = tid & 31, warp = tid >> 5;
  const int Np = N + 1, Qp = Q + 1;
  float* state = smem;
  float* bs = state + P * Np;
  float* xd = bs + Q * Np;
  float* ct = xd + Q * P;
  float* sc = ct + kRows * Np;
  float* acum = sc + kRows * Qp;
  float* dts = acum + Q;
  float* wsum = dts + Q;
  const float an = a_neg[h];

  const size_t st0 = (static_cast<size_t>(b) * H + h) * P * N;
  for (int i = tid; i < P * N; i += kThreads)
    state[(i / N) * Np + i % N] = init != nullptr ? init[st0 + i] : 0.f;

  for (int c0 = 0; c0 < S; c0 += Q) {
    const size_t row0 = static_cast<size_t>(b) * S + c0;  // (b, c0) row
    // 1. dt and the chunk's inclusive cumulative sum of dt * a_neg: a scan
    //    within each warp, then the sums of the warps before it
    float a = 0.f;
    if (tid < Q) {
      const float d = dt[(row0 + tid) * H + h];
      dts[tid] = d;
      a = d * an;
    }
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const float o = __shfl_up_sync(0xffffffffu, a, off);
      if (lane >= off) a += o;
    }
    if (lane == 31) wsum[warp] = a;
    __syncthreads();
    for (int w = 0; w < warp; ++w) a += wsum[w];
    if (tid < Q) acum[tid] = a;

    // 2. stage xd = x * dt [Q][P] and B [Q][N] of the whole chunk
    for (int i = tid; i < Q * P; i += kThreads) {
      const int s = i / P, j = i % P;
      xd[i] = to_float(x[((row0 + s) * H + h) * P + j]) * dts[s];
    }
    for (int i = tid; i < Q * N; i += kThreads) {
      const int s = i / N, k = i % N;
      bs[s * Np + k] = to_float(Bm[(row0 + s) * N + k]);
    }
    __syncthreads();

    // 3. y, kRows query rows at a time
    for (int r0 = 0; r0 < Q; r0 += kRows) {
      const int M = min(kRows, Q - r0);
      const int K = r0 + M;  // keys this tile's rows can see
      for (int i = tid; i < M * N; i += kThreads) {
        const int m = i / N, k = i % N;
        ct[m * Np + k] = to_float(Cm[(row0 + r0 + m) * N + k]);
      }
      __syncthreads();
      // scores [M][K]: exp(a_cum[t] - a_cum[s]) (C[t] . B[s]), 0 for s > t
      for (int n0 = 0; n0 < K; n0 += 64) {
        float acc[2][4] = {};
        mac<2, 4>(
            acc, 0, n0, M, K, N,
            [&](int m, int k) { return ct[m * Np + k]; },
            [&](int k, int s) { return bs[s * Np + k]; });
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int m = ty + 16 * i, s = n0 + tx + 16 * j;
            if (m < M && s < K) {
              const int t = r0 + m;
              sc[m * Qp + s] =
                  s <= t ? acc[i][j] * expf(acum[t] - acum[s]) : 0.f;
            }
          }
      }
      __syncthreads();
      // y [M][P] = scores . xd + exp(a_cum[t]) (C[t] . state)
      for (int n0 = 0; n0 < P; n0 += 64) {
        float intra[2][4] = {}, inter[2][4] = {};
        mac<2, 4>(
            intra, 0, n0, M, P, K,
            [&](int m, int s) { return sc[m * Qp + s]; },
            [&](int s, int j) { return xd[s * P + j]; });
        mac<2, 4>(
            inter, 0, n0, M, P, N,
            [&](int m, int k) { return ct[m * Np + k]; },
            [&](int k, int j) { return state[j * Np + k]; });
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int m = ty + 16 * i, jj = n0 + tx + 16 * j;
            if (m < M && jj < P) {
              const int t = r0 + m;
              y[((row0 + t) * H + h) * P + jj] =
                  intra[i][j] + inter[i][j] * expf(acum[t]);
            }
          }
      }
      __syncthreads();  // ct and sc belong to the next tile
    }

    // 4. state = state * exp(a_cum[-1]) + xd^T (B * exp(a_cum[-1] - a_cum))
    const float last = acum[Q - 1];
    for (int i = tid; i < Q * N; i += kThreads) {
      const int s = i / N, k = i % N;
      bs[s * Np + k] *= expf(last - acum[s]);
    }
    __syncthreads();
    const float keep = expf(last);
    for (int m0 = 0; m0 < P; m0 += 64)
      for (int n0 = 0; n0 < N; n0 += 64) {
        float acc[4][4] = {};
        mac<4, 4>(
            acc, m0, n0, P, N, Q,
            [&](int j, int s) { return xd[s * P + j]; },
            [&](int s, int k) { return bs[s * Np + k]; });
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int jj = m0 + ty + 16 * i, k = n0 + tx + 16 * j;
            if (jj < P && k < N)
              state[jj * Np + k] = state[jj * Np + k] * keep + acc[i][j];
          }
      }
    __syncthreads();  // every buffer belongs to the next chunk
  }

  for (int i = tid; i < P * N; i += kThreads)
    final_state[st0 + i] = state[(i / N) * Np + i % N];
}

template <typename T>
int launch(const void* x, const void* dt, const void* a_neg, const void* B,
           const void* C, const void* init, void* y, void* final_state,
           int Bsz, int S, int H, int P, int N, int Q, cudaStream_t stream) {
  const size_t bytes = sizeof(float) * smem_floats(Q, P, N);
  auto kernel = ssd_scan_kernel<T>;
  if (bytes > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(bytes));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const dim3 grid(H, Bsz);
  kernel<<<grid, kThreads, bytes, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(dt),
      static_cast<const float*>(a_neg), static_cast<const T*>(B),
      static_cast<const T*>(C), static_cast<const float*>(init),
      static_cast<float*>(y), static_cast<float*>(final_state), S, H, P, N,
      Q);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace walk

// ------------------------------------- bf16: chunks on the tensor cores

namespace tcs {

using tc::bf16;
constexpr int kThreads = 128;  // passes 1 and 3: four warps
constexpr int kBlock = 64;     // tokens of a block: a chunk in blocks of 64
constexpr int kCols = 64;      // columns of p a block of pass 3's output
constexpr int kPad = 8;        // bf16 elements of padding per shared row
constexpr int kPassThreads = 256;  // pass 2
constexpr int kPassAhead = 4;      // pass 2: blocks loaded ahead
static_assert(kBlock == 16 * (kThreads / 32), "16 rows a warp in pass 3");
static_assert(kBlock == 2 * 32, "the block scan: two tokens a lane");
constexpr int kCachedK = 4;  // 16-deep steps of C's fragments kept (n <= 64)

__host__ __device__ inline int pad16(int v) { return (v + 15) & ~15; }

// Shared memory of pass 1 for head dim P and state N: a block's x [64][Pp
// + 8] and B [64][Np + 8] in bf16, its dt (then W's row factor) and a_cum
// [64] in fp32 (Pp, Np: P, N rounded up to 16).
__host__ __device__ inline int states_smem(int P, int N) {
  return 2 * kBlock * (pad16(P) + kPad) + 2 * kBlock * (pad16(N) + kPad) +
         4 * 2 * kBlock;
}

// Shared memory of pass 3: a block's B and C [64][Np + 8] and x [64][Pp +
// 8], the state entering it as hi and lo [Pp][Np + 8] in bf16; its dt,
// a_cum and the keys' factors [64] in fp32.
__host__ __device__ inline int outputs_smem(int P, int N) {
  const int Pp = pad16(P), LW = pad16(N) + kPad;
  return 2 * (2 * kBlock * LW + kBlock * (Pp + kPad) + 2 * Pp * LW) +
         4 * 3 * kBlock;
}

// rows x cols bf16 (row r at src + r * stride) into shared [rows_pad]
// rows of ld elements, zero past rows and cols up to cols_pad (a multiple
// of 16).  vec: cols and stride are multiples of 8 and src is 16-byte
// aligned, so whole rows go by 16-byte cp.async (zero-filled past the
// edge); otherwise value by value.  The caller commits, waits and syncs.
__device__ __forceinline__ void stage(bf16* dst, int ld, const bf16* src,
                                      size_t stride, int rows, int cols,
                                      int rows_pad, int cols_pad, bool vec) {
  if (vec) {
    const int runs = cols_pad / 8;
    for (int i = threadIdx.x; i < rows_pad * runs; i += blockDim.x) {
      const int r = i / runs, c = (i % runs) * 8;
      const bool in = r < rows && c < cols;
      tc::cp_async16(dst + r * ld + c, in ? src + r * stride + c : src,
                     in ? 16 : 0);
    }
  } else {
    for (int i = threadIdx.x; i < rows_pad * cols_pad; i += blockDim.x) {
      const int r = i / cols_pad, c = i % cols_pad;
      dst[r * ld + c] = r < rows && c < cols ? src[r * stride + c]
                                             : __float2bfloat16(0.f);
    }
  }
}

// The dt of this thread's two tokens of the block (row0 its first),
// 2 lane and 2 lane + 1 (0 past its M tokens; warp 0 only), loaded before
// the CTA stages its tiles so that their latency hides behind the copies.
struct DtPair {
  float d0, d1;
};
__device__ __forceinline__ DtPair load_dt(const float* __restrict__ dt,
                                          size_t row0, int H, int h, int M) {
  const int s0 = 2 * threadIdx.x;
  DtPair d{0.f, 0.f};
  if (threadIdx.x < 32) {
    if (s0 < M) d.d0 = dt[(row0 + s0) * H + h];
    if (s0 + 1 < M) d.d1 = dt[(row0 + s0 + 1) * H + h];
  }
  return d;
}

// The block's dt (dts[s]) and a_cum[s] = sum_{u <= s} dt[u] a_neg,
// counted from the block's first token, for s < 64 (tokens past M count
// dt 0): lane i of warp 0 takes tokens 2i and 2i + 1, then an inclusive
// scan of the lanes' sums.  Passes 1 and 3 run this same code, so they
// see the same a_cum.  The products are kept apart from the sums
// (__fmul_rn), as the CPU emulation of the tests computes them.  The
// caller syncs before reading dts and acum.
__device__ __forceinline__ void block_cumsum(DtPair d, float an, float* dts,
                                             float* acum) {
  if (threadIdx.x >= 32) return;
  const int lane = threadIdx.x, s0 = 2 * lane;
  dts[s0] = d.d0;
  dts[s0 + 1] = d.d1;
  const float v0 = __fmul_rn(d.d0, an);
  const float v1 = __fadd_rn(v0, __fmul_rn(d.d1, an));
  float a = v1;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const float o = __shfl_up_sync(0xffffffffu, a, off);
    if (lane >= off) a = __fadd_rn(a, o);
  }
  float pre = __shfl_up_sync(0xffffffffu, a, 1);
  if (lane == 0) pre = 0.f;
  acum[s0] = __fadd_rn(pre, v0);
  acum[s0 + 1] = __fadd_rn(pre, v1);
}

// The two bf16 of raw (low half first) times fa and fb, as bf16 hi + lo
// of one register each.
__device__ __forceinline__ void scaled_split(unsigned raw, float fa, float fb,
                                             unsigned& hi, unsigned& lo) {
  const float2 v =
      __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw));
  tc::split_bf16(v.x * fa, v.y * fb, hi, lo);
}

// Pass 1: the own state of block j of chunk c (tokens 64j .. e, e =
// min(64j + 63, Q - 1); a_cum counted from 64j), local[b, c T + j, h] =
// x^T W [P, N] with W[s, :] = B[s, :] f[s], f[s] = dt[s] exp(a_cum[e] -
// a_cum[s]), and the block's decay exponent, decay[b, c T + j, h] =
// a_cum[e].  The block's x and B arrive by cp.async while warp 0 scans
// its dt.  Warp w takes columns 16w .. 16w + 15 of each 64 of n and every
// row of p, so each element of W is made once, in registers: each
// 16-token step loads the warp's B fragment, scales it by f into bf16 hi
// + lo, then issues the hi products of every 16-row tile of p before the
// lo ones (an mma.sync waits for the one before it on the same
// accumulator, and a warp issues in order).
__global__ void __launch_bounds__(kThreads) ssd_block_states(
    const bf16* __restrict__ x, const float* __restrict__ dt,
    const float* __restrict__ a_neg, const bf16* __restrict__ Bm,
    float* __restrict__ local, float* __restrict__ decay, int S, int H,
    int P, int N, int Q) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int Pp = pad16(P), Np = pad16(N);
  const int LX = Pp + kPad, LW = Np + kPad;
  bf16* xs = reinterpret_cast<bf16*>(smem_raw);
  bf16* bs = xs + kBlock * LX;
  float* fs = reinterpret_cast<float*>(bs + kBlock * LW);  // dt, then f
  float* acum = fs + kBlock;
  const int h = blockIdx.x, blk = blockIdx.y, b = blockIdx.z;
  const int nb = gridDim.y;
  const int T = (Q + kBlock - 1) / kBlock;
  const int c = blk / T, r0 = (blk % T) * kBlock;
  const int M = min(kBlock, Q - r0), Mp = pad16(M);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t4 = lane & 3;
  // the block's first token
  const size_t row0 = static_cast<size_t>(b) * S + static_cast<size_t>(c) * Q +
                      r0;

  const DtPair d = load_dt(dt, row0, H, h, M);
  stage(xs, LX, x + (row0 * H + h) * P, static_cast<size_t>(H) * P, M, P, Mp,
        Pp, P % 8 == 0);
  stage(bs, LW, Bm + row0 * N, N, M, N, Mp, Np, N % 8 == 0);
  tc::cp_async_commit();
  block_cumsum(d, a_neg[h], fs, acum);
  __syncthreads();
  const float last = acum[M - 1];
  for (int s = tid; s < Mp; s += kThreads)  // f, 0 past M
    fs[s] = s < M ? fs[s] * expf(last - acum[s]) : 0.f;
  tc::cp_async_wait<0>();
  __syncthreads();

  float* dst = local + ((static_cast<size_t>(b) * nb + blk) * H + h) *
                           static_cast<size_t>(P) * N;
  for (int n0 = 16 * warp; n0 < Np; n0 += 4 * 16) {  // this warp's columns
    for (int p0 = 0; p0 < Pp; p0 += 4 * 16) {
      const int mq = min(4 * 16, Pp - p0) / 16;  // 16-row tiles of p
      float acc[4][2][4] = {};
      for (int k0 = 0; k0 < Mp; k0 += 16) {
        // W's B fragment, columns n0 .. n0 + 15: tokens k0 + 2 t4 (+1) in
        // registers 0 and 2, k0 + 8 + 2 t4 (+1) in 1 and 3
        unsigned raw[4], wh[4], wl[4];
        tc::ldsm_x4_trans(raw, bs + (k0 + (lane & 7) + ((lane >> 3) & 1) * 8) *
                                        LW + n0 + (lane >> 4) * 8);
        const float* f0 = fs + k0 + 2 * t4;
        const float2 fa = *reinterpret_cast<const float2*>(f0);
        const float2 fb = *reinterpret_cast<const float2*>(f0 + 8);
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const float2 f = r & 1 ? fb : fa;
          scaled_split(raw[r], f.x, f.y, wh[r], wl[r]);
        }
        // A = x^T [16 rows of p, 16 tokens]: x is stored token-major
        unsigned a[4][4];
#pragma unroll
        for (int m = 0; m < 4; ++m) {
          if (m >= mq) break;
          tc::ldsm_x4_trans(a[m], xs + (k0 + (lane & 7) + (lane >> 4) * 8) *
                                           LX + p0 + m * 16 +
                                       ((lane >> 3) & 1) * 8);
        }
#pragma unroll
        for (int m = 0; m < 4; ++m) {
          if (m >= mq) break;
          tc::mma_bf16(acc[m][0], a[m], wh[0], wh[1]);
          tc::mma_bf16(acc[m][1], a[m], wh[2], wh[3]);
        }
#pragma unroll
        for (int m = 0; m < 4; ++m) {
          if (m >= mq) break;
          tc::mma_bf16(acc[m][0], a[m], wl[0], wl[1]);
          tc::mma_bf16(acc[m][1], a[m], wl[2], wl[3]);
        }
      }
#pragma unroll
      for (int m = 0; m < 4; ++m)
#pragma unroll
        for (int nt = 0; nt < 2; ++nt)
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            const int row = p0 + m * 16 + g + 8 * r;
            const int col = n0 + nt * 8 + 2 * t4;
            if (row >= P) continue;
            if (col < N) dst[row * N + col] = acc[m][nt][2 * r];
            if (col + 1 < N) dst[row * N + col + 1] = acc[m][nt][2 * r + 1];
          }
    }
  }
  if (tid == 0) decay[(static_cast<size_t>(b) * nb + blk) * H + h] = last;
}

// Pass 2: for each (batch, head) and state element, in block order over
// the whole sequence, the state entering block k, s_in[k], goes to
// s_split[k] as bf16 hi and lo ([2][P][N] per (batch, block, head)), and
// s_in[k + 1] = s_in[k] exp(decay[k]) + local[k]; s_in[nb] is the final
// state.  The product is kept apart from the sum (__fmul_rn), as the CPU
// emulation computes it.  The loads of kPassAhead blocks go out before
// their arithmetic.
__global__ void __launch_bounds__(kPassThreads) ssd_state_passing(
    const float* __restrict__ local, const float* __restrict__ decay,
    const float* __restrict__ init, bf16* __restrict__ s_split,
    float* __restrict__ final_state, int nb, int H, int PN) {
  const int i = blockIdx.x * kPassThreads + threadIdx.x;
  if (i >= PN) return;
  const int h = blockIdx.y, b = blockIdx.z;
  const size_t bh = static_cast<size_t>(b) * H + h;
  float s = init != nullptr ? init[bh * PN + i] : 0.f;
  for (int k0 = 0; k0 < nb; k0 += kPassAhead) {
    float l[kPassAhead], e[kPassAhead];
#pragma unroll
    for (int k = 0; k < kPassAhead; ++k) {
      const size_t at = (static_cast<size_t>(b) * nb + k0 + k) * H + h;
      l[k] = k0 + k < nb ? local[at * PN + i] : 0.f;
      e[k] = k0 + k < nb ? decay[at] : 0.f;
    }
#pragma unroll
    for (int k = 0; k < kPassAhead; ++k) {
      if (k0 + k >= nb) break;
      const size_t at = (static_cast<size_t>(b) * nb + k0 + k) * H + h;
      bf16* out = s_split + at * 2 * PN + i;
      const bf16 hi = __float2bfloat16_rn(s);
      out[0] = hi;
      out[PN] = __float2bfloat16_rn(s - __bfloat162float(hi));
      s = __fadd_rn(__fmul_rn(s, expf(e[k])), l[k]);
    }
  }
  final_state[bh * PN + i] = s;
}

// Pass 3: y of block j of chunk c (rows 64j .. e; a_cum counted from
// 64j), one CTA per (head, block, batch).  Warp w takes rows 16w .. 16w +
// 15 of the block and the block's keys up to its last row, 16 at a time,
// for each 64-column block of p:
//   o  = exp(a_cum[t]) (C . s_in^T)            (s_in as hi + lo)
//   o += P . x,  P[t, s] = (C[t] . B[s]) dt[s] exp(a_cum[t] - a_cum[s])
//                for s <= t, else 0             (P as hi + lo)
// with s_in the state entering the block (pass 2), skipped for the first
// block without an initial state.  The scores of a 16-key step are the A
// fragment of the P . x product, so P never leaves registers; C's
// fragments stay in registers for n up to 64.  Per step, the products of
// each 16-deep slice of n and each 8-column tile of p go to separate
// accumulators, hi before lo, so no mma.sync waits on the one before it.
__global__ void __launch_bounds__(kThreads) ssd_block_outputs(
    const bf16* __restrict__ x, const float* __restrict__ dt,
    const float* __restrict__ a_neg, const bf16* __restrict__ Bm,
    const bf16* __restrict__ Cm, const bf16* __restrict__ s_split,
    int has_init, float* __restrict__ y, int S, int H, int P, int N, int Q) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int Pp = pad16(P), Np = pad16(N);
  const int LX = Pp + kPad, LW = Np + kPad;
  bf16* bs = reinterpret_cast<bf16*>(smem_raw);
  bf16* cs = bs + kBlock * LW;
  bf16* xs = cs + kBlock * LW;
  bf16* sh = xs + kBlock * LX;
  bf16* sl = sh + Pp * LW;
  float* dts = reinterpret_cast<float*>(sl + Pp * LW);
  float* acum = dts + kBlock;
  float* keyf = acum + kBlock;
  const int h = blockIdx.x, blk = blockIdx.y, b = blockIdx.z;
  const int nb = gridDim.y;
  const int T = (Q + kBlock - 1) / kBlock;
  const int c = blk / T, r0 = (blk % T) * kBlock;
  const int M = min(kBlock, Q - r0), Mp = pad16(M);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t4 = lane & 3;
  // the block's first token
  const size_t row0 = static_cast<size_t>(b) * S + static_cast<size_t>(c) * Q +
                      r0;
  const bool vecN = N % 8 == 0;

  const DtPair d = load_dt(dt, row0, H, h, M);
  stage(bs, LW, Bm + row0 * N, N, M, N, Mp, Np, vecN);
  stage(cs, LW, Cm + row0 * N, N, M, N, kBlock, Np, vecN);
  stage(xs, LX, x + (row0 * H + h) * P, static_cast<size_t>(H) * P, M, P, Mp,
        Pp, P % 8 == 0);
  const bool carried = has_init || blk > 0;
  if (carried) {
    const bf16* src = s_split + ((static_cast<size_t>(b) * nb + blk) * H + h) *
                                    2 * static_cast<size_t>(P) * N;
    stage(sh, LW, src, N, P, N, Pp, Np, vecN);
    stage(sl, LW, src + static_cast<size_t>(P) * N, N, P, N, Pp, Np, vecN);
  }
  tc::cp_async_commit();
  block_cumsum(d, a_neg[h], dts, acum);
  __syncthreads();
  // each key's factor against the last key of its 16: dt[s] exp(a_cum[s |
  // 15] - a_cum[s]) <= dt[s] (a_cum falls), 0 past M
  for (int s = tid; s < Mp; s += kThreads)
    keyf[s] = dts[s] * expf(acum[s | 15] - acum[s]);
  tc::cp_async_wait<0>();
  __syncthreads();

  const int wr = 16 * warp;  // the warp's first row (and key) in the block
  if (wr >= M) return;
  const int ta = wr + g, tb = ta + 8;  // this thread's two rows
  const float ca = acum[ta], cb = acum[tb];
  const int nk = Np / 16;
  unsigned cf[kCachedK][4];  // C's A fragments of the first 64 of n
#pragma unroll
  for (int kk = 0; kk < kCachedK; ++kk)
    if (kk < nk)
      tc::ldsm_x4(cf[kk], cs + (wr + (lane & 15)) * LW + kk * 16 +
                              (lane >> 4) * 8);
  for (int p0 = 0; p0 < Pp; p0 += kCols) {
    const int pq = min(kCols, Pp - p0) / 16;  // pairs of 8-column tiles
    float o[kCols / 8][4] = {};
    if (carried) {
      // o += C[:, 16kk..] . s_in^T, s_in rows p0 .. p0 + 63: the hi
      // products, then the lo ones
      auto state_step = [&](const unsigned(&a)[4], int kk) {
#pragma unroll
        for (int part = 0; part < 2; ++part) {
          const bf16* src = part == 0 ? sh : sl;
          unsigned bf[kCols / 16][4];
#pragma unroll
          for (int q = 0; q < kCols / 16; ++q) {
            if (q >= pq) break;
            tc::ldsm_x4(bf[q], src + (p0 + q * 16 + (lane & 7) +
                                      (lane >> 4) * 8) * LW +
                                   kk * 16 + ((lane >> 3) & 1) * 8);
          }
#pragma unroll
          for (int q = 0; q < kCols / 16; ++q) {
            if (q >= pq) break;
            tc::mma_bf16(o[2 * q], a, bf[q][0], bf[q][1]);
            tc::mma_bf16(o[2 * q + 1], a, bf[q][2], bf[q][3]);
          }
        }
      };
#pragma unroll
      for (int kk = 0; kk < kCachedK; ++kk) {
        if (kk >= nk) break;
        state_step(cf[kk], kk);
      }
      for (int kk = kCachedK; kk < nk; ++kk) {
        unsigned a[4];
        tc::ldsm_x4(a, cs + (wr + (lane & 15)) * LW + kk * 16 +
                           (lane >> 4) * 8);
        state_step(a, kk);
      }
      const float ea = expf(ca), eb = expf(cb);
#pragma unroll
      for (int nt = 0; nt < kCols / 8; ++nt) {
        o[nt][0] *= ea;
        o[nt][1] *= ea;
        o[nt][2] *= eb;
        o[nt][3] *= eb;
      }
    }
      for (int s0 = 0; s0 <= wr; s0 += 16) {
      // scores [16 rows, 16 keys] = C . B^T: the 16-deep steps of n in two
      // partial sums (even and odd), so no product waits on the one before
      const int kr = s0;
      unsigned kb[kCachedK][4];
#pragma unroll
      for (int kk = 0; kk < kCachedK; ++kk) {
        if (kk >= nk) break;
        tc::ldsm_x4(kb[kk], bs + (kr + (lane & 7) + (lane >> 4) * 8) * LW +
                                kk * 16 + ((lane >> 3) & 1) * 8);
      }
      float part[2][2][4] = {};
#pragma unroll
      for (int kk = 0; kk < kCachedK; ++kk) {
        if (kk >= nk) break;
        tc::mma_bf16(part[kk & 1][0], cf[kk], kb[kk][0], kb[kk][1]);
        tc::mma_bf16(part[kk & 1][1], cf[kk], kb[kk][2], kb[kk][3]);
      }
      for (int kk = kCachedK; kk < nk; ++kk) {
        unsigned a[4], kx[4];
        tc::ldsm_x4(a, cs + (wr + (lane & 15)) * LW + kk * 16 +
                           (lane >> 4) * 8);
        tc::ldsm_x4(kx, bs + (kr + (lane & 7) + (lane >> 4) * 8) * LW +
                            kk * 16 + ((lane >> 3) & 1) * 8);
        float(&acc)[2][4] = part[0];  // n past 64: one partial sum
        tc::mma_bf16(acc[0], a, kx[0], kx[1]);
        tc::mma_bf16(acc[1], a, kx[2], kx[3]);
      }
      // x's fragments of these keys, in flight while the weights are made
      unsigned vb[kCols / 16][4];
#pragma unroll
      for (int q = 0; q < kCols / 16; ++q) {
        if (q >= pq) break;
        tc::ldsm_x4_trans(
            vb[q], xs + (kr + (lane & 7) + ((lane >> 3) & 1) * 8) * LX + p0 +
                       q * 16 + (lane >> 4) * 8);
      }
      // P = scores dt[s] exp(a_cum[t] - a_cum[s]).  Below the diagonal
      // (keys s0 .. s0 + 15 all before the warp's rows) the exponential
      // is exp(a_cum[t] - a_cum[s0 + 15]) exp(a_cum[s0 + 15] - a_cum[s]),
      // two factors <= 1: two exponentials a thread and the keys' factors.
      // On the diagonal, each pair's own exponential, s > t masked.
      float sc[2][4];
      if (s0 < wr) {
        const float ref = acum[s0 + 15];
        const float ra = expf(ca - ref), rb = expf(cb - ref);
#pragma unroll
        for (int nf = 0; nf < 2; ++nf) {
          const float2 kf = *reinterpret_cast<const float2*>(
              keyf + s0 + nf * 8 + 2 * t4);
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const float v = part[0][nf][i] + part[1][nf][i];
            sc[nf][i] = v * ((i < 2 ? ra : rb) * (i & 1 ? kf.y : kf.x));
          }
        }
      } else {
#pragma unroll
        for (int nf = 0; nf < 2; ++nf)
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const int s = s0 + nf * 8 + 2 * t4 + (i & 1);
            const int t = i < 2 ? ta : tb;
            const float ct = i < 2 ? ca : cb;
            const float v = part[0][nf][i] + part[1][nf][i];
            sc[nf][i] = s <= t ? v * (expf(ct - acum[s]) * dts[s]) : 0.f;
          }
      }
      unsigned ph[4], pl[4];
      tc::split_bf16(sc[0][0], sc[0][1], ph[0], pl[0]);
      tc::split_bf16(sc[0][2], sc[0][3], ph[1], pl[1]);
      tc::split_bf16(sc[1][0], sc[1][1], ph[2], pl[2]);
      tc::split_bf16(sc[1][2], sc[1][3], ph[3], pl[3]);
#pragma unroll
      for (int q = 0; q < kCols / 16; ++q) {
        if (q >= pq) break;
        tc::mma_bf16(o[2 * q], ph, vb[q][0], vb[q][1]);
        tc::mma_bf16(o[2 * q + 1], ph, vb[q][2], vb[q][3]);
      }
#pragma unroll
      for (int q = 0; q < kCols / 16; ++q) {
        if (q >= pq) break;
        tc::mma_bf16(o[2 * q], pl, vb[q][0], vb[q][1]);
        tc::mma_bf16(o[2 * q + 1], pl, vb[q][2], vb[q][3]);
      }
    }
      const bool pairs = P % 2 == 0;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int t = r == 0 ? ta : tb;
      if (t >= M) continue;
      float* dst = y + ((row0 + t) * H + h) * P;
#pragma unroll
      for (int nt = 0; nt < kCols / 8; ++nt) {
        const int col = p0 + nt * 8 + 2 * t4;
        if (pairs && col < P) {
          *reinterpret_cast<float2*>(dst + col) =
              make_float2(o[nt][2 * r], o[nt][2 * r + 1]);
        } else {
          if (col < P) dst[col] = o[nt][2 * r];
          if (col + 1 < P) dst[col + 1] = o[nt][2 * r + 1];
        }
      }
    }
  }
}

// One C call, three launches on the caller's stream.
int launch(const void* x, const void* dt, const void* a_neg, const void* B,
           const void* C, const void* init, void* y, void* final_state,
           void* scratch, int Bsz, int S, int H, int P, int N, int Q,
           cudaStream_t stream) {
  const int nb = S / Q * ((Q + kBlock - 1) / kBlock);
  const int bytes1 = states_smem(P, N), bytes3 = outputs_smem(P, N);
  cudaError_t err = cudaFuncSetAttribute(
      ssd_block_states, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes1);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaFuncSetAttribute(ssd_block_outputs,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             bytes3);
  if (err != cudaSuccess) return static_cast<int>(err);
  // scratch: the state entering each block as bf16 hi, lo [Bsz, nb, H, 2,
  // P, N], then each block's own state [Bsz, nb, H, P, N] and its decay
  // exponent [Bsz, nb, H] in fp32
  const size_t units = static_cast<size_t>(Bsz) * nb * H;
  const size_t PN = static_cast<size_t>(P) * N;
  bf16* split = static_cast<bf16*>(scratch);
  float* local = reinterpret_cast<float*>(split + units * 2 * PN);
  float* decay = local + units * PN;
  const bf16* xb = static_cast<const bf16*>(x);
  const float* dtf = static_cast<const float*>(dt);
  const float* an = static_cast<const float*>(a_neg);
  const dim3 grid(H, nb, Bsz);
  ssd_block_states<<<grid, kThreads, bytes1, stream>>>(
      xb, dtf, an, static_cast<const bf16*>(B), local, decay, S, H, P, N, Q);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  ssd_state_passing<<<dim3((P * N + kPassThreads - 1) / kPassThreads, H,
                           Bsz),
                      kPassThreads, 0, stream>>>(
      local, decay, static_cast<const float*>(init), split,
      static_cast<float*>(final_state), nb, H, P * N);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  ssd_block_outputs<<<grid, kThreads, bytes3, stream>>>(
      xb, dtf, an, static_cast<const bf16*>(B), static_cast<const bf16*>(C),
      split, init != nullptr, static_cast<float*>(y), S, H, P, N, Q);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace tcs

}  // namespace

extern "C" {

// Bytes of dynamic shared memory one CTA of a pass needs for chunk Q,
// head dim P and state N: pass 0 the fp32 walk, 1 the block states, 2
// the state passing (none), 3 the block outputs; -1 for another pass.
// The wrapper checks them against the card's 227 KB.
int ssd_scan_smem_bytes(int pass, int Q, int P, int N) {
  switch (pass) {
    case 0:
      return static_cast<int>(sizeof(float)) * walk::smem_floats(Q, P, N);
    case 1:
      return tcs::states_smem(P, N);
    case 2:
      return 0;
    case 3:
      return tcs::outputs_smem(P, N);
    default:
      return -1;
  }
}

// The longest chunk the wrapper takes: the walk's block scan takes one
// token a thread (the bf16 passes cut any chunk into blocks of 64).
int ssd_scan_max_chunk() { return walk::kMaxChunk; }

// Tokens of a block: the bf16 kernel cuts each chunk into blocks of this
// many (the last may be shorter).
int ssd_scan_block() { return tcs::kBlock; }

// Bytes of the bf16 kernel's scratch: per (batch, block, head), the state
// entering the block as bf16 hi and lo, the block's own state and its
// decay exponent in fp32.
long long ssd_scan_scratch_bytes(int Bsz, int S, int H, int P, int N,
                                 int Q) {
  return static_cast<long long>(Bsz) * (S / Q) *
         ((Q + tcs::kBlock - 1) / tcs::kBlock) * H * (8LL * P * N + 4);
}

// Which kernel runs for dtype (0 fp32, 1 bf16).
const char* ssd_scan_variant(int dtype) {
  return dtype == 1
             ? "tensor-core chunked (mma.sync; chunks in blocks of 64 tokens: "
               "block states, state passing, block outputs; fp32 factors as "
               "bf16 hi + lo)"
             : "fp32 walk (one CTA a head walks the chunks in order, "
               "register-tiled CUDA-core FMAs)";
}

// dtype: 0 fp32, 1 bf16 (x, B and C alike).  x [Bsz, S, H, P], dt
// [Bsz, S, H] fp32, a_neg [H] fp32, B and C [Bsz, S, N], init (nullptr for
// zeros) and final_state [Bsz, H, P, N] fp32, y [Bsz, S, H, P] fp32, all
// contiguous and 16-byte aligned; 1 <= Q <= 256 and S a multiple of Q.
// bf16 only: scratch, 16-byte aligned, of ssd_scan_scratch_bytes (fp32
// reads none: nullptr).  Returns cudaGetLastError() after the launches,
// or -1 for a bad dtype code.
int ssd_scan_launch(int dtype, const void* x, const void* dt,
                    const void* a_neg, const void* B, const void* C,
                    const void* init, void* y, void* final_state,
                    void* scratch, int Bsz, int S, int H, int P, int N,
                    int Q, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return walk::launch<float>(x, dt, a_neg, B, C, init, y, final_state,
                                 Bsz, S, H, P, N, Q, s);
    case 1:
      return tcs::launch(x, dt, a_neg, B, C, init, y, final_state, scratch,
                         Bsz, S, H, P, N, Q, s);
    default:
      return -1;
  }
}

}  // extern "C"
