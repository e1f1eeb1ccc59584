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
// (54 launches a zamba2-2.7b prefill).  Its contract is that of the JAX
// package's ssd_chunked (repro/models/mamba2.py:51), which is what
// mamba2_forward consumes, not that of ssd_scan_tpu: y stays fp32 (the
// caller adds the skip term in fp32 before its one cast; ssd_scan_tpu
// rounds y to x's type), the final state is an output (the prefill cache
// that decode continues from; ssd_scan_tpu has none), and an initial
// state may be given (ssd_scan_tpu always starts from zeros).  The
// discretisation is fused: the kernel reads x and dt and forms x * dt and
// dt * a_neg itself, where the TPU wrapper computes both before the call.
//
// What it computes, per batch b, head h and chunk, with
// a_cum = cumsum(dt * a_neg) over the chunk (fp32) and xd = x * dt:
//   y[t]  = sum_{s <= t} exp(a_cum[t] - a_cum[s]) (C[t] . B[s]) xd[s]
//           + exp(a_cum[t]) (C[t] . state)
//   state = state * exp(a_cum[Q-1])
//           + sum_s exp(a_cum[Q-1] - a_cum[s]) xd[s] (x) B[s]
// with every product and sum in fp32 on the CUDA cores (no TF32).
//
// What bounds it on an H100: bytes, at zamba2-2.7b's prefill (h 80, p 64,
// n 64, Q 256, bf16 x).  At b 1, S 1024 the causal work is about 12.6
// MFLOP per (head, chunk), 4.0 GFLOP a call, 4.1 us at the bf16 peak
// (60 us at fp32's 67 TFLOP/s outside the tensor cores); the bytes are
// x, y, dt, B, C and the final state, about 33 MB, 10 us at 3.35 TB/s.
// This first version is simple and right, and far from that bound:
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
// Later work: tensor-core products, C B^T computed once per (batch,
// chunk) for all heads (B and C have one group), and a split over chunks
// with a second pass for the states.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

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

}  // namespace

extern "C" {

// Bytes of dynamic shared memory one CTA needs for chunk Q, head dim P and
// state N; the wrapper checks it against the card's 227 KB.
int ssd_scan_smem_bytes(int Q, int P, int N) {
  return static_cast<int>(sizeof(float)) * smem_floats(Q, P, N);
}

// The longest chunk the kernel takes.
int ssd_scan_max_chunk() { return kMaxChunk; }

// dtype: 0 fp32, 1 bf16 (x, B and C alike).  x [Bsz, S, H, P], dt
// [Bsz, S, H] fp32, a_neg [H] fp32, B and C [Bsz, S, N], init (nullptr for
// zeros) and final_state [Bsz, H, P, N] fp32, y [Bsz, S, H, P] fp32, all
// contiguous; 1 <= Q <= 256 and S a multiple of Q.  Returns
// cudaGetLastError() after the launch, or -1 for a bad dtype code.
int ssd_scan_launch(int dtype, const void* x, const void* dt,
                    const void* a_neg, const void* B, const void* C,
                    const void* init, void* y, void* final_state, int Bsz,
                    int S, int H, int P, int N, int Q, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return launch<float>(x, dt, a_neg, B, C, init, y, final_state, Bsz, S,
                           H, P, N, Q, s);
    case 1:
      return launch<__nv_bfloat16>(x, dt, a_neg, B, C, init, y, final_state,
                                   Bsz, S, H, P, N, Q, s);
    default:
      return -1;
  }
}

}  // extern "C"
