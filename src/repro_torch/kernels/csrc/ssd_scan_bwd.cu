// Mamba2 SSD chunked scan (backward) for Hopper (sm_90a): the gradients of
// ssd_chunked's contract (csrc/ssd_scan.cu),
//   x [b, S, h, p] (bf16 or fp32), dt [b, S, h] fp32, a_neg [h] fp32,
//   B, C [b, S, n] (x's type), optional init_state [b, h, p, n] fp32
//   -> y [b, S, h, p] fp32, final_state [b, h, p, n] fp32,
// given dy [b, S, h, p] fp32 and the final state's gradient dS [b, h, p, n]
// fp32 (nullptr for zeros: every training path discards the state):
//   dx [b, S, h, p] and dB, dC [b, S, n] in x's type, ddt [b, S, h] and
//   da_neg [h] fp32.  The initial state is not differentiated.
//
// Replaces no Pallas kernel: the JAX package trains zamba2 through the jnp
// ssd_chunked (repro/models/mamba2.py:51), which XLA differentiates.  The
// port runs its forward through the SSD-scan kernel (csrc/ssd_scan.cu),
// whose autograd Function (kernels/ssd_scan.py SSDScan) calls this kernel
// once per Mamba2 layer of a training step.
//
// The scan is cut into blocks of min(Q, 64) tokens along the sequence,
// Q the forward's chunk (the function does not depend on where the
// chunks are cut: a chunk of 256 is four blocks with the state passed
// between them; a chunk of 64 or fewer is one block, as the plain
// version cuts it, so the two sum in the same groups).  Per block, with
// acum[t] the cumulative sum of a = dt a_neg from the block's first token,
// L[t, s] = exp(acum[t] - acum[s]) for s <= t, e the block's last token,
// S_in its entering state and G the gradient of its leaving state:
//   dxd[s] = sum_{t>=s} L CB[t, s] dy[t] + exp(acum[e] - acum[s]) G B[s]
//   dC[t]  = sum_{s<=t} L DX[t, s] B[s] + exp(acum[t]) dy[t] S_in
//   dB[s]  = sum_{t>=s} L DX[t, s] C[t] + exp(acum[e] - acum[s]) xd[s] G
//   dacum  = rows - columns of M = L CB DX, + exp(acum[t]) C[t].(dy[t] S_in)
//            - exp(acum[e] - acum[s]) B[s].(xd[s] G), and at e
//            exp(acum[e]) <G, S_in> + the sum of the last term over s,
// with CB[t, s] = C[t] . B[s], DX[t, s] = dy[t] . xd[s], xd = x dt; then
// da = the reverse cumulative sum of dacum, ddt = da a_neg + dxd . x,
// dx = dxd dt, da_neg = sum da dt.  Across blocks, S_in[k + 1] = S_in[k]
// exp(acum[e]) + own[k] and G[k - 1] = G[k] exp(acum[e]) + sum_t
// exp(acum[t]) dy[t] (x) C[t].
// Four kernels from one C call, every value in fp32 on the CUDA cores (bf16
// inputs are widened as they are staged), every decay factor and state
// fp32:
//   1. block terms, one CTA per (head, block, batch): own[k] = sum_s
//      exp(acum[e] - acum[s]) xd[s] (x) B[s], gown[k] = sum_t exp(acum[t])
//      dy[t] (x) C[t] and acum[e], to a scratch the wrapper allocates;
//   2. state passing, one thread per (batch, head, state element): S_in by
//      the blocks in order, G in reverse, written over own and gown;
//   3. block gradients, one CTA per (head, block, batch): the relations
//      above over its T x T pairs, dx and ddt written, dB and dC as
//      per-head partials [b, S, h, n] and da_neg as a per-(batch, block,
//      head) partial;
//   4. reduction: dB and dC summed over the heads, da_neg over batch and
//      blocks, each in a fixed order.
// Deterministic, with no atomics: every sum runs in a fixed order in one
// thread (or in fixed strides then in thread order), so two calls give
// the same bits.
//
// What bounds it on an H100: operations.  zamba2-2.7b at B 4 x S 1024 (h
// 80, p 64, n 64): per (batch, head, block) four T x T x 64 products over
// the causal half (CB, DX, and the T-sums of dxd, dC and dB), 2 T n p and
// 2 T p n more for the state terms, about 4.2 M operations, 5,120 blocks:
// 22 GFLOP, 0.33 ms at the fp32 peak of 67 TFLOP/s (0.022 ms at the bf16
// peak, were the products on the tensor cores); the bytes (x, dt, B, C, dy
// read, dx, ddt, dB, dC written) about 130 MB, 0.04 ms.
// Later work: the products on the tensor cores (bf16 x exact, fp32 factors
// as hi + lo, as the forward's), no per-head partials for dB and dC.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kBlock = 64;  // tokens of a block at most

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

// Scratch offsets, in floats: S_in/own and G/gown [b, nb, h, p, n] each,
// the blocks' decay exponents and da_neg partials [b, nb, h] each, the dB
// and dC partials [b, S, h, n] each.
struct Scratch {
  float *st, *gst, *dec, *dap, *dbp, *dcp;
  __host__ Scratch(float* base, int Bsz, int S, int H, int P, int N,
                   int Tb) {
    const size_t nb = (S + Tb - 1) / Tb;
    const size_t states = static_cast<size_t>(Bsz) * nb * H * P * N;
    const size_t blocks = static_cast<size_t>(Bsz) * nb * H;
    const size_t parts = static_cast<size_t>(Bsz) * S * H * N;
    st = base;
    gst = st + states;
    dec = gst + states;
    dap = dec + blocks;
    dbp = dap + blocks;
    dcp = dbp + parts;
  }
};

__host__ __device__ inline size_t scratch_floats(int Bsz, int S, int H,
                                                 int P, int N, int Tb) {
  const size_t nb = (S + Tb - 1) / Tb;
  return 2 * static_cast<size_t>(Bsz) * nb * H * P * N +
         2 * static_cast<size_t>(Bsz) * nb * H +
         2 * static_cast<size_t>(Bsz) * S * H * N;
}

// The block's acum (from its first token) by one thread, in order; dts
// gets dt (0 past the block's Tk tokens).  Each a = dt a_neg is rounded
// to fp32 as the plain version's, the cumulative sum kept in fp64: over
// 64 tokens of strong decay acum reaches -100 or below, where an fp32
// cumulative sum's rounding (~1e-5 absolute) would become a relative
// error of every exp(acum[t] - acum[s]) between nearby tokens.
__device__ __forceinline__ void block_acum(const float* __restrict__ dt,
                                           size_t row0, int H, int h,
                                           int Tk, float an, double* acum,
                                           float* dts) {
  if (threadIdx.x == 0) {
    double a = 0.0;
    for (int s = 0; s < kBlock; ++s) {
      const float d = s < Tk ? dt[(row0 + s) * H + h] : 0.f;
      dts[s] = d;
      a += static_cast<double>(d * an);
      acum[s] = a;
    }
  }
}

// exp(x - y) of two fp64 cumulative sums, the difference taken in fp64.
__device__ __forceinline__ float exp_diff(double x, double y) {
  return expf(static_cast<float>(x - y));
}

int pass1_smem(int P, int N) {
  return 8 * kBlock + 4 * (2 * kBlock * (P + 1) + 2 * kBlock * (N + 1) +
                           kBlock);
}

// Pass 1: grid (H, nb, Bsz), blocks of Tb tokens.  own = sum_s
// exp(acum[e] - acum[s]) xd[s] (x) B[s], gown = sum_t exp(acum[t]) dy[t]
// (x) C[t], dec = acum[e].
template <typename T>
__global__ void __launch_bounds__(kThreads) ssd_bwd_block_terms(
    const T* __restrict__ x, const float* __restrict__ dt,
    const float* __restrict__ a_neg, const T* __restrict__ Bm,
    const T* __restrict__ Cm, const float* __restrict__ dy, Scratch sc,
    int S, int H, int P, int N, int Tb) {
  extern __shared__ __align__(8) unsigned char smem_raw[];
  const int h = blockIdx.x, k = blockIdx.y, b = blockIdx.z;
  const int nb = gridDim.y, tid = threadIdx.x;
  const int Tk = min(Tb, S - k * Tb);
  const int Pp = P + 1, Np = N + 1;
  double* acum = reinterpret_cast<double*>(smem_raw);  // [T]
  float* xw = reinterpret_cast<float*>(acum + kBlock);  // [T][Pp]
  float* dyw = xw + kBlock * Pp;    // [T][Pp] exp(acum[t]) dy[t]
  float* bs = dyw + kBlock * Pp;    // [T][Np]
  float* cs = bs + kBlock * Np;     // [T][Np]
  float* dts = cs + kBlock * Np;    // [T]
  const size_t row0 = static_cast<size_t>(b) * S + static_cast<size_t>(k) * Tb;
  block_acum(dt, row0, H, h, Tk, a_neg[h], acum, dts);
  __syncthreads();
  const double ae = acum[Tk - 1];
  for (int i = tid; i < kBlock * P; i += kThreads) {
    const int s = i / P, j = i % P;
    float xv = 0.f, gv = 0.f;
    if (s < Tk) {
      const size_t off = ((row0 + s) * H + h) * P + j;
      xv = to_float(x[off]) * dts[s] * exp_diff(ae, acum[s]);
      gv = dy[off] * expf(static_cast<float>(acum[s]));
    }
    xw[s * Pp + j] = xv;
    dyw[s * Pp + j] = gv;
  }
  for (int i = tid; i < kBlock * N; i += kThreads) {
    const int s = i / N, j = i % N;
    const bool in = s < Tk;
    bs[s * Np + j] = in ? to_float(Bm[(row0 + s) * N + j]) : 0.f;
    cs[s * Np + j] = in ? to_float(Cm[(row0 + s) * N + j]) : 0.f;
  }
  __syncthreads();
  const size_t blk = (static_cast<size_t>(b) * nb + k) * H + h;
  for (int i = tid; i < P * N; i += kThreads) {
    const int pi = i / N, ni = i % N;
    float own = 0.f, gown = 0.f;
    for (int s = 0; s < Tk; ++s) {
      own = fmaf(xw[s * Pp + pi], bs[s * Np + ni], own);
      gown = fmaf(dyw[s * Pp + pi], cs[s * Np + ni], gown);
    }
    sc.st[blk * P * N + i] = own;
    sc.gst[blk * P * N + i] = gown;
  }
  if (tid == 0) sc.dec[blk] = static_cast<float>(ae);
}

// Pass 2: one thread per (batch, head, state element).  S_in over the
// blocks in order (from init or zeros), G in reverse (from dS or zeros),
// each written over the block's own / gown.  The blocks go kRun at a
// time, their loads issued before the run's dependent updates, so that a
// thread keeps kRun loads in flight rather than one.
constexpr int kRun = 8;

__global__ void __launch_bounds__(kThreads) ssd_bwd_state_passing(
    Scratch sc, const float* __restrict__ init,
    const float* __restrict__ dfinal, int Bsz, int H, int PN, int nb) {
  const size_t i = static_cast<size_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (i >= static_cast<size_t>(Bsz) * H * PN) return;
  const int e = static_cast<int>(i % PN);
  const size_t bh = i / PN;
  const int h = static_cast<int>(bh % H), b = static_cast<int>(bh / H);
  // block k of this (batch, head): its decay at blk(k), its state at
  // blk(k) * PN + e
  auto blk = [&](int k) { return (static_cast<size_t>(b) * nb + k) * H + h; };
  float vals[kRun], decay[kRun];
  float s = init != nullptr ? init[i] : 0.f;
  for (int k0 = 0; k0 < nb; k0 += kRun) {
#pragma unroll
    for (int r = 0; r < kRun; ++r)
      if (k0 + r < nb) {
        vals[r] = sc.st[blk(k0 + r) * PN + e];
        decay[r] = sc.dec[blk(k0 + r)];
      }
#pragma unroll
    for (int r = 0; r < kRun; ++r)
      if (k0 + r < nb) {
        sc.st[blk(k0 + r) * PN + e] = s;
        s = s * expf(decay[r]) + vals[r];
      }
  }
  float g = dfinal != nullptr ? dfinal[i] : 0.f;
  for (int k0 = nb - 1; k0 >= 0; k0 -= kRun) {
#pragma unroll
    for (int r = 0; r < kRun; ++r)
      if (k0 - r >= 0) {
        vals[r] = sc.gst[blk(k0 - r) * PN + e];
        decay[r] = sc.dec[blk(k0 - r)];
      }
#pragma unroll
    for (int r = 0; r < kRun; ++r)
      if (k0 - r >= 0) {
        sc.gst[blk(k0 - r) * PN + e] = g;
        g = g * expf(decay[r]) + vals[r];
      }
  }
}

int pass3_smem(int P, int N) {
  const int T = kBlock, Pp = P + 1, Np = N + 1;
  const int R = P > N ? Pp : Np;
  return 8 * T + 4 * (2 * T * Pp + 2 * T * Np + 2 * P * Np +
                      3 * T * (T + 1) + T * R + 8 * T + kThreads);
}

// Pass 3: grid (H, nb, Bsz), blocks of Tb tokens; the block's gradients
// (the relations of the note at the top of this file).
template <typename T>
__global__ void __launch_bounds__(kThreads, 1) ssd_bwd_block_grads(
    const T* __restrict__ x, const float* __restrict__ dt,
    const float* __restrict__ a_neg, const T* __restrict__ Bm,
    const T* __restrict__ Cm, const float* __restrict__ dy, Scratch sc,
    T* __restrict__ dx, float* __restrict__ ddt, int S, int H, int P,
    int N, int Tb) {
  extern __shared__ __align__(8) unsigned char smem_raw[];
  constexpr int TT = kBlock + 1;  // row stride of the T x T tiles
  const int h = blockIdx.x, k = blockIdx.y, b = blockIdx.z;
  const int nb = gridDim.y, tid = threadIdx.x;
  const int Tk = min(Tb, S - k * Tb);
  const int Pp = P + 1, Np = N + 1;
  const int Rp = P > N ? Pp : Np;
  double* acum = reinterpret_cast<double*>(smem_raw);  // [T]
  float* xd = reinterpret_cast<float*>(acum + kBlock);  // [T][Pp] x dt
  float* dys = xd + kBlock * Pp;     // [T][Pp]
  float* bs = dys + kBlock * Pp;     // [T][Np]
  float* cs = bs + kBlock * Np;      // [T][Np]
  float* sst = cs + kBlock * Np;     // [P][Np] the entering state
  float* gs = sst + P * Np;          // [P][Np] the leaving state's gradient
  float* lcb = gs + P * Np;          // [T][TT] L CB
  float* ldx = lcb + kBlock * TT;    // [T][TT] L DX
  float* mm = ldx + kBlock * TT;     // [T][TT] L CB DX
  float* red = mm + kBlock * TT;     // [T][Rp] terms of per-row sums
  float* dts = red + kBlock * Rp;    // [T]
  float* rowm = dts + kBlock;        // [T]
  float* colm = rowm + kBlock;       // [T]
  float* dxx = colm + kBlock;        // [T] dxd . x
  float* y0 = dxx + kBlock;          // [T]
  float* wv = y0 + kBlock;           // [T]
  float* ea = wv + kBlock;           // [T] exp(acum[t])
  float* ee = ea + kBlock;           // [T] exp(acum[e] - acum[s])
  float* part = ee + kBlock;         // [kThreads]
  const float an = a_neg[h];
  const size_t row0 = static_cast<size_t>(b) * S + static_cast<size_t>(k) * Tb;
  const size_t blk = (static_cast<size_t>(b) * nb + k) * H + h;
  block_acum(dt, row0, H, h, Tk, an, acum, dts);
  __syncthreads();
  const int e = Tk - 1;
  if (tid < kBlock) {
    ea[tid] = tid < Tk ? expf(static_cast<float>(acum[tid])) : 0.f;
    ee[tid] = tid < Tk ? exp_diff(acum[e], acum[tid]) : 0.f;
  }
  for (int i = tid; i < kBlock * P; i += kThreads) {
    const int s = i / P, j = i % P;
    float xv = 0.f, gv = 0.f;
    if (s < Tk) {
      const size_t off = ((row0 + s) * H + h) * P + j;
      xv = to_float(x[off]) * dts[s];
      gv = dy[off];
    }
    xd[s * Pp + j] = xv;
    dys[s * Pp + j] = gv;
  }
  for (int i = tid; i < kBlock * N; i += kThreads) {
    const int s = i / N, j = i % N;
    const bool in = s < Tk;
    bs[s * Np + j] = in ? to_float(Bm[(row0 + s) * N + j]) : 0.f;
    cs[s * Np + j] = in ? to_float(Cm[(row0 + s) * N + j]) : 0.f;
  }
  for (int i = tid; i < P * N; i += kThreads) {
    sst[(i / N) * Np + i % N] = sc.st[blk * P * N + i];
    gs[(i / N) * Np + i % N] = sc.gst[blk * P * N + i];
  }
  __syncthreads();

  // the pairs: L CB, L DX and M over s <= t < Tk (zeros elsewhere)
  for (int i = tid; i < kBlock * kBlock; i += kThreads) {
    const int t = i / kBlock, s = i % kBlock;
    float a = 0.f, c = 0.f, m = 0.f;
    if (s <= t && t < Tk) {
      float cb = 0.f, dxv = 0.f;
      for (int j = 0; j < N; ++j) cb = fmaf(cs[t * Np + j], bs[s * Np + j], cb);
      for (int j = 0; j < P; ++j)
        dxv = fmaf(dys[t * Pp + j], xd[s * Pp + j], dxv);
      const float l = exp_diff(acum[t], acum[s]);
      a = l * cb;
      c = l * dxv;
      m = a * dxv;
    }
    lcb[t * TT + s] = a;
    ldx[t * TT + s] = c;
    mm[t * TT + s] = m;
  }
  __syncthreads();
  if (tid < kBlock) {  // M's row sums
    float r = 0.f;
    for (int s = 0; s <= tid; ++s) r += mm[tid * TT + s];
    rowm[tid] = r;
  } else if (tid < 2 * kBlock) {  // and column sums
    const int s = tid - kBlock;
    float c = 0.f;
    for (int t = s; t < kBlock; ++t) c += mm[t * TT + s];
    colm[s] = c;
  }

  // dxd [T][P]: dx = dxd dt, and dxd x for ddt
  for (int i = tid; i < kBlock * P; i += kThreads) {
    const int s = i / P, j = i % P;
    float v = 0.f;
    if (s < Tk) {
      for (int t = s; t < Tk; ++t)
        v = fmaf(lcb[t * TT + s], dys[t * Pp + j], v);
      float gb = 0.f;
      for (int q = 0; q < N; ++q) gb = fmaf(gs[j * Np + q], bs[s * Np + q], gb);
      v = fmaf(ee[s], gb, v);
      const size_t off = ((row0 + s) * H + h) * P + j;
      dx[off] = from_float<T>(v * dts[s]);
      v *= to_float(x[off]);
    }
    red[s * Rp + j] = v;
  }
  __syncthreads();
  if (tid < kBlock) {
    float r = 0.f;
    for (int j = 0; j < P; ++j) r += red[tid * Rp + j];
    dxx[tid] = r;
  }
  __syncthreads();

  // dC [T][N] (per-head partial) and the terms of Y0
  for (int i = tid; i < kBlock * N; i += kThreads) {
    const int t = i / N, j = i % N;
    float term = 0.f;
    if (t < Tk) {
      float q = 0.f;
      for (int pi = 0; pi < P; ++pi)
        q = fmaf(dys[t * Pp + pi], sst[pi * Np + j], q);
      float v = 0.f;
      for (int s = 0; s <= t; ++s) v = fmaf(ldx[t * TT + s], bs[s * Np + j], v);
      v = fmaf(ea[t], q, v);
      sc.dcp[((row0 + t) * H + h) * N + j] = v;
      term = ea[t] * q * cs[t * Np + j];
    }
    red[t * Rp + j] = term;
  }
  __syncthreads();
  if (tid < kBlock) {
    float r = 0.f;
    for (int j = 0; j < N; ++j) r += red[tid * Rp + j];
    y0[tid] = r;
  }
  __syncthreads();

  // dB [T][N] (per-head partial) and the terms of W
  for (int i = tid; i < kBlock * N; i += kThreads) {
    const int s = i / N, j = i % N;
    float term = 0.f;
    if (s < Tk) {
      float r = 0.f;
      for (int pi = 0; pi < P; ++pi)
        r = fmaf(xd[s * Pp + pi], gs[pi * Np + j], r);
      float v = 0.f;
      for (int t = s; t < Tk; ++t) v = fmaf(ldx[t * TT + s], cs[t * Np + j], v);
      v = fmaf(ee[s], r, v);
      sc.dbp[((row0 + s) * H + h) * N + j] = v;
      term = ee[s] * r * bs[s * Np + j];
    }
    red[s * Rp + j] = term;
  }
  // <G, S_in>: strided partials, then in thread order
  float gsum = 0.f;
  for (int i = tid; i < P * N; i += kThreads)
    gsum = fmaf(gs[(i / N) * Np + i % N], sst[(i / N) * Np + i % N], gsum);
  part[tid] = gsum;
  __syncthreads();
  if (tid < kBlock) {
    float r = 0.f;
    for (int j = 0; j < N; ++j) r += red[tid * Rp + j];
    wv[tid] = r;
  }
  __syncthreads();

  if (tid == 0) {
    float gdot = 0.f;
    for (int i = 0; i < kThreads; ++i) gdot += part[i];
    float wsum = 0.f;
    for (int s = 0; s < Tk; ++s) wsum += wv[s];
    // da = the reverse cumulative sum of dacum; ddt and the da_neg partial
    float da = 0.f, dan = 0.f;
    for (int t = Tk - 1; t >= 0; --t) {
      float dac = rowm[t] - colm[t] + y0[t] - wv[t];
      if (t == e) dac += ea[e] * gdot + wsum;
      da += dac;
      ddt[(row0 + t) * H + h] = da * an + dxx[t];
      dan = fmaf(da, dts[t], dan);
    }
    sc.dap[blk] = dan;
  }
}

// Pass 4: dB and dC summed over the heads in order, da_neg over (batch,
// block) in order.
template <typename T>
__global__ void __launch_bounds__(kThreads) ssd_bwd_reduce(
    Scratch sc, T* __restrict__ dB, T* __restrict__ dC,
    float* __restrict__ da_neg, int Bsz, int S, int H, int N, int nb) {
  const size_t rows = static_cast<size_t>(Bsz) * S * N;
  const size_t total = 2 * rows + H;
  for (size_t i = static_cast<size_t>(blockIdx.x) * kThreads + threadIdx.x;
       i < total; i += static_cast<size_t>(gridDim.x) * kThreads) {
    if (i < 2 * rows) {
      const bool is_c = i >= rows;
      const size_t r = is_c ? i - rows : i;
      const size_t bs = r / N, j = r % N;  // (batch, token), state element
      const float* src = (is_c ? sc.dcp : sc.dbp) + bs * H * N + j;
      float v = 0.f;
      for (int h = 0; h < H; ++h) v += src[static_cast<size_t>(h) * N];
      (is_c ? dC : dB)[r] = from_float<T>(v);
    } else {
      const int h = static_cast<int>(i - 2 * rows);
      float v = 0.f;
      for (int b = 0; b < Bsz; ++b)
        for (int k = 0; k < nb; ++k)
          v += sc.dap[(static_cast<size_t>(b) * nb + k) * H + h];
      da_neg[h] = v;
    }
  }
}

template <typename K>
cudaError_t allow_smem(K kernel, int bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

template <typename T>
int launch(const void* x, const void* dt, const void* a_neg, const void* B,
           const void* C, const void* init, const void* dy,
           const void* dfinal, void* dx, void* ddt, void* da_neg, void* dB,
           void* dC, void* scratch, int Bsz, int S, int H, int P, int N,
           int Q, cudaStream_t stream) {
  const T* xp = static_cast<const T*>(x);
  const float* dtp = static_cast<const float*>(dt);
  const float* ap = static_cast<const float*>(a_neg);
  const T* bp = static_cast<const T*>(B);
  const T* cp = static_cast<const T*>(C);
  const float* dyp = static_cast<const float*>(dy);
  const int Tb = Q < kBlock ? Q : kBlock;
  const int nb = (S + Tb - 1) / Tb;
  const Scratch sc(static_cast<float*>(scratch), Bsz, S, H, P, N, Tb);
  const dim3 grid(H, nb, Bsz);

  auto k1 = ssd_bwd_block_terms<T>;
  cudaError_t err = allow_smem(k1, pass1_smem(P, N));
  if (err != cudaSuccess) return static_cast<int>(err);
  k1<<<grid, kThreads, pass1_smem(P, N), stream>>>(xp, dtp, ap, bp, cp, dyp,
                                                   sc, S, H, P, N, Tb);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  const size_t threads = static_cast<size_t>(Bsz) * H * P * N;
  ssd_bwd_state_passing<<<static_cast<unsigned>(
                              (threads + kThreads - 1) / kThreads),
                          kThreads, 0, stream>>>(
      sc, static_cast<const float*>(init), static_cast<const float*>(dfinal),
      Bsz, H, P * N, nb);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  auto k3 = ssd_bwd_block_grads<T>;
  err = allow_smem(k3, pass3_smem(P, N));
  if (err != cudaSuccess) return static_cast<int>(err);
  k3<<<grid, kThreads, pass3_smem(P, N), stream>>>(
      xp, dtp, ap, bp, cp, dyp, sc, static_cast<T*>(dx),
      static_cast<float*>(ddt), S, H, P, N, Tb);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  const size_t total = 2 * static_cast<size_t>(Bsz) * S * N + H;
  const size_t want = (total + kThreads - 1) / kThreads;
  ssd_bwd_reduce<T><<<static_cast<unsigned>(want < 4096 ? want : 4096),
                      kThreads, 0, stream>>>(
      sc, static_cast<T*>(dB), static_cast<T*>(dC),
      static_cast<float*>(da_neg), Bsz, S, H, N, nb);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// The most tokens of a block of the backward (a chunk Q below it is
// one block).
int ssd_scan_bwd_block() { return kBlock; }

// Bytes of dynamic shared memory one CTA of pass 1 or pass 3 takes for
// head dim P and state N (-1 for another pass).
int ssd_scan_bwd_smem_bytes(int pass, int P, int N) {
  return pass == 1 ? pass1_smem(P, N) : pass == 3 ? pass3_smem(P, N) : -1;
}

// Bytes of the backward's fp32 scratch (see Scratch) for chunk Q.
long long ssd_scan_bwd_scratch_bytes(int Bsz, int S, int H, int P, int N,
                                     int Q) {
  return 4LL * static_cast<long long>(
                   scratch_floats(Bsz, S, H, P, N, Q < kBlock ? Q : kBlock));
}

// dtype: 0 fp32, 1 bf16 (x, B, C, dx, dB and dC alike).  x, dx [Bsz, S,
// H, P]; dt, ddt [Bsz, S, H] fp32; a_neg, da_neg [H] fp32; B, C, dB, dC
// [Bsz, S, N]; init (nullptr for zeros) and dfinal (nullptr for zeros)
// [Bsz, H, P, N] fp32; dy [Bsz, S, H, P] fp32; scratch of
// ssd_scan_bwd_scratch_bytes; all contiguous.  Bsz, S, H > 0; Q the
// forward's chunk: blocks of min(Q, 64) tokens.  Four kernels on
// `stream`; returns cudaGetLastError() after each launch (the first
// failure), -1 for a bad dtype code.
int ssd_scan_bwd_launch(int dtype, const void* x, const void* dt,
                        const void* a_neg, const void* B, const void* C,
                        const void* init, const void* dy, const void* dfinal,
                        void* dx, void* ddt, void* da_neg, void* dB,
                        void* dC, void* scratch, int Bsz, int S, int H,
                        int P, int N, int Q, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return launch<float>(x, dt, a_neg, B, C, init, dy, dfinal, dx, ddt,
                           da_neg, dB, dC, scratch, Bsz, S, H, P, N, Q, s);
    case 1:
      return launch<__nv_bfloat16>(x, dt, a_neg, B, C, init, dy, dfinal, dx,
                                   ddt, da_neg, dB, dC, scratch, Bsz, S, H,
                                   P, N, Q, s);
    default:
      return -1;
  }
}

}  // extern "C"
