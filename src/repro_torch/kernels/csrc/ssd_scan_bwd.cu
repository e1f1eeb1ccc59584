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
// Four kernels from one C call, every decay factor and state fp32:
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
//
// What bounds it on an H100: bytes, once the products are on the tensor
// cores.  zamba2-2.7b at B 4 x S 1024 (h 80, p 64, n 64): per (batch,
// head, block) the causal pairs' CB, DX and the T-sums of dxd, dC and dB,
// 2 T n p and 2 T p n more for the state terms, about 4.2 M operations,
// 5,120 blocks: 22 GFLOP, 0.022 ms at the bf16 peak (0.33 ms at the fp32
// peak of the CUDA cores); x, dt, B, C, dy read and dx, ddt, dB, dC
// written, about 172 MB, 0.051 ms at 3.35 TB/s.  The scratch (each
// block's state and its gradient, 84 MB each in fp32, written by pass 1,
// rewritten by pass 2 and read by pass 3) and the per-head partials of dB
// and dC (84 MB each) are about four times those bytes again.
//
// bf16 x, B and C with p and n up to 64 (rounded up to 16: every zamba2
// shape) run passes 1 and 3 on the tensor cores (namespace tcb: mma.sync
// m16n8k16, fp32 accumulators, tc_bf16.cuh), four warps a CTA:
//   * every product keeps its exact bf16 operand (x, B or C) and splits
//     only its fp32 factor into bf16 hi = bf16(v) and lo = bf16(v - hi),
//     within 2^-16 of v, at the cost of a second product; where both
//     factors are fp32 (L CB against dy, dy against S_in) it takes three
//     (hi.hi + hi.lo + lo.hi).  dt and the decays stay out of the
//     products as row or column scales of the fp32 accumulators wherever
//     they factor out (the state terms' exp(acum[e] - acum[s]) and dt[s],
//     exp(acum[t]) of dC, DX = dt[s] (dy . x)); where a factor runs along
//     the reduction (W = B dt exp(..) of own, exp(acum) dy of gown, L of
//     the pair sums) it is folded into the fp32 factor before the split.
//     One bf16 rounding of an fp32 factor would be off by up to 2^-8 of
//     it; the CPU test of this arithmetic (tests/
//     test_torch_train_kernels_tc.py) shows that past 1e-4 of the plain
//     backward, and the split within it;
//   * pass 1 takes the forward's block-state pattern (ssd_scan.cu's pass
//     1): warp w owns 16 columns of n and every row of p; W's fragments
//     are scaled and split in registers as they are loaded, exp(acum) dy
//     is split once as it is staged;
//   * pass 3, warp w owns key rows s of 16 w .. 16 w + 15 and then query
//     rows t of the same 16.  With the keys as the product's rows, CB^T
//     and DX^T are computed over t >= s, so that L CB^T and L DX^T (L,
//     the mask and M = L CB DX made elementwise on the accumulators) are,
//     fragment for fragment, the A operands of dxd = (L CB^T) dy and dB =
//     (L DX^T) C (the flash backward's transposed scores), split in
//     registers; M's column sums come from the quads, its row sums from
//     shuffles by warp into shared memory.  L DX^T goes to shared memory
//     once as hi + lo, and the query rows read it back transposed for dC
//     = L DX B.  The state terms take G and S_in as hi + lo tiles staged
//     once; the warps' key and query rows balance the causal half (warp 0
//     has four tiles of keys' pairs and one of queries', warp 3 the
//     reverse).  The block's staging issues every load of dy, G and S_in
//     before any is used, and its serial tail (da's reverse cumulative
//     sum) is a warp scan;
//   * p and n of 64 (zamba2's) run instantiations whose trip counts are
//     constants, so that the compiler unrolls the products and issues
//     their fragment loads ahead of them: the block gradients take
//     0.59 ms with the counts read at run time and 0.44 ms so, the block
//     terms 0.133 and 0.119 ms (device time at zamba2's B 4 x S 1024,
//     scripts/bwd_kernel_variants.py, H100 80GB HBM3 at 700 W);
//   * passes 2 and 4 are the CUDA-core kernels that fp32 runs.
// bf16 past 64 runs the fp32 passes on bf16 inputs (widened as they are
// staged), as the first version did for every bf16 shape; that version
// stays reachable at any shape through ssd_scan_bwd_launch_cuda_cores,
// which the port never calls: chip_smoke.py times it beside the new
// passes.  kernels/ssd_scan.py bwd_variant names the choice.
// fp32 x keeps the first version's four CUDA-core passes unchanged (full
// fp32 FMAs, no TF32, no split): the fp32 comparisons of the tests and of
// chip_smoke.py rest on them.
// Deterministic, with no atomics: every sum runs in a fixed order in one
// thread, in fixed strides then in thread order, or in a fixed shuffle
// pattern that gives every lane the same bits, so two calls give the
// same bits.
// Later work: the state passing folded into pass 3 (or its states written
// as bf16 hi + lo, as the forward's), no per-head partials for dB and dC
// (CB^T and the B- and C-side sums are shared by all heads of a block),
// and wgmma for the pair products.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "tc_bf16.cuh"

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

// --------------------------------------- bf16: products on the tensor cores

namespace tcb {

using tc::bf16;
constexpr int kThreads = 128;  // passes 1 and 3: four warps
constexpr int LD = 72;         // bf16 elements a shared row (64 + 8)
constexpr int kTile = kBlock * LD;  // one [64][LD] bf16 tile
static_assert(kBlock == 16 * (kThreads / 32), "16 rows a warp");

__host__ __device__ inline int pad16(int v) { return (v + 15) & ~15; }

// Whether the tensor-core passes take head dim P and state N (both padded
// to 16 fit the [64][LD] tiles).
__host__ __device__ inline bool fits(int P, int N) {
  return pad16(P) <= 64 && pad16(N) <= 64;
}

// Pass 1: x, B, C and (exp(acum) dy) as hi + lo, five tiles; acum (fp64),
// dt, the keys' factors and exp(acum) [64].
__host__ __device__ inline int terms_smem() {
  return 5 * kTile * 2 + 8 * kBlock + 3 * 4 * kBlock;
}

// Pass 3: x, B, C, dy as hi + lo, G and S_in as hi + lo, L DX^T as hi +
// lo, eleven tiles; acum (fp64); dt, exp(acum), exp(acum[e] - acum),
// colm, dxd . x, Y0, W [64], the row sums of M by warp [4][64] and the
// <G, S_in> partials [kThreads].
__host__ __device__ inline int grads_smem() {
  return 11 * kTile * 2 + 8 * kBlock + 4 * (7 * kBlock + 4 * kBlock +
                                            kThreads);
}

// rows x cols bf16 (row r at src + r * stride) into a [64][LD] tile, zero
// past rows (up to 64) and cols (up to pad16(cols)).  vec: cols and stride
// multiples of 8 and src 16-byte aligned (16-byte cp.async, zero-filled
// past the edge); else value by value.  The caller commits and waits.
__device__ __forceinline__ void stage(bf16* dst, const bf16* src,
                                      size_t stride, int rows, int cols,
                                      bool vec) {
  const int cp = pad16(cols);
  if (vec) {
    const int runs = cp / 8;
    for (int i = threadIdx.x; i < kBlock * runs; i += kThreads) {
      const int r = i / runs, c = (i % runs) * 8;
      const bool in = r < rows && c < cols;
      tc::cp_async16(dst + r * LD + c, in ? src + r * stride + c : src,
                     in ? 16 : 0);
    }
  } else {
    for (int i = threadIdx.x; i < kBlock * cp; i += kThreads) {
      const int r = i / cp, c = i % cp;
      dst[r * LD + c] = r < rows && c < cols ? src[r * stride + c]
                                             : __float2bfloat16(0.f);
    }
  }
}

// A [64][pad16(cols)] fp32 tile as this thread's pairs of values: pair j
// is element (r, c), (r, c + 1) with 2 i = r pad16(cols) + c, i = tid + j
// kThreads; zero past rows and cols (and for r past 64).  All loads are
// issued before any is used, so a tile costs one round trip to memory.
constexpr int kPairs = kBlock * 64 / 2 / kThreads;  // 16

__device__ __forceinline__ void load_pairs(float2 (&v)[kPairs],
                                           const float* __restrict__ src,
                                           size_t stride, int rows,
                                           int cols) {
  const int cp = pad16(cols);
#pragma unroll
  for (int j = 0; j < kPairs; ++j) {
    const int i = threadIdx.x + j * kThreads;
    const int r = (2 * i) / cp, c = (2 * i) % cp;
    float2 x = make_float2(0.f, 0.f);
    if (r < rows) {
      if (c < cols) x.x = src[r * stride + c];
      if (c + 1 < cols) x.y = src[r * stride + c + 1];
    }
    v[j] = x;
  }
}

// The pairs of load_pairs, each value times scale[r] (nullptr: 1), into
// [64][LD] tiles as bf16 hi and lo (zero rows and columns up to 64 and
// pad16(cols) included).
__device__ __forceinline__ void store_split(bf16* hi, bf16* lo,
                                            const float2 (&v)[kPairs],
                                            int cols, const float* scale) {
  const int cp = pad16(cols);
#pragma unroll
  for (int j = 0; j < kPairs; ++j) {
    const int i = threadIdx.x + j * kThreads;
    const int r = (2 * i) / cp, c = (2 * i) % cp;
    if (r >= kBlock) continue;
    const float f = scale != nullptr ? scale[r] : 1.f;
    unsigned h, l;
    tc::split_bf16(v[j].x * f, v[j].y * f, h, l);
    *reinterpret_cast<unsigned*>(hi + r * LD + c) = h;
    *reinterpret_cast<unsigned*>(lo + r * LD + c) = l;
  }
}

// Columns c and c + 1 (c even) of a row of `cols` fp32 values: one 8-byte
// store where both lie in the row and cols is even, else each that lies
// in it.
__device__ __forceinline__ void store2(float* row, int c, int cols, float v0,
                                       float v1) {
  if (c + 1 < cols && cols % 2 == 0) {
    *reinterpret_cast<float2*>(row + c) = make_float2(v0, v1);
  } else {
    if (c < cols) row[c] = v0;
    if (c + 1 < cols) row[c + 1] = v1;
  }
}

// The sum over the warp's lanes, in a fixed order that gives every lane
// the same bits.
__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 1; off < 32; off <<= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// The block's dt (dts, 0 past Tk) and acum[s] = sum_{u <= s} dt[u] a_neg
// from its first token, each product rounded to fp32 as the plain
// version's, the sum in fp64 (see block_acum): warp 0, two tokens a lane,
// an inclusive scan of the lanes' sums.  Passes 1 and 3 run this same
// code, so they see the same acum.  The caller syncs.
__device__ __forceinline__ void block_scan(const float* __restrict__ dt,
                                           size_t row0, int H, int h,
                                           int Tk, float an, double* acum,
                                           float* dts) {
  if (threadIdx.x >= 32) return;
  const int lane = threadIdx.x, s0 = 2 * lane;
  const float d0 = s0 < Tk ? dt[(row0 + s0) * H + h] : 0.f;
  const float d1 = s0 + 1 < Tk ? dt[(row0 + s0 + 1) * H + h] : 0.f;
  dts[s0] = d0;
  dts[s0 + 1] = d1;
  const double v0 = static_cast<double>(d0 * an);
  const double v1 = v0 + static_cast<double>(d1 * an);
  double a = v1;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const double o = __shfl_up_sync(0xffffffffu, a, off);
    if (lane >= off) a += o;
  }
  double pre = __shfl_up_sync(0xffffffffu, a, 1);
  if (lane == 0) pre = 0.0;
  acum[s0] = pre + v0;
  acum[s0 + 1] = pre + v1;
}

// Fragments (tc_bf16.cuh's layouts) from [64][LD] tiles.  A of rows r0..
// r0 + 15 and reduction k0.. k0 + 15: a_frag from [row][k] storage,
// a_frag_t from [k][row]; B of columns n0.. n0 + 15 (two 8-column tiles:
// b[0], b[1] and b[2], b[3]): b_frag from [n][k], b_frag_t from [k][n].
__device__ __forceinline__ void a_frag(unsigned (&a)[4], const bf16* t, int r0,
                                       int k0) {
  const int lane = threadIdx.x & 31;
  tc::ldsm_x4(a, t + (r0 + (lane & 15)) * LD + k0 + (lane >> 4) * 8);
}
__device__ __forceinline__ void a_frag_t(unsigned (&a)[4], const bf16* t,
                                         int r0, int k0) {
  const int lane = threadIdx.x & 31;
  tc::ldsm_x4_trans(a, t + (k0 + (lane & 7) + (lane >> 4) * 8) * LD + r0 +
                           ((lane >> 3) & 1) * 8);
}
__device__ __forceinline__ void b_frag(unsigned (&b)[4], const bf16* t, int n0,
                                       int k0) {
  const int lane = threadIdx.x & 31;
  tc::ldsm_x4(b, t + (n0 + (lane & 7) + (lane >> 4) * 8) * LD + k0 +
                     ((lane >> 3) & 1) * 8);
}
__device__ __forceinline__ void b_frag_t(unsigned (&b)[4], const bf16* t,
                                         int n0, int k0) {
  const int lane = threadIdx.x & 31;
  tc::ldsm_x4_trans(b, t + (k0 + (lane & 7) + ((lane >> 3) & 1) * 8) * LD +
                           n0 + (lane >> 4) * 8);
}

// Two 8-column accumulator tiles (16 rows, columns 16 kb .. 16 kb + 15 of
// the accumulator) as the A fragment of a product whose reduction runs
// over those columns, split into bf16 hi and lo.
__device__ __forceinline__ void acc_as_a(const float (&c0)[4],
                                         const float (&c1)[4],
                                         unsigned (&hi)[4],
                                         unsigned (&lo)[4]) {
  tc::split_bf16(c0[0], c0[1], hi[0], lo[0]);
  tc::split_bf16(c0[2], c0[3], hi[1], lo[1]);
  tc::split_bf16(c1[0], c1[1], hi[2], lo[2]);
  tc::split_bf16(c1[2], c1[3], hi[3], lo[3]);
}

// acc [16 rows][8 j + ..] += A . B over 16 columns pairs: B fragments of
// columns 16 q .. 16 q + 15 into acc[2 q] and acc[2 q + 1].
__device__ __forceinline__ void mma2(float (&c0)[4], float (&c1)[4],
                                     const unsigned (&a)[4],
                                     const unsigned (&b)[4]) {
  tc::mma_bf16(c0, a, b[0], b[1]);
  tc::mma_bf16(c1, a, b[2], b[3]);
}

// The sum over the four lanes of a quad (the same row of a fragment), in
// a fixed order that gives every lane the same bits.
__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  v += __shfl_xor_sync(0xffffffffu, v, 2);
  return v;
}

// Pass 1 (bf16): grid (H, nb, Bsz), blocks of Tb tokens, P and N padded
// to at most 64.  own = x^T W, W[s] = B[s] dt[s] exp(acum[e] - acum[s])
// (the forward's block state: x exact, W split in registers into hi + lo
// as each fragment is loaded); gown = (exp(acum) dy)^T C (the fp32 factor
// staged as hi + lo, C exact).  Warp w takes columns 16 w .. 16 w + 15 of
// n and every row of p; hi products before lo ones.
template <int KP>
__global__ void __launch_bounds__(kThreads) ssd_bwd_block_terms_tc(
    const bf16* __restrict__ x, const float* __restrict__ dt,
    const float* __restrict__ a_neg, const bf16* __restrict__ Bm,
    const bf16* __restrict__ Cm, const float* __restrict__ dy, Scratch sc,
    int S, int H, int P, int N, int Tb) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* xs = reinterpret_cast<bf16*>(smem_raw);
  bf16* bs = xs + kTile;
  bf16* cs = bs + kTile;
  bf16* eyh = cs + kTile;
  bf16* eyl = eyh + kTile;
  double* acum = reinterpret_cast<double*>(eyl + kTile);
  float* dts = reinterpret_cast<float*>(acum + kBlock);
  float* fs = dts + kBlock;  // dt exp(acum[e] - acum)
  float* ea = fs + kBlock;   // exp(acum)
  const int h = blockIdx.x, k = blockIdx.y, b = blockIdx.z;
  const int nb = gridDim.y, tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5, g = lane >> 2, t4 = lane & 3;
  const int Tk = min(Tb, S - k * Tb);
  const int Pp = pad16(P), Np = pad16(N);
  const size_t row0 = static_cast<size_t>(b) * S + static_cast<size_t>(k) * Tb;
  stage(xs, x + (row0 * H + h) * P, static_cast<size_t>(H) * P, Tk, P,
        P % 8 == 0);
  stage(bs, Bm + row0 * N, N, Tk, N, N % 8 == 0);
  stage(cs, Cm + row0 * N, N, Tk, N, N % 8 == 0);
  tc::cp_async_commit();
  float2 dyv[kPairs];
  load_pairs(dyv, dy + (row0 * H + h) * P, static_cast<size_t>(H) * P, Tk,
             P);
  block_scan(dt, row0, H, h, Tk, a_neg[h], acum, dts);
  __syncthreads();
  const double ae = acum[Tk - 1];
  if (tid < kBlock) {
    fs[tid] = dts[tid] * exp_diff(ae, acum[tid]);
    ea[tid] = tid < Tk ? expf(static_cast<float>(acum[tid])) : 0.f;
  }
  __syncthreads();
  store_split(eyh, eyl, dyv, P, ea);
  tc::cp_async_wait<0>();
  __syncthreads();

  const size_t blk = (static_cast<size_t>(b) * nb + k) * H + h;
  const int n0 = 16 * warp;
  if (n0 < Np) {
    const int mq = KP ? KP : Pp / 16;  // 16-row tiles of p
    float own[4][2][4] = {}, gown[4][2][4] = {};
    for (int k0 = 0; k0 < pad16(Tk); k0 += 16) {
      // W's B fragment (tokens k0 + 2 t4 (+1) in registers 0 and 2, k0 +
      // 8 + 2 t4 (+1) in 1 and 3), split after its scale; C's exact
      unsigned raw[4], wh[4], wl[4], cb[4];
      b_frag_t(raw, bs, n0, k0);
      b_frag_t(cb, cs, n0, k0);
      const float2 fa = *reinterpret_cast<const float2*>(fs + k0 + 2 * t4);
      const float2 fb = *reinterpret_cast<const float2*>(fs + k0 + 8 + 2 * t4);
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const float2 f = r & 1 ? fb : fa;
        const float2 v = __bfloat1622float2(
            *reinterpret_cast<const __nv_bfloat162*>(&raw[r]));
        tc::split_bf16(v.x * f.x, v.y * f.y, wh[r], wl[r]);
      }
      unsigned ax[4][4], eh[4][4], el[4][4];  // A = x^T, (ea dy)^T
#pragma unroll
      for (int m = 0; m < 4; ++m) {
        if (m >= mq) break;
        a_frag_t(ax[m], xs, 16 * m, k0);
        a_frag_t(eh[m], eyh, 16 * m, k0);
        a_frag_t(el[m], eyl, 16 * m, k0);
      }
#pragma unroll
      for (int m = 0; m < 4; ++m) {
        if (m >= mq) break;
        mma2(own[m][0], own[m][1], ax[m], wh);
        mma2(gown[m][0], gown[m][1], eh[m], cb);
      }
#pragma unroll
      for (int m = 0; m < 4; ++m) {
        if (m >= mq) break;
        mma2(own[m][0], own[m][1], ax[m], wl);
        mma2(gown[m][0], gown[m][1], el[m], cb);
      }
    }
    float* od = sc.st + blk * P * N;
    float* gd = sc.gst + blk * P * N;
#pragma unroll
    for (int m = 0; m < 4; ++m)
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int v = 0; v < 2; ++v) {
          const int row = 16 * m + g + 8 * v;
          if (row >= P) continue;
          const int col = n0 + 8 * nt + 2 * t4;
          store2(od + row * N, col, N, own[m][nt][2 * v],
                 own[m][nt][2 * v + 1]);
          store2(gd + row * N, col, N, gown[m][nt][2 * v],
                 gown[m][nt][2 * v + 1]);
        }
  }
  if (tid == 0) sc.dec[blk] = static_cast<float>(ae);
}

// Pass 3 (bf16): grid (H, nb, Bsz), blocks of Tb tokens, P and N padded
// to at most 64; the relations of the note at the top of this file.
// Warp w owns key rows s of 16 w .. 16 w + 15 in phase A and query rows t
// of the same range in phase B:
//   A. CB^T [s, t] = B[s] . C[t] (exact) and DY.X^T [s, t] = x[s] . dy[t]
//      (dy as hi + lo) over t >= 16 w; in registers L CB^T, L DX^T (DX =
//      dt[s] DY.X) and M^T, masked to s <= t < Tk: M's column sums by
//      quads, its row sums by warp into shared memory, L DX^T to shared
//      memory as hi + lo.  Then dxd = exp(acum[e] - acum[s]) B G^T (G as
//      hi + lo) + (L CB^T) dy (three products: both fp32) with the
//      accumulators of L CB^T as A fragments; dx = dxd dt and dxd . x.
//      dB = exp(acum[e] - acum[s]) dt (x G) (G as hi + lo) + (L DX^T) C,
//      and W from x G;
//   B. dC = exp(acum[t]) dy S_in (three products) + L DX B, L DX read
//      back transposed; and Y0 from dy S_in.
// Then warp 0 takes da, the reverse cumulative sum of dacum, as a warp
// scan (two tokens a lane), and writes ddt and the da_neg partial.
template <int KP, int KN>
__global__ void __launch_bounds__(kThreads) ssd_bwd_block_grads_tc(
    const bf16* __restrict__ x, const float* __restrict__ dt,
    const float* __restrict__ a_neg, const bf16* __restrict__ Bm,
    const bf16* __restrict__ Cm, const float* __restrict__ dy, Scratch sc,
    bf16* __restrict__ dx, float* __restrict__ ddt, int has_init,
    int has_dfinal, int S, int H, int P, int N, int Tb) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* xs = reinterpret_cast<bf16*>(smem_raw);
  bf16* bs = xs + kTile;
  bf16* cs = bs + kTile;
  bf16* dyh = cs + kTile;
  bf16* dyl = dyh + kTile;
  bf16* gh = dyl + kTile;  // G [p][n]
  bf16* gl = gh + kTile;
  bf16* sh = gl + kTile;   // S_in [p][n]
  bf16* sl = sh + kTile;
  bf16* lh = sl + kTile;   // L DX^T [s][t]
  bf16* ll = lh + kTile;
  double* acum = reinterpret_cast<double*>(ll + kTile);
  float* dts = reinterpret_cast<float*>(acum + kBlock);
  float* ea = dts + kBlock;    // exp(acum[t])
  float* ee = ea + kBlock;     // exp(acum[e] - acum[s])
  float* colm = ee + kBlock;   // M's column sums
  float* dxx = colm + kBlock;  // dxd . x
  float* y0 = dxx + kBlock;
  float* wv = y0 + kBlock;
  float* rowp = wv + kBlock;   // [4][64] M's row sums by warp
  float* part = rowp + 4 * kBlock;  // [kThreads]
  const int h = blockIdx.x, k = blockIdx.y, b = blockIdx.z;
  const int nb = gridDim.y, tid = threadIdx.x;
  const int lane = tid & 31, w = tid >> 5, g = lane >> 2, t4 = lane & 3;
  const int Tk = min(Tb, S - k * Tb);
  const int nkP = KP ? KP : pad16(P) / 16, nkN = KN ? KN : pad16(N) / 16;
  const float an = a_neg[h];
  const size_t row0 = static_cast<size_t>(b) * S + static_cast<size_t>(k) * Tb;
  const size_t blk = (static_cast<size_t>(b) * nb + k) * H + h;
  // S_in is zero in the first block without an initial state, G in the
  // last without a final-state gradient: their products are skipped
  const bool carried = has_init || k > 0;
  const bool has_g = has_dfinal || k < nb - 1;
  stage(xs, x + (row0 * H + h) * P, static_cast<size_t>(H) * P, Tk, P,
        P % 8 == 0);
  stage(bs, Bm + row0 * N, N, Tk, N, N % 8 == 0);
  stage(cs, Cm + row0 * N, N, Tk, N, N % 8 == 0);
  tc::cp_async_commit();
  {
    // dy, G and S_in: every load issued, then <G, S_in> (this thread's
    // share, in its order) and the hi + lo tiles
    float2 dyv[kPairs], gv[kPairs], sv[kPairs];
    load_pairs(dyv, dy + (row0 * H + h) * P, static_cast<size_t>(H) * P,
               Tk, P);
    load_pairs(gv, sc.gst + blk * P * N, N, P, N);
    load_pairs(sv, sc.st + blk * P * N, N, P, N);
    block_scan(dt, row0, H, h, Tk, an, acum, dts);
    float dot = 0.f;
#pragma unroll
    for (int j = 0; j < kPairs; ++j)
      dot = fmaf(gv[j].y, sv[j].y, fmaf(gv[j].x, sv[j].x, dot));
    part[tid] = dot;
    store_split(dyh, dyl, dyv, P, nullptr);
    store_split(gh, gl, gv, N, nullptr);
    store_split(sh, sl, sv, N, nullptr);
  }
  __syncthreads();
  const int e = Tk - 1;
  if (tid < kBlock) {
    ea[tid] = tid < Tk ? expf(static_cast<float>(acum[tid])) : 0.f;
    ee[tid] = tid < Tk ? exp_diff(acum[e], acum[tid]) : 0.f;
  }
  tc::cp_async_wait<0>();
  __syncthreads();

  const int r0 = 16 * w;          // this warp's rows
  const int ra = r0 + g, rb = ra + 8;  // this thread's two rows
  // ---- phase A: key rows s = r0 .. r0 + 15, query tiles t >= r0
  unsigned ab[4][4], ax[4][4];  // B and x rows as A fragments
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    if (kk < nkN) a_frag(ab[kk], bs, r0, 16 * kk);
    if (kk < nkP) a_frag(ax[kk], xs, r0, 16 * kk);
  }
  float lcb[8][4] = {}, ldx[8][4] = {};
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    if (kk >= nkN) break;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      if (q < w) continue;
      unsigned bf[4];
      b_frag(bf, cs, 16 * q, 16 * kk);
      mma2(lcb[2 * q], lcb[2 * q + 1], ab[kk], bf);
    }
  }
#pragma unroll
  for (int part_ = 0; part_ < 2; ++part_) {  // dy hi, then lo
    const bf16* src = part_ == 0 ? dyh : dyl;
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      if (kk >= nkP) break;
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        if (q < w) continue;
        unsigned bf[4];
        b_frag(bf, src, 16 * q, 16 * kk);
        mma2(ldx[2 * q], ldx[2 * q + 1], ax[kk], bf);
      }
    }
  }
  // L, the mask, DX = dt[s] DY.X, M; M's sums; L DX^T to shared memory
  {
    const double ca = acum[ra], cb = acum[rb];
    const float da_ = dts[ra], db_ = dts[rb];
    float cs_a = 0.f, cs_b = 0.f;  // M's column sums (rows ra, rb of M^T)
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      float col[2] = {0.f, 0.f};
      if (j >= 2 * w) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int s = i < 2 ? ra : rb;
          const int t = 8 * j + 2 * t4 + (i & 1);
          const bool ok = s <= t && t < Tk;
          const float l = ok ? exp_diff(acum[t], i < 2 ? ca : cb) : 0.f;
          const float dxv = (i < 2 ? da_ : db_) * ldx[j][i];
          lcb[j][i] *= l;
          ldx[j][i] = l * dxv;
          const float m = lcb[j][i] * dxv;
          if (i < 2)
            cs_a += m;
          else
            cs_b += m;
          col[i & 1] += m;
        }
        unsigned hi, lo;
        tc::split_bf16(ldx[j][0], ldx[j][1], hi, lo);
        *reinterpret_cast<unsigned*>(lh + ra * LD + 8 * j + 2 * t4) = hi;
        *reinterpret_cast<unsigned*>(ll + ra * LD + 8 * j + 2 * t4) = lo;
        tc::split_bf16(ldx[j][2], ldx[j][3], hi, lo);
        *reinterpret_cast<unsigned*>(lh + rb * LD + 8 * j + 2 * t4) = hi;
        *reinterpret_cast<unsigned*>(ll + rb * LD + 8 * j + 2 * t4) = lo;
      }
      // this warp's share of M's row sums (columns t of M^T), over g
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        float v = col[u];
        v += __shfl_xor_sync(0xffffffffu, v, 4);
        v += __shfl_xor_sync(0xffffffffu, v, 8);
        v += __shfl_xor_sync(0xffffffffu, v, 16);
        if (g == 0) rowp[w * kBlock + 8 * j + 2 * t4 + u] = v;
      }
    }
    cs_a = quad_sum(cs_a);
    cs_b = quad_sum(cs_b);
    if (t4 == 0) {
      colm[ra] = cs_a;
      colm[rb] = cs_b;
    }
  }
  const float eea = ee[ra], eeb = ee[rb];
  // dxd [s][p] = ee[s] B G^T + (L CB^T) dy; dx = dxd dt; dxd . x
  {
    float acc[8][4] = {};
    if (has_g) {
#pragma unroll
      for (int part_ = 0; part_ < 2; ++part_) {
        const bf16* src = part_ == 0 ? gh : gl;
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          if (kk >= nkN) break;
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            if (q >= nkP) break;
            unsigned bf[4];
            b_frag(bf, src, 16 * q, 16 * kk);
            mma2(acc[2 * q], acc[2 * q + 1], ab[kk], bf);
          }
        }
      }
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        acc[j][0] *= eea;
        acc[j][1] *= eea;
        acc[j][2] *= eeb;
        acc[j][3] *= eeb;
      }
    }
#pragma unroll
    for (int kb = 0; kb < 4; ++kb) {
      if (kb < w) continue;
      unsigned ah[4], al[4];
      acc_as_a(lcb[2 * kb], lcb[2 * kb + 1], ah, al);
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        if (q >= nkP) break;
        unsigned bh[4], bl[4];
        b_frag_t(bh, dyh, 16 * q, 16 * kb);
        b_frag_t(bl, dyl, 16 * q, 16 * kb);
        mma2(acc[2 * q], acc[2 * q + 1], ah, bh);
        mma2(acc[2 * q], acc[2 * q + 1], ah, bl);
        mma2(acc[2 * q], acc[2 * q + 1], al, bh);
      }
    }
    float xa = 0.f, xb = 0.f;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int s = i < 2 ? ra : rb;
        const int c = 8 * j + 2 * t4 + (i & 1);
        if (s < Tk && c < P) {
          const size_t off = ((row0 + s) * H + h) * P + c;
          dx[off] = __float2bfloat16(acc[j][i] * dts[s]);
          const float v = acc[j][i] * __bfloat162float(xs[s * LD + c]);
          if (i < 2)
            xa += v;
          else
            xb += v;
        }
      }
    }
    xa = quad_sum(xa);
    xb = quad_sum(xb);
    if (t4 == 0) {
      dxx[ra] = xa;
      dxx[rb] = xb;
    }
  }
  // dB [s][n] = ee[s] dt[s] (x G) + (L DX^T) C; W[s] = ee[s] dt[s] (x G) . B
  {
    float acc[8][4] = {};
    float wa = 0.f, wb = 0.f;
    if (has_g) {
#pragma unroll
      for (int part_ = 0; part_ < 2; ++part_) {
        const bf16* src = part_ == 0 ? gh : gl;
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          if (kk >= nkP) break;
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            if (q >= nkN) break;
            unsigned bf[4];
            b_frag_t(bf, src, 16 * q, 16 * kk);
            mma2(acc[2 * q], acc[2 * q + 1], ax[kk], bf);
          }
        }
      }
      const float fa = eea * dts[ra], fb = eeb * dts[rb];
#pragma unroll
      for (int j = 0; j < 8; ++j) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int s = i < 2 ? ra : rb;
          const int c = 8 * j + 2 * t4 + (i & 1);
          acc[j][i] *= i < 2 ? fa : fb;
          if (c >= N) continue;  // B's tile is not staged past pad16(N)
          const float v = acc[j][i] * __bfloat162float(bs[s * LD + c]);
          if (i < 2)
            wa += v;
          else
            wb += v;
        }
      }
    }
    wa = quad_sum(wa);
    wb = quad_sum(wb);
    if (t4 == 0) {
      wv[ra] = wa;
      wv[rb] = wb;
    }
#pragma unroll
    for (int kb = 0; kb < 4; ++kb) {
      if (kb < w) continue;
      unsigned ah[4], al[4];
      acc_as_a(ldx[2 * kb], ldx[2 * kb + 1], ah, al);
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        if (q >= nkN) break;
        unsigned bf[4];
        b_frag_t(bf, cs, 16 * q, 16 * kb);
        mma2(acc[2 * q], acc[2 * q + 1], ah, bf);
        mma2(acc[2 * q], acc[2 * q + 1], al, bf);
      }
    }
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int v = 0; v < 2; ++v) {
        const int s = v == 0 ? ra : rb;
        if (s < Tk)
          store2(sc.dbp + ((row0 + s) * H + h) * N, 8 * j + 2 * t4, N,
                 acc[j][2 * v], acc[j][2 * v + 1]);
      }
  }
  __syncthreads();  // L DX^T of every warp is in shared memory
  // ---- phase B: query rows t = r0 .. r0 + 15
  {
    float acc[8][4] = {};
    float ya = 0.f, yb = 0.f;
    if (carried) {
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        if (kk >= nkP) break;
        unsigned ah[4], al[4];
        a_frag(ah, dyh, r0, 16 * kk);
        a_frag(al, dyl, r0, 16 * kk);
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          if (q >= nkN) break;
          unsigned bh[4], bl[4];
          b_frag_t(bh, sh, 16 * q, 16 * kk);
          b_frag_t(bl, sl, 16 * q, 16 * kk);
          mma2(acc[2 * q], acc[2 * q + 1], ah, bh);
          mma2(acc[2 * q], acc[2 * q + 1], ah, bl);
          mma2(acc[2 * q], acc[2 * q + 1], al, bh);
        }
      }
      const float fa = ea[ra], fb = ea[rb];
#pragma unroll
      for (int j = 0; j < 8; ++j) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int t = i < 2 ? ra : rb;
          const int c = 8 * j + 2 * t4 + (i & 1);
          acc[j][i] *= i < 2 ? fa : fb;
          if (c >= N) continue;  // C's tile is not staged past pad16(N)
          const float v = acc[j][i] * __bfloat162float(cs[t * LD + c]);
          if (i < 2)
            ya += v;
          else
            yb += v;
        }
      }
    }
    ya = quad_sum(ya);
    yb = quad_sum(yb);
    if (t4 == 0) {
      y0[ra] = ya;
      y0[rb] = yb;
    }
#pragma unroll
    for (int kb = 0; kb < 4; ++kb) {
      if (kb > w) break;
      unsigned ah[4], al[4];
      a_frag_t(ah, lh, r0, 16 * kb);
      a_frag_t(al, ll, r0, 16 * kb);
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        if (q >= nkN) break;
        unsigned bf[4];
        b_frag_t(bf, bs, 16 * q, 16 * kb);
        mma2(acc[2 * q], acc[2 * q + 1], ah, bf);
        mma2(acc[2 * q], acc[2 * q + 1], al, bf);
      }
    }
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int v = 0; v < 2; ++v) {
        const int t = v == 0 ? ra : rb;
        if (t < Tk)
          store2(sc.dcp + ((row0 + t) * H + h) * N, 8 * j + 2 * t4, N,
                 acc[j][2 * v], acc[j][2 * v + 1]);
      }
  }
  __syncthreads();

  if (w == 0) {
    // <G, S_in>, sum W, then dacum of this lane's tokens 2 lane, 2 lane +
    // 1; da = its reverse cumulative sum (a suffix scan over the lanes);
    // ddt and the da_neg partial
    const float gdot = warp_sum(part[lane] + part[lane + 32] +
                                part[lane + 64] + part[lane + 96]);
    const float wsum = warp_sum(wv[lane] + wv[lane + 32]);
    float dac[2];
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const int t = 2 * lane + u;
      float v = 0.f;
      if (t < Tk) {
        const float rowm = rowp[t] + rowp[kBlock + t] +
                           rowp[2 * kBlock + t] + rowp[3 * kBlock + t];
        v = rowm - colm[t] + y0[t] - wv[t];
        if (t == e) v += ea[e] * gdot + wsum;
      }
      dac[u] = v;
    }
    float suf = dac[0] + dac[1];  // the sum over lanes >= this one
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const float o = __shfl_down_sync(0xffffffffu, suf, off);
      if (lane + off < 32) suf += o;
    }
    float after = __shfl_down_sync(0xffffffffu, suf, 1);
    if (lane == 31) after = 0.f;
    const float da1 = after + dac[1], da0 = da1 + dac[0];
    const int t0 = 2 * lane;
    if (t0 < Tk) ddt[(row0 + t0) * H + h] = da0 * an + dxx[t0];
    if (t0 + 1 < Tk) ddt[(row0 + t0 + 1) * H + h] = da1 * an + dxx[t0 + 1];
    const float dan = warp_sum(fmaf(da1, dts[t0 + 1], da0 * dts[t0]));
    if (lane == 0) sc.dap[blk] = dan;
  }
}

}  // namespace tcb

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

// bf16 with P and N up to 64: passes 1 and 3 on the tensor cores; the
// state passing and the reduction as for fp32.
int launch_tc(const void* x, const void* dt, const void* a_neg, const void* B,
              const void* C, const void* init, const void* dy,
              const void* dfinal, void* dx, void* ddt, void* da_neg, void* dB,
              void* dC, void* scratch, int Bsz, int S, int H, int P, int N,
              int Q, cudaStream_t stream) {
  using tc::bf16;
  const bf16* xp = static_cast<const bf16*>(x);
  const float* dtp = static_cast<const float*>(dt);
  const float* ap = static_cast<const float*>(a_neg);
  const bf16* bp = static_cast<const bf16*>(B);
  const bf16* cp = static_cast<const bf16*>(C);
  const float* dyp = static_cast<const float*>(dy);
  const int Tb = Q < kBlock ? Q : kBlock;
  const int nb = (S + Tb - 1) / Tb;
  const Scratch sc(static_cast<float*>(scratch), Bsz, S, H, P, N, Tb);
  const dim3 grid(H, nb, Bsz);

  // p and n of 64 (zamba2's): the products' trip counts known to the
  // compiler, which then unrolls and schedules each pass's loads ahead of
  // its products
  const bool wide = tcb::pad16(P) == 64 && tcb::pad16(N) == 64;
  auto k1 = wide ? tcb::ssd_bwd_block_terms_tc<4>
                 : tcb::ssd_bwd_block_terms_tc<0>;
  cudaError_t err = allow_smem(k1, tcb::terms_smem());
  if (err != cudaSuccess) return static_cast<int>(err);
  k1<<<grid, tcb::kThreads, tcb::terms_smem(), stream>>>(
      xp, dtp, ap, bp, cp, dyp, sc, S, H, P, N, Tb);
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

  auto k3 = wide ? tcb::ssd_bwd_block_grads_tc<4, 4>
                 : tcb::ssd_bwd_block_grads_tc<0, 0>;
  err = allow_smem(k3, tcb::grads_smem());
  if (err != cudaSuccess) return static_cast<int>(err);
  k3<<<grid, tcb::kThreads, tcb::grads_smem(), stream>>>(
      xp, dtp, ap, bp, cp, dyp, sc, static_cast<bf16*>(dx),
      static_cast<float*>(ddt), init != nullptr, dfinal != nullptr, S, H, P,
      N, Tb);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  const size_t total = 2 * static_cast<size_t>(Bsz) * S * N + H;
  const size_t want = (total + kThreads - 1) / kThreads;
  ssd_bwd_reduce<bf16><<<static_cast<unsigned>(want < 4096 ? want : 4096),
                         kThreads, 0, stream>>>(
      sc, static_cast<bf16*>(dB), static_cast<bf16*>(dC),
      static_cast<float*>(da_neg), Bsz, S, H, N, nb);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// The most tokens of a block of the backward (a chunk Q below it is
// one block).
int ssd_scan_bwd_block() { return kBlock; }

// 1 where bf16 x runs passes 1 and 3 on the tensor cores (P and N rounded
// up to 16 at most 64), 0 where it runs the CUDA-core passes.
int ssd_scan_bwd_tensor_cores(int P, int N) { return tcb::fits(P, N); }

// Bytes of dynamic shared memory one CTA of pass 1 or pass 3 takes for
// dtype (0 fp32, 1 bf16), head dim P and state N (-1 for another pass).
int ssd_scan_bwd_smem_bytes(int dtype, int pass, int P, int N) {
  if (dtype == 1 && tcb::fits(P, N))
    return pass == 1 ? tcb::terms_smem() : pass == 3 ? tcb::grads_smem() : -1;
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
// `stream` (bf16 with P, N up to 64: passes 1 and 3 on the tensor cores);
// returns cudaGetLastError() after each launch (the first failure), -1
// for a bad dtype code.
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
      if (tcb::fits(P, N))
        return launch_tc(x, dt, a_neg, B, C, init, dy, dfinal, dx, ddt,
                         da_neg, dB, dC, scratch, Bsz, S, H, P, N, Q, s);
      return launch<__nv_bfloat16>(x, dt, a_neg, B, C, init, dy, dfinal, dx,
                                   ddt, da_neg, dB, dC, scratch, Bsz, S, H,
                                   P, N, Q, s);
    default:
      return -1;
  }
}

// The first version's bf16 path at any P and N: the four passes on the
// CUDA cores (the arguments as above, bf16 only).  The port never calls
// it; chip_smoke.py times it beside ssd_scan_bwd_launch.
int ssd_scan_bwd_launch_cuda_cores(const void* x, const void* dt,
                                   const void* a_neg, const void* B,
                                   const void* C, const void* init,
                                   const void* dy, const void* dfinal,
                                   void* dx, void* ddt, void* da_neg,
                                   void* dB, void* dC, void* scratch, int Bsz,
                                   int S, int H, int P, int N, int Q,
                                   void* stream) {
  return launch<__nv_bfloat16>(x, dt, a_neg, B, C, init, dy, dfinal, dx, ddt,
                               da_neg, dB, dC, scratch, Bsz, S, H, P, N, Q,
                               static_cast<cudaStream_t>(stream));
}

}  // extern "C"
