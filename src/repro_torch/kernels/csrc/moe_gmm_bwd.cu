// Grouped matmul (backward) for Hopper (sm_90a): given the forward's
// operands x [E, C, K], w [E, K, N] and the output's gradient dy
// [E, C, N], all bf16 or all fp32, returns
//   dx[e] = dy[e] w[e]^T   [E, C, K]      dw[e] = x[e]^T dy[e]   [E, K, N]
// with products and sums in fp32, each output rounded once to the
// inputs' type.
//
// Replaces no Pallas kernel: the JAX package trains its MoE layers through
// jnp.einsum (repro/models/moe.py:128-146), which XLA differentiates.  The
// port runs its forward through the grouped-matmul kernel (csrc/moe_gmm.cu),
// whose autograd Function (kernels/moe_gmm.py GroupedMatmul) calls this
// kernel for the three expert contractions of every MoE layer.
//
// What bounds it on an H100: operations, at the training shapes.  A
// granite-moe-1b-a400m gate product at B 8 x S 1024 (E 32, C 2560, K 1024,
// N 512) needs 4 E C K N = 1.72e11 operations (0.17 ms at the bf16 peak)
// over 2 x 168 MB + 34 MB (dy and x read, dx written; w read and dw
// written: 0.13 ms at 3.35 TB/s).  Only wgmma reaches the tensor cores'
// full rate on this card; the first version's mma.sync tiles (fed by
// ldmatrix) stalled at 15 % of the bound.
//
// bf16 with every row on a 16-byte boundary (K and N multiples of 8, the
// bases aligned: every training shape) runs gmm_bwd_wgmma, one launch for
// both outputs:
//   * a persistent grid of one CTA per SM (at most one per output tile)
//     walks a fixed list of [128 x 256] output tiles, every dw tile
//     (expert by expert) and then every dx tile, CTA i taking tiles i, i +
//     grid, ...  The dw tiles come first because each sums all C rows of
//     its expert (40 steps of 64 at C 2560) where a dx tile sums N (8 at N
//     512): the long tiles are dealt out first and the short ones even out
//     the end.  128 x 256 rather than 128 x 128 because the operands come
//     from L2 at (128 + 256) / (128 x 256) bytes a product rather than 2 /
//     128;
//   * warp specialisation: one producer warpgroup, whose registers
//     setmaxnreg lowers to 40 and of which one thread issues the TMA loads
//     (cp.async.bulk.tensor, 128-byte swizzle, from tensor maps built on
//     the host) into a ring of three 48 KB stages, each completing on an
//     mbarrier with its byte count; two consumer warpgroups (setmaxnreg
//     raises them to 232 registers for 128 fp32 accumulators a thread),
//     each owning 64 rows of the tile, run wgmma m64n256k16 from shared
//     memory and release a stage on a second mbarrier once the wgmma that
//     read it has completed (one group kept in flight).  The producer runs
//     ahead into the next tile;
//   * the epilogue goes through shared memory: each consumer writes its
//     rows as bf16 into four 128-byte-swizzled [64 x 64] boxes (the
//     swizzle spreads a fragment's rows over all the banks) and one thread
//     issues a TMA store a box, which proceeds while the warpgroup starts
//     the next tile; the next epilogue first waits until those stores have
//     read the boxes.  Storing bf16 pairs from the accumulators directly
//     (the first design) left the tensor cores idle through every
//     epilogue; overlapped so, the stores cost 0.27 ms against 0.23 ms
//     without them at granite's gate/up shape (scripts/
//     bwd_kernel_variants.py, CUDA events, H100 80GB HBM3 at 700 W).  A
//     fourth stage of the ring gave way to the boxes (227 KB a CTA);
//   * no transposes in memory: the operands are read as they lie.  dx's A
//     is dy [C, N] and its B is w [K, N], both contiguous along the
//     reduction (K-major); dw's A(m, r) = x[r, m] and its B = dy [C, N] are
//     contiguous along M and N (MN-major: wgmma's transpose bits, one
//     64-wide box per 64 of the tile).  A tensor map is 3-D (inner
//     dimension, rows, experts), so a box never crosses into the next
//     expert: TMA fills rows past C, K or N with zeros, which takes ragged
//     shapes (C 8, qwen2-moe's C 688) with no masking in the mainloop, and
//     the stores leave out what lies past the output's edge;
//   * the tensor maps are encoded in the C launch function
//     (cuTensorMapEncodeTiled, reached through cudaGetDriverEntryPoint, so
//     the library needs no -lcuda and build.py's flags stay as they are),
//     from the shapes and pointers alone, with no device sync.
// Rows that TMA cannot describe (a row stride not a multiple of 16 bytes,
// such as K 70 or N 90, or an unaligned base) run gmm_bwd_tiles, the first
// version's mma.sync kernel: [64 x 128] tiles of 2 x 2 warps, 32-deep
// steps through a 3-stage cp.async ring, two launches (dx, then dw).
// kernels/moe_gmm.py bwd_variant names the choice.  The same kernel stays
// reachable for bf16 at any shape through
// grouped_matmul_bwd_launch_mma_sync, which the port never calls: it is
// the yardstick that chip_smoke.py times beside the new kernel.
// fp32 keeps gmm_bwd_f32, the first version's CUDA-core kernel of full
// fp32 FMAs (never TF32): [64 x 64] tiles, 4 x 4 outputs a thread.
// bf16 x bf16 products are exact in fp32, so each variant differs from the
// plain version only in the order of its sums.
// Deterministic, with no atomics: each output tile is owned by one CTA (or
// thread block of the first version), which sums the whole reduction (dw:
// all C rows of its expert) in ascending order, with no split; which CTA
// takes a tile changes nothing in its arithmetic, so two calls give the
// same bits on any card.
// Later work: clusters of two CTAs sharing B by TMA multicast (a third
// less L2 traffic), the ragged tiles of qwen2-moe's shape (C 688 and N
// 1408 fill 90 % of their tiles), and the forward (moe_gmm.cu) on this
// mainloop.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "tc_bf16.cuh"
#include "wgmma_bf16.cuh"

namespace {

using tc::bf16;
constexpr int kThreads = 128;
constexpr int kPad = 8;  // bf16 elements of padding per shared row

// Stages rows [r0, r0 + ROWS) x cols [c0, c0 + COLS) of the row-major
// [nrows, ncols] operand g into s (row stride COLS + kPad), zeros outside
// the operand.  vec: 16-byte cp.async copies (ncols a multiple of 8, g
// 16-byte aligned), the edge zero-filled through the source size; else
// scalar loads and shared stores.
template <int ROWS, int COLS>
__device__ __forceinline__ void stage(bf16* s, const bf16* __restrict__ g,
                                      int nrows, int ncols, int r0, int c0,
                                      bool vec) {
  constexpr int kRuns = COLS / 8;
  for (int i = threadIdx.x; i < ROWS * kRuns; i += kThreads) {
    const int r = i / kRuns, c = (i % kRuns) * 8;
    const int gr = r0 + r, gc = c0 + c;
    bf16* dst = s + r * (COLS + kPad) + c;
    if (vec) {
      const bool in = gr < nrows && gc < ncols;
      tc::cp_async16(dst, in ? g + static_cast<size_t>(gr) * ncols + gc : g,
                     in ? 16 : 0);
    } else {
#pragma unroll
      for (int e = 0; e < 8; ++e)
        dst[e] = (gr < nrows && gc + e < ncols)
                     ? g[static_cast<size_t>(gr) * ncols + gc + e]
                     : __float2bfloat16(0.f);
    }
  }
}

constexpr int BM = 64, BN = 128, BK = 32, WM = 2, WN = 2, STAGES = 3;
constexpr int TM = BM / WM, TN = BN / WN, MF = TM / 16, NF = TN / 8;
// A_T: A stored [R, M] (read transposed); B_T: B stored [N', R].
template <bool A_T, bool B_T>
struct Smem {
  static constexpr int A_ELEMS = A_T ? BK * (BM + kPad) : BM * (BK + kPad);
  static constexpr int B_ELEMS = B_T ? BN * (BK + kPad) : BK * (BN + kPad);
  static constexpr int BYTES = STAGES * (A_ELEMS + B_ELEMS) * 2;
};

// out[e] [M, N'] = A[e] B[e]; A[e] [M, R] row-major, or [R, M] with A_T;
// B[e] [R, N'] row-major, or [N', R] with B_T.  Grid (M / BM, N' / BN, E).
template <bool A_T, bool B_T>
__global__ void __launch_bounds__(kThreads) gmm_bwd_tiles(
    const bf16* __restrict__ a, const bf16* __restrict__ b,
    bf16* __restrict__ out, int M, int R, int N, int vec_a, int vec_b) {
  using S = Smem<A_T, B_T>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* as = reinterpret_cast<bf16*>(smem_raw);
  bf16* bs = as + STAGES * S::A_ELEMS;
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BN, e = blockIdx.z;
  const bf16* ae = a + static_cast<size_t>(e) * M * R;
  const bf16* be = b + static_cast<size_t>(e) * R * N;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int wm = warp / WN, wn = warp % WN;
  const int nt = (R + BK - 1) / BK;
  auto load = [&](int t) {
    const int st = t % STAGES, r0 = t * BK;
    if (A_T)
      stage<BK, BM>(as + st * S::A_ELEMS, ae, R, M, r0, m0, vec_a != 0);
    else
      stage<BM, BK>(as + st * S::A_ELEMS, ae, M, R, m0, r0, vec_a != 0);
    if (B_T)
      stage<BN, BK>(bs + st * S::B_ELEMS, be, N, R, n0, r0, vec_b != 0);
    else
      stage<BK, BN>(bs + st * S::B_ELEMS, be, R, N, r0, n0, vec_b != 0);
  };

  float acc[MF][NF][4] = {};
#pragma unroll
  for (int t = 0; t < STAGES - 1; ++t) {
    if (t < nt) load(t);
    tc::cp_async_commit();
  }
  for (int t = 0; t < nt; ++t) {
    tc::cp_async_wait<STAGES - 2>();
    __syncthreads();  // stage t landed; stage t - 1 is free again
    if (t + STAGES - 1 < nt) load(t + STAGES - 1);
    tc::cp_async_commit();
    const bf16* at = as + (t % STAGES) * S::A_ELEMS;
    const bf16* bt = bs + (t % STAGES) * S::B_ELEMS;
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      unsigned af[MF][4];
#pragma unroll
      for (int mf = 0; mf < MF; ++mf) {
        const int mb = wm * TM + mf * 16;
        if (A_T)  // stored [r][m]: matrices (r, m), (r, m + 8), (r + 8, ..)
          tc::ldsm_x4_trans(
              af[mf], at + (kk * 16 + (lane & 7) + (lane >> 4) * 8) *
                               (BM + kPad) + mb + ((lane >> 3) & 1) * 8);
        else  // stored [m][r]
          tc::ldsm_x4(af[mf], at + (mb + (lane & 15)) * (BK + kPad) +
                                  kk * 16 + (lane >> 4) * 8);
      }
#pragma unroll
      for (int q = 0; q < NF / 2; ++q) {  // two blocks of 8 columns
        const int nb = wn * TN + q * 16;
        unsigned bf[4];
        if (B_T)  // stored [n][r]: b0, b1 of block nb, then of nb + 8
          tc::ldsm_x4(bf, bt + (nb + (lane & 7) + (lane >> 4) * 8) *
                                   (BK + kPad) + kk * 16 +
                          ((lane >> 3) & 1) * 8);
        else  // stored [r][n]
          tc::ldsm_x4_trans(
              bf, bt + (kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) *
                           (BN + kPad) + nb + (lane >> 4) * 8);
#pragma unroll
        for (int mf = 0; mf < MF; ++mf) {
          tc::mma_bf16(acc[mf][2 * q], af[mf], bf[0], bf[1]);
          tc::mma_bf16(acc[mf][2 * q + 1], af[mf], bf[2], bf[3]);
        }
      }
    }
  }
  tc::cp_async_wait<0>();

  const int g = lane >> 2, t4 = lane & 3;
  bf16* oe = out + static_cast<size_t>(e) * M * N;
#pragma unroll
  for (int mf = 0; mf < MF; ++mf)
#pragma unroll
    for (int nf = 0; nf < NF; ++nf)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int m = m0 + wm * TM + mf * 16 + g + (i >> 1) * 8;
        const int n = n0 + wn * TN + nf * 8 + t4 * 2 + (i & 1);
        if (m < M && n < N)
          oe[static_cast<size_t>(m) * N + n] = __float2bfloat16(acc[mf][nf][i]);
      }
}

template <bool A_T, bool B_T>
cudaError_t launch_tiles(const bf16* a, const bf16* b, bf16* out, int E,
                         int M, int R, int N, int vec_a, int vec_b,
                         cudaStream_t stream) {
  constexpr int bytes = Smem<A_T, B_T>::BYTES;
  auto kernel = gmm_bwd_tiles<A_T, B_T>;
  if (bytes > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return err;
  }
  kernel<<<dim3((M + BM - 1) / BM, (N + BN - 1) / BN, E), kThreads, bytes,
           stream>>>(a, b, out, M, R, N, vec_a, vec_b);
  return cudaGetLastError();
}

// ------------------------------------------------ fp32: CUDA-core kernel

constexpr int kF32Threads = 256;
constexpr int FM = 64, FN = 64, FK = 16;

// The same product in fp32 FMAs: A and B tiles staged as [FK][FM] and
// [FK][FN] (reduction-major), each thread a 4 x 4 block of the 64 x 64
// output tile, summed over R in ascending order.
template <bool A_T, bool B_T>
__global__ void __launch_bounds__(kF32Threads) gmm_bwd_f32(
    const float* __restrict__ a, const float* __restrict__ b,
    float* __restrict__ out, int M, int R, int N) {
  __shared__ __align__(16) float as[FK][FM];
  __shared__ __align__(16) float bs[FK][FN];
  const int m0 = blockIdx.x * FM, n0 = blockIdx.y * FN, e = blockIdx.z;
  const float* ae = a + static_cast<size_t>(e) * M * R;
  const float* be = b + static_cast<size_t>(e) * R * N;
  const int tid = threadIdx.x, tm = tid / 16, tn = tid % 16;
  float acc[4][4] = {};
  for (int r0 = 0; r0 < R; r0 += FK) {
    for (int i = tid; i < FK * FM; i += kF32Threads) {
      // A_T reads along m (its rows), else along r
      const int r = A_T ? i / FM : i % FK, m = A_T ? i % FM : i / FK;
      const int gr = r0 + r, gm = m0 + m;
      as[r][m] = (gr < R && gm < M)
                     ? ae[A_T ? static_cast<size_t>(gr) * M + gm
                              : static_cast<size_t>(gm) * R + gr]
                     : 0.f;
    }
    for (int i = tid; i < FK * FN; i += kF32Threads) {
      const int r = B_T ? i % FK : i / FN, n = B_T ? i / FK : i % FN;
      const int gr = r0 + r, gn = n0 + n;
      bs[r][n] = (gr < R && gn < N)
                     ? be[B_T ? static_cast<size_t>(gn) * R + gr
                              : static_cast<size_t>(gr) * N + gn]
                     : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < FK; ++k) {
      const float4 av = *reinterpret_cast<const float4*>(&as[k][4 * tm]);
      const float4 bv = *reinterpret_cast<const float4*>(&bs[k][4 * tn]);
      const float ar[4] = {av.x, av.y, av.z, av.w};
      const float br[4] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(ar[i], br[j], acc[i][j]);
    }
    __syncthreads();
  }
  float* oe = out + static_cast<size_t>(e) * M * N;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = m0 + 4 * tm + i;
    if (m >= M) break;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + 4 * tn + j;
      if (n < N) oe[static_cast<size_t>(m) * N + n] = acc[i][j];
    }
  }
}

template <bool A_T, bool B_T>
cudaError_t launch_f32(const float* a, const float* b, float* out, int E,
                       int M, int R, int N, cudaStream_t stream) {
  gmm_bwd_f32<A_T, B_T><<<dim3((M + FM - 1) / FM, (N + FN - 1) / FN, E),
                          kF32Threads, 0, stream>>>(a, b, out, M, R, N);
  return cudaGetLastError();
}

// ------------------------------- bf16, TMA-aligned rows: wgmma kernel

constexpr int WBM = 128, WBN = 256, WBK = 64, WSTAGES = 3;
constexpr int kWThreads = 384;    // a producer and two consumer warpgroups
constexpr int kConsumers = 256;   // arrivals that free a stage
constexpr int kBox = 64 * WBK * 2;        // 8 KB: a box of 64 x 64
constexpr int kA = WBM * WBK * 2;         // 16 KB: A's share of a stage
constexpr int kStage = kA + WBN * WBK * 2;  // 48 KB: A, then B
constexpr int kOut = 64 * WBN * 2;         // 32 KB: a consumer's rows out
constexpr int kWSmem = WSTAGES * kStage + 2 * kOut + 2 * WSTAGES * 8 + 1024;

__host__ __device__ inline int cdiv(int a, int b) { return (a + b - 1) / b; }

// One output tile: dw[e] (or dx[e]) rows m0 .. m0 + 127, columns n0 .. n0
// + 255, summed over kb steps of 64.
struct Tile {
  int dw, e, m0, n0, kb;
};

// The persistent grid's tile list (kernels/moe_gmm.py bwd_schedule mirrors
// it): every dw tile, expert by expert, rows before columns, then every dx
// tile in the same order.
struct Sched {
  int dw_n, dw_per_e, dw_tiles, dx_n, dx_per_e, kb_dw, kb_dx, total;
  __host__ Sched(int E, int C, int K, int N) {
    dw_n = cdiv(N, WBN);
    dw_per_e = cdiv(K, WBM) * dw_n;
    dw_tiles = E * dw_per_e;
    dx_n = cdiv(K, WBN);
    dx_per_e = cdiv(C, WBM) * dx_n;
    kb_dw = cdiv(C, WBK);
    kb_dx = cdiv(N, WBK);
    total = dw_tiles + E * dx_per_e;
  }
  __device__ Tile at(int t) const {
    const bool is_dw = t < dw_tiles;
    if (!is_dw) t -= dw_tiles;
    const int per_e = is_dw ? dw_per_e : dx_per_e;
    const int ncols = is_dw ? dw_n : dx_n;
    const int q = t % per_e;
    return Tile{is_dw, t / per_e, (q / ncols) * WBM, (q % ncols) * WBN,
                is_dw ? kb_dw : kb_dx};
  }
};

// The consumer warpgroup cw's share (rows 64 cw .. 64 cw + 63) of one
// tile: kb stages of the ring from (stage, phase) on, each four wgmma
// m64n256k16 into acc.  MN: dw's MN-major operands (A in two and B in
// four 64-wide boxes), else dx's K-major ones (A [128 rows][64], B [256
// rows][64]).  A stage is freed once the group after it has been issued
// and it has completed.
template <int MN>
__device__ __forceinline__ void wgmma_tile(float (&acc)[128],
                                           unsigned char* ring,
                                           uint64_t* full, uint64_t* empty,
                                           int cw, int kb, int& stage,
                                           uint32_t& phase) {
  int prev = -1;
  for (int k = 0; k < kb; ++k) {
    wg::mbar_wait(&full[stage], phase);
    const unsigned char* a = ring + stage * kStage + cw * kBox;
    const unsigned char* b = ring + stage * kStage + kA;
    wg::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < WBK / 16; ++kk) {
      // MN-major: 16 reduction rows are two 1024-byte atoms; K-major: 16
      // values are 32 bytes of each 128-byte row
      const int step = MN ? kk * 2048 : kk * 32;
      wg::wgmma_m64n256k16<MN, MN>(
          acc, wg::desc_sw128(a + step, MN ? kBox : 16, 1024),
          wg::desc_sw128(b + step, MN ? kBox : 16, 1024), k > 0 || kk > 0);
    }
    wg::wgmma_commit();
    if (prev >= 0) {
      wg::wgmma_wait<1>();
      wg::mbar_arrive(&empty[prev]);
    }
    prev = stage;
    if (++stage == WSTAGES) {
      stage = 0;
      phase ^= 1;
    }
  }
  wg::wgmma_wait<0>();
  wg::fence_regs(acc);
  wg::mbar_arrive(&empty[prev]);
}

// Grid: min(tiles, SMs) CTAs of kWThreads.  Tensor maps (bf16, 3-D:
// inner, rows, experts; 128-byte swizzle): dy_k over dy [E][C][N] with
// boxes of 64 x 128 (dx's A), w_k over w [E][K][N], 64 x 256 (dx's B);
// x_mn over x [E][C][K], 64 x 64 (dw's A), dy_mn over dy, 64 x 64 (dw's
// B); dx_o over dx [E][C][K] and dw_o over dw [E][K][N], 64 x 64 (the
// outputs).
__global__ void __launch_bounds__(kWThreads, 1) gmm_bwd_wgmma(
    const __grid_constant__ CUtensorMap dy_k,
    const __grid_constant__ CUtensorMap w_k,
    const __grid_constant__ CUtensorMap x_mn,
    const __grid_constant__ CUtensorMap dy_mn,
    const __grid_constant__ CUtensorMap dx_o,
    const __grid_constant__ CUtensorMap dw_o, const Sched sc) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  // the ring's base on a 1024-byte boundary (the swizzle atoms'), then
  // each consumer's output rows, then the barriers
  unsigned char* ring =
      smem_raw + ((1024 - (wg::smem_u32(smem_raw) & 1023)) & 1023);
  unsigned char* outs = ring + WSTAGES * kStage;
  uint64_t* full = reinterpret_cast<uint64_t*>(outs + 2 * kOut);
  uint64_t* empty = full + WSTAGES;
  if (threadIdx.x == 0) {
    for (int s = 0; s < WSTAGES; ++s) {
      wg::mbar_init(&full[s], 1);
      wg::mbar_init(&empty[s], kConsumers);
    }
    wg::mbar_init_fence();
  }
  __syncthreads();
  const int group = threadIdx.x / 128;
  if (group == 0) {  // the producer
    wg::setmaxnreg_dec<40>();
    if (threadIdx.x != 0) return;
    int stage = 0;
    uint32_t phase = 0;
    for (int t = blockIdx.x; t < sc.total; t += gridDim.x) {
      const Tile tl = sc.at(t);
      for (int k = 0; k < tl.kb; ++k) {
        wg::mbar_wait(&empty[stage], phase ^ 1);
        uint64_t* bar = &full[stage];
        wg::mbar_expect_tx(bar, kStage);
        unsigned char* a = ring + stage * kStage;
        unsigned char* b = a + kA;
        const int r0 = k * WBK;
        if (tl.dw) {  // x rows r0.. as [r][m], dy rows r0.. as [r][n]
          for (int j = 0; j < WBM / 64; ++j)
            wg::tma_load_3d(a + j * kBox, &x_mn, bar, tl.m0 + 64 * j, r0,
                            tl.e);
          for (int j = 0; j < WBN / 64; ++j)
            wg::tma_load_3d(b + j * kBox, &dy_mn, bar, tl.n0 + 64 * j, r0,
                            tl.e);
        } else {  // dy rows m0.. and w rows n0.., columns r0..
          wg::tma_load_3d(a, &dy_k, bar, r0, tl.m0, tl.e);
          wg::tma_load_3d(b, &w_k, bar, r0, tl.n0, tl.e);
        }
        if (++stage == WSTAGES) {
          stage = 0;
          phase ^= 1;
        }
      }
    }
  } else {  // a consumer: rows 64 cw .. 64 cw + 63 of every tile
    wg::setmaxnreg_inc<232>();
    const int cw = group - 1;
    const int lane = threadIdx.x & 31, g = lane >> 2, t4 = lane & 3;
    const int row = 16 * ((threadIdx.x / 32) & 3) + g;  // and row + 8
    const bool leader = threadIdx.x % 128 == 0;
    unsigned char* out = outs + cw * kOut;  // four boxes of [64][64] bf16
    int stage = 0;
    uint32_t phase = 0;
    float acc[128];
    for (int t = blockIdx.x; t < sc.total; t += gridDim.x) {
      const Tile tl = sc.at(t);
      if (tl.dw)
        wgmma_tile<1>(acc, ring, full, empty, cw, tl.kb, stage, phase);
      else
        wgmma_tile<0>(acc, ring, full, empty, cw, tl.kb, stage, phase);
      // the rows as bf16 into the 128-byte-swizzled boxes once the last
      // tile's store has read them, then one TMA store a box (the edges
      // past C, K or N are not written)
      if (leader) wg::bulk_wait_read<0>();
      wg::named_sync(1 + cw, 128);
#pragma unroll
      for (int j = 0; j < WBN / 8; ++j)
#pragma unroll
        for (int v = 0; v < 2; ++v) {
          const int r = row + 8 * v;
          *reinterpret_cast<unsigned*>(
              out + (j / 8) * kBox + r * 128 + (((j & 7) ^ g) << 4) +
              4 * t4) = tc::pack_bf16(acc[4 * j + 2 * v],
                                      acc[4 * j + 2 * v + 1]);
        }
      wg::fence_proxy_async();
      wg::named_sync(1 + cw, 128);
      if (leader) {
        const CUtensorMap* map = tl.dw ? &dw_o : &dx_o;
        for (int q = 0; q < WBN / 64; ++q)
          wg::tma_store_3d(map, out + q * kBox, tl.n0 + 64 * q,
                           tl.m0 + 64 * cw, tl.e);
        wg::bulk_commit();
      }
    }
    if (leader) wg::bulk_wait<0>();
  }
}

// cuTensorMapEncodeTiled from the driver, found once through the runtime
// (no -lcuda at link time); nullptr where the driver lacks it.
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static const EncodeTiled fn = []() -> EncodeTiled {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err != cudaSuccess || found != cudaDriverEntryPointSuccess)
      return nullptr;
    return reinterpret_cast<EncodeTiled>(p);
  }();
  return fn;
}

// A bf16 tensor [E][rows][inner] (contiguous, inner a multiple of 8, base
// 16-byte aligned) as a 3-D map of boxes box_inner x box_rows x 1, 128-byte
// swizzle, zeros out of bounds.  Returns 0, or the driver's error code.
int tensor_map(CUtensorMap* map, const void* base, int E, int rows,
               int inner, int box_inner, int box_rows) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return static_cast<int>(CUDA_ERROR_NOT_FOUND);
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(inner),
                              static_cast<cuuint64_t>(rows),
                              static_cast<cuuint64_t>(E)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(inner) * 2,
                                 static_cast<cuuint64_t>(rows) * inner * 2};
  const cuuint32_t box[3] = {static_cast<cuuint32_t>(box_inner),
                             static_cast<cuuint32_t>(box_rows), 1};
  const cuuint32_t unit[3] = {1, 1, 1};
  return static_cast<int>(fn(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(base), dims,
      strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE));
}

// Driver errors come back offset, apart from the runtime's.
constexpr int kDriverError = 100000;

int launch_wgmma(const bf16* x, const bf16* w, const bf16* dy, bf16* dx,
                 bf16* dw, int E, int C, int K, int N, int sms,
                 cudaStream_t stream) {
  CUtensorMap dy_k, w_k, x_mn, dy_mn, dx_o, dw_o;
  int err = tensor_map(&dy_k, dy, E, C, N, 64, WBM);
  if (err == 0) err = tensor_map(&w_k, w, E, K, N, 64, WBN);
  if (err == 0) err = tensor_map(&x_mn, x, E, C, K, 64, WBK);
  if (err == 0) err = tensor_map(&dy_mn, dy, E, C, N, 64, WBK);
  if (err == 0) err = tensor_map(&dx_o, dx, E, C, K, 64, 64);
  if (err == 0) err = tensor_map(&dw_o, dw, E, K, N, 64, 64);
  if (err != 0) return kDriverError + err;
  // setmaxnreg.inc waits for registers the producer releases: the
  // consumers' 2 x 128 x (232 - r) must fit in its 128 x (r - 40), so the
  // kernel must start with r >= 168 registers a thread (it does, built
  // with __launch_bounds__(384, 1)); a build with fewer is refused here
  // rather than left to hang
  static const int regs = [] {
    cudaFuncAttributes a;
    return cudaFuncGetAttributes(&a, gmm_bwd_wgmma) == cudaSuccess
               ? a.numRegs
               : 0;
  }();
  if (regs < 168) return static_cast<int>(cudaErrorLaunchOutOfResources);
  const Sched sc(E, C, K, N);
  const cudaError_t attr = cudaFuncSetAttribute(
      gmm_bwd_wgmma, cudaFuncAttributeMaxDynamicSharedMemorySize, kWSmem);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const int grid = sc.total < sms ? sc.total : sms;
  gmm_bwd_wgmma<<<grid, kWThreads, kWSmem, stream>>>(dy_k, w_k, x_mn, dy_mn,
                                                     dx_o, dw_o, sc);
  return static_cast<int>(cudaGetLastError());
}

// The mma.sync tiles: dx [C, K] = dy [C, N] . (w [K, N])^T, then dw [K,
// N] = (x [C, K])^T . dy [C, N].
int launch_mma_sync(const bf16* x, const bf16* w, const bf16* dy, bf16* dx,
                    bf16* dw, int E, int C, int K, int N, int vec_x,
                    int vec_w, int vec_dy, cudaStream_t stream) {
  const cudaError_t err = launch_tiles<false, true>(dy, w, dx, E, C, N, K,
                                                    vec_dy, vec_w, stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(launch_tiles<true, false>(x, dy, dw, E, K, C, N,
                                                    vec_x, vec_dy, stream));
}

}  // namespace

extern "C" {

// dtype: 0 fp32, 1 bf16 (x, w, dy, dx and dw alike).  x [E, C, K], w
// [E, K, N], dy [E, C, N], dx [E, C, K], dw [E, K, N], contiguous; vec_*:
// 1 when every row of that operand starts on a 16-byte boundary (its row
// length a multiple of 8 elements and an aligned base; bf16 only); sms:
// the card's SMs (the persistent grid's size at most).  E, C, K and N must
// be > 0.  bf16 with all three operands' rows aligned: one kernel
// (gmm_bwd_wgmma); other bf16 and fp32: two (dx, then dw).  Returns 0,
// cudaGetLastError() after a launch (the first failure), 100000 + the
// driver's error where a tensor map cannot be encoded, -1 for a bad dtype
// code.
int grouped_matmul_bwd_launch(int dtype, const void* x, const void* w,
                              const void* dy, void* dx, void* dw, int E,
                              int C, int K, int N, int vec_x, int vec_w,
                              int vec_dy, int sms, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: {
      const float* xf = static_cast<const float*>(x);
      const float* wf = static_cast<const float*>(w);
      const float* dyf = static_cast<const float*>(dy);
      const cudaError_t err = launch_f32<false, true>(
          dyf, wf, static_cast<float*>(dx), E, C, N, K, s);
      if (err != cudaSuccess) return static_cast<int>(err);
      return static_cast<int>(launch_f32<true, false>(
          xf, dyf, static_cast<float*>(dw), E, K, C, N, s));
    }
    case 1: {
      const bf16* xb = static_cast<const bf16*>(x);
      const bf16* wb = static_cast<const bf16*>(w);
      const bf16* dyb = static_cast<const bf16*>(dy);
      if (vec_x && vec_w && vec_dy)
        return launch_wgmma(xb, wb, dyb, static_cast<bf16*>(dx),
                            static_cast<bf16*>(dw), E, C, K, N, sms, s);
      return launch_mma_sync(xb, wb, dyb, static_cast<bf16*>(dx),
                             static_cast<bf16*>(dw), E, C, K, N, vec_x,
                             vec_w, vec_dy, s);
    }
    default:
      return -1;
  }
}

// The first version's bf16 path at any shape: the mma.sync tiles, two
// kernels (the arguments as above, bf16 only).  The port never calls it;
// chip_smoke.py times it beside grouped_matmul_bwd_launch.
int grouped_matmul_bwd_launch_mma_sync(const void* x, const void* w,
                                       const void* dy, void* dx, void* dw,
                                       int E, int C, int K, int N, int vec_x,
                                       int vec_w, int vec_dy, void* stream) {
  return launch_mma_sync(
      static_cast<const bf16*>(x), static_cast<const bf16*>(w),
      static_cast<const bf16*>(dy), static_cast<bf16*>(dx),
      static_cast<bf16*>(dw), E, C, K, N, vec_x, vec_w, vec_dy,
      static_cast<cudaStream_t>(stream));
}

}  // extern "C"
