// Dense product for Hopper (sm_90a), column-stable by construction:
//   out = x @ w      x [M, K], w [K, N] -> out [M, N]
// with x and w both bf16 or both fp32, products and sums in fp32 and out
// in x's type.
//
// Replaces no Pallas kernel.  The JAX package computes its projections
// with jnp (repro/models/lm.py:121-137, 289-291, 303-315; moe.py:160-166),
// which XLA lowers to a dot; its tensor-parallel guarantee (a sharded
// engine emits the unsharded engine's tokens bit for bit) rests on XLA's
// dot giving column-sliceable results: a product over a column shard of
// w equals those columns of the unsharded product.  cuBLAS picks its
// kernel by shape and does not (on an H100, 46 of chip_smoke.py phase
// 9h's 60 bf16 shard products matched, 24 of 60 in fp32).  This kernel is
// added so that the port keeps the JAX contract: the port calls it for every
// projection whose weight tensor parallelism cuts by columns (q, k, v and
// the attention output, the MLP's and the shared expert's three, whisper's
// encoder, decoder and cross-attention projections).
//
// The contract.  The arithmetic of each output element depends only on
// the launch plan (kernels/dense_matmul.py plan: the variant, the tile
// width, the K split, from (dtype, M, K, plan_n) and the SM count) and on
// that element's row of x and column of w, never on where the column lies
// in the tile or on how many columns there are.  So for every width tp
// that divides N,
//   dense_matmul(x, w[:, r N/tp : (r+1) N/tp], plan_n=N)
//     == dense_matmul(x, w)[:, r N/tp : (r+1) N/tp]          bit for bit.
// Each element is summed over K in ascending order: 16-deep blocks inside
// the tensor-core instruction (the same instruction at every column), the
// blocks in order, and where the plan splits K, each split's fp32 partial
// summed in split order (split 0's, plus split 1's, ...) by the last CTA
// of the output tile to arrive, which an int32 arrival counter elects
// (the counter elects and sums nothing).  No atomics in the sums: two
// calls give the same bits on any card.
//
// What bounds it on an H100: bytes at a decode tick, a verify pass or a
// chunk (M <= 64: each weight element is read once for 2 M flops, under
// the ~295 flops a byte at which the bf16 tensor cores take over), and
// operations at prompt and training rows (llama3.2-3b's w_gate at M 8192:
// 4.1e11 flops against 64 MB).  One launch a call.  The variants, chosen
// by the plan:
//   * bf16, M <= 64 (and bf16 rows that TMA cannot describe at any M):
//     mma.sync tiles (tc_bf16.cuh) of out^T = w^T x^T, so that 16 columns
//     of N fill the mma's 16 rows and the tokens its 8 columns (8, 16, 32
//     or 64 rows of x a CTA, by M), instead of padding M to 16.  A CTA of
//     4 warps owns 64 or 128 columns (16 a warp in each 64) and streams
//     w in [64 k][64 n] TMA boxes (w's tensor map; 128-byte swizzle, read
//     back by ldmatrix.trans at the swizzled address) through a ring of
//     4-11 stages with an mbarrier each, two CTAs an SM; w rows TMA
//     cannot describe are staged by scalar loads into the same layout, so
//     the same products.  x comes by cp.async.  The width and K split are
//     the plan's: a lone CTA streams w well under an SM's share of the
//     card's bandwidth, the more so the narrower its rows;
//   * bf16, M > 64, rows 16-byte aligned (prompts, training): a
//     persistent wgmma + TMA mainloop (wgmma_bf16.cuh; the grouped-matmul
//     backward's): one CTA an SM walks work units (an output tile and a
//     split of K) of [128 x 256] tiles (wgmma m64n256k16, 3 stages of
//     48 KB, never split: their 128 accumulators a thread leave no room
//     for the sum) or [128 x 128] tiles (m64n128k16, 6 stages of 32 KB,
//     split or not), the width and split from the plan; a producer
//     warpgroup issues the TMA loads of x (K-major, [128 rows][64]) and w
//     (read as it lies, [K, N] row-major: MN-major, [64 k][64 n] boxes)
//     into the ring; two consumer warpgroups run the unit's K steps in
//     order; the epilogue goes through swizzled shared boxes and TMA
//     stores (the ragged edge zero-filled by the loads and left unwritten
//     by the stores);
//   * fp32, any M: CUDA-core FMAs, never TF32, [32 x 64] tiles, K walked
//     in 32-deep steps in order, split under the mma.sync tiles' rule.
// A split K: each split CTA writes its fp32 partial, and the tile's last
// CTA to arrive sums them (split_sum).  w's tensor map is encoded once for
// each (pointer, K, N); x's and out's are encoded each wgmma call.
// Operands are read in place (a layer's view of a stacked [L, K, N] leaf),
// with no padded copy.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <mutex>

#include "tc_bf16.cuh"
#include "wgmma_bf16.cuh"

// One call's launch, prepared once for a (dtype, shapes, alignment) by
// kernels/dense_matmul.py (its _Launch, field for field).
struct DenseLaunch {
  int dtype;    // 0 fp32, 1 bf16 (x, w and out alike)
  int variant;  // kernels/dense_matmul.py VARIANTS
  int rows8;    // mma.sync: rows of x a CTA in blocks of 8 (1, 2, 4, 8)
  int width;    // columns a tile: 64, or the wgmma kernel's 128 or 256
  int M, K, N;  // x [M, K], w [K, N] (a shard's N), out [M, N]
  int vec_x, vec_w;  // 1: every row of x / w starts 16-byte aligned
  int splits, kt_per;  // K splits, K steps a split
  int sms;             // the wgmma kernel's persistent grid at most
  float* work;         // splits > 1: the splits' fp32 partials
  int* arrived;        // splits > 1: a zeroed counter a tile
};

namespace {

using tc::bf16;
constexpr int kThreads = 128;
constexpr int kDriverError = 100000;  // + the driver's errors
constexpr int kPad = 8;  // bf16 elements of padding per shared row

// The variant codes of kernels/dense_matmul.py VARIANTS.
enum Variant { kF32 = 0, kMmaSync = 1, kWgmma = 2 };

// atomicAdd(p, 1) with acquire-release semantics at GPU scope.
__device__ __forceinline__ int arrive_acq_rel(int* p) {
  int old;
  asm volatile("atom.acq_rel.gpu.global.add.s32 %0, [%1], 1;\n"
               : "=r"(old)
               : "l"(p)
               : "memory");
  return old;
}

// A split of K's end of a tile, for the n threads that hold its
// accumulators (R values each, R a multiple of 4; thread t of them):
// writes this split's fp32 partial, in the threads' own order (float4 j
// of thread t of split q at ((tile * splits + q) * R / 4 + j) * n + t, so
// each float4 store and load is coalesced), then counts the split's
// arrival.  The last split of the tile to arrive sums every split's
// partial in split order into acc (split 0's, plus split 1's, ...; its own
// read back like the others), resets the tile's counter for the next call
// and returns true; the others return false.  The sums' loads go out B
// float4 at a time before their adds (a few L2 round trips a tile, not
// one a split).  sync(): a barrier of the n threads;
// flag: a shared int.
template <int R, int B = 8, typename Sync>
__device__ __forceinline__ bool split_sum(float* acc, float* work,
                                          int* arrived, int* flag, int tile,
                                          int sp, int splits, int n, int t,
                                          Sync sync) {
  constexpr int J = R / 4;  // float4 a thread a split
  const float4* base = reinterpret_cast<const float4*>(work) +
                       static_cast<size_t>(tile) * splits * J * n + t;
  float4* mine = reinterpret_cast<float4*>(work) +
                 (static_cast<size_t>(tile) * splits + sp) * J * n + t;
#pragma unroll
  for (int j = 0; j < J; ++j)
    __stcg(mine + j * n, make_float4(acc[4 * j], acc[4 * j + 1],
                                     acc[4 * j + 2], acc[4 * j + 3]));
  // the threads' stores, then one acquire-release arrival at GPU scope:
  // it releases them to the tile's last CTA and, there, acquires the
  // others' (the barriers carry both to the other threads)
  sync();
  if (t == 0) *flag = arrive_acq_rel(arrived + tile) == splits - 1;
  sync();
  if (!*flag) return false;
  auto add = [&](int j, float4 v) {
    acc[4 * j] += v.x;
    acc[4 * j + 1] += v.y;
    acc[4 * j + 2] += v.z;
    acc[4 * j + 3] += v.w;
  };
#pragma unroll
  for (int j = 0; j < J; ++j) {  // split 0's partial as it is
    const float4 v = __ldcg(base + j * n);
    acc[4 * j] = v.x;
    acc[4 * j + 1] = v.y;
    acc[4 * j + 2] = v.z;
    acc[4 * j + 3] = v.w;
  }
  if constexpr (J <= B) {  // B / J splits' partials a round
    constexpr int U = B / J;
    for (int q0 = 1; q0 < splits; q0 += U) {
      float4 v[U][J];
#pragma unroll
      for (int u = 0; u < U; ++u)
#pragma unroll
        for (int j = 0; j < J; ++j)
          if (q0 + u < splits)
            v[u][j] = __ldcg(base + (static_cast<size_t>(q0 + u) * J + j) * n);
#pragma unroll
      for (int u = 0; u < U; ++u)
#pragma unroll
        for (int j = 0; j < J; ++j)
          if (q0 + u < splits) add(j, v[u][j]);
    }
  } else {  // a split's partial in rounds of B float4
    static_assert(J % B == 0, "whole rounds");
    for (int q = 1; q < splits; ++q)
#pragma unroll
      for (int j0 = 0; j0 < J; j0 += B) {
        float4 v[B];
#pragma unroll
        for (int c = 0; c < B; ++c)
          v[c] = __ldcg(base + (static_cast<size_t>(q) * J + j0 + c) * n);
#pragma unroll
        for (int c = 0; c < B; ++c) add(j0 + c, v[c]);
      }
  }
  if (t == 0) arrived[tile] = 0;
  return true;
}

// ------------------------------------------------ fp32: CUDA-core kernel

constexpr int kF32M = 32;  // rows of x per CTA
constexpr int kF32N = 64;  // output columns per CTA
constexpr int kF32K = 32;  // depth staged per step
constexpr int kRun = 8;    // consecutive elements one thread loads
constexpr int kWRuns = kF32K * kF32N / kRun / kThreads;  // 2 per thread
static_assert(kF32M * kF32K / kRun == kThreads, "one x run per thread");

// kRun consecutive floats from src, of which the first n lie inside the
// tensor (zeros past them); with vec, a whole run is two 16-byte loads.
__device__ __forceinline__ void load_run(const float* src, int n, bool vec,
                                         float* dst) {
  if (vec && n >= kRun) {
    const float4 a = *reinterpret_cast<const float4*>(src);
    const float4 b = *reinterpret_cast<const float4*>(src + 4);
    dst[0] = a.x; dst[1] = a.y; dst[2] = a.z; dst[3] = a.w;
    dst[4] = b.x; dst[5] = b.y; dst[6] = b.z; dst[7] = b.w;
    return;
  }
#pragma unroll
  for (int i = 0; i < kRun; ++i) dst[i] = i < n ? src[i] : 0.f;
}

// Grid (N / 64, M / 32, splits); split sp walks K steps kt0 .. kt0 +
// kt_per - 1 (the last split fewer), each thread a 4 x 4 block.
__global__ void __launch_bounds__(kThreads, 4) dense_f32(
    const float* __restrict__ x, const float* __restrict__ w,
    float* __restrict__ out, float* work, int* arrived, int M, int K, int N,
    int vec_x, int vec_w, int splits, int kt_per) {
  // x tile transposed (xs[k][m]) so a thread reads its 4 rows as one
  // float4; w tile as it lies (ws[k][n])
  __shared__ __align__(16) float xs[kF32K][kF32M];
  __shared__ __align__(16) float ws[kF32K][kF32N];
  __shared__ int last;
  const int n0 = blockIdx.x * kF32N, m0 = blockIdx.y * kF32M;
  const int sp = blockIdx.z;
  const int kt0 = sp * kt_per;
  const int nt = min((K + kF32K - 1) / kF32K - kt0, kt_per);
  const int tid = threadIdx.x;
  const int tm = tid / 16;  // rows m0 + 4 tm .. + 3
  const int tn = tid % 16;  // columns n0 + 4 tn .. + 3
  // this thread's x run: row xm, depth xk .. xk + 7 of the tile
  const int xm = tid / (kF32K / kRun);
  const int xk = (tid % (kF32K / kRun)) * kRun;
  float xr[kRun], wr[kWRuns][kRun];

  auto load = [&](int k0) {
    const int m = m0 + xm, k = k0 + xk;
    const int nx = (m < M) ? K - k : 0;
    load_run(x + static_cast<size_t>(m < M ? m : 0) * K + k, nx, vec_x != 0,
             xr);
#pragma unroll
    for (int j = 0; j < kWRuns; ++j) {
      const int i = tid + j * kThreads;
      const int kk = k0 + i / (kF32N / kRun);
      const int nn = n0 + (i % (kF32N / kRun)) * kRun;
      const int nw = (kk < K) ? N - nn : 0;
      load_run(w + static_cast<size_t>(kk < K ? kk : 0) * N + nn, nw,
               vec_w != 0, wr[j]);
    }
  };

  float acc[16] = {};  // rows 4 tm + r, columns 4 tn + c at 4 r + c
  const bool active = m0 + 4 * tm < M;

  if (nt > 0) load(kt0 * kF32K);
  for (int t = 0; t < nt; ++t) {
    const int k0 = (kt0 + t) * kF32K;
#pragma unroll
    for (int i = 0; i < kRun; ++i) xs[xk + i][xm] = xr[i];
#pragma unroll
    for (int j = 0; j < kWRuns; ++j) {
      const int i = tid + j * kThreads;
      float* dst = &ws[i / (kF32N / kRun)][(i % (kF32N / kRun)) * kRun];
      *reinterpret_cast<float4*>(dst) =
          make_float4(wr[j][0], wr[j][1], wr[j][2], wr[j][3]);
      *reinterpret_cast<float4*>(dst + 4) =
          make_float4(wr[j][4], wr[j][5], wr[j][6], wr[j][7]);
    }
    __syncthreads();
    if (t + 1 < nt) load(k0 + kF32K);  // in flight during the FMAs
    if (active) {
#pragma unroll 8
      for (int k = 0; k < kF32K; ++k) {
        const float4 a = *reinterpret_cast<const float4*>(&xs[k][4 * tm]);
        const float4 b = *reinterpret_cast<const float4*>(&ws[k][4 * tn]);
        const float av[4] = {a.x, a.y, a.z, a.w};
        const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int c = 0; c < 4; ++c)
            acc[4 * r + c] = fmaf(av[r], bv[c], acc[4 * r + c]);
      }
    }
    __syncthreads();  // the tiles are overwritten by the next step
  }

  if (splits > 1 &&
      !split_sum<16, 4>(acc, work, arrived, &last,
                     blockIdx.y * gridDim.x + blockIdx.x, sp, splits,
                     kThreads, tid, [] { __syncthreads(); }))
    return;
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int m = m0 + 4 * tm + r;
    if (m >= M) break;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + 4 * tn + j;
      if (n < N) out[static_cast<size_t>(m) * N + n] = acc[4 * r + j];
    }
  }
}

// ------------------------------------ bf16, M <= 64: mma.sync tiles

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

// A bf16 matrix [rows][inner] (contiguous, inner a multiple of 8, base
// 16-byte aligned) as a 3-D map of boxes box_inner x box_rows x 1, 128-byte
// swizzle, zeros out of bounds.  Returns 0, or the driver's error code.
int tensor_map(CUtensorMap* map, const void* base, int rows, int inner,
               int box_inner, int box_rows) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return static_cast<int>(CUDA_ERROR_NOT_FOUND);
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(inner),
                              static_cast<cuuint64_t>(rows), 1};
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

// The weights' maps, encoded once for each (pointer, K, N): a map of the
// same base, dimensions and strides is the same map, whatever tensor lies
// there now.  Direct-mapped; a collision re-encodes.
struct WeightMap {
  const void* base = nullptr;
  int K = 0, N = 0;
  CUtensorMap map;
};
constexpr int kWeightMaps = 1024;
WeightMap weight_maps[kWeightMaps];
std::mutex weight_maps_mu;

// w [K][N]'s map (boxes of [64 k][64 n], the mma.sync tiles' and the
// wgmma kernel's) into *map; returns 0 or the driver's error code.
int weight_map(CUtensorMap* map, const void* w, int K, int N) {
  const uintptr_t p = reinterpret_cast<uintptr_t>(w);
  const size_t slot =
      ((p >> 8) ^ (static_cast<size_t>(K) * 131 + N)) % kWeightMaps;
  std::lock_guard<std::mutex> lock(weight_maps_mu);
  WeightMap& e = weight_maps[slot];
  if (e.base != w || e.K != K || e.N != N) {
    const int err = tensor_map(&e.map, w, K, N, 64, 64);
    if (err != 0) {
      e.base = nullptr;
      return err;
    }
    e.base = w;
    e.K = K;
    e.N = N;
  }
  *map = e.map;
  return 0;
}

constexpr int kSmallBK = 64;
constexpr int kWBox = kSmallBK * 64 * 2;  // 8 KB: w's [64 k][64 n] box

// The ring at 8 NB8 rows of x and 64 H columns: each stage w's H boxes
// of [64 k][64 n] (by TMA, 128-byte swizzled), x's [8 NB8][64 k] (by
// cp.async, rows padded) and an mbarrier; as many stages as fit 110,592
// bytes with the alignment's slack (4-11), so that two CTAs share an SM.
template <int NB8, int H>
constexpr int kSmallStageBytes =
    H * kWBox + 8 * NB8 * (kSmallBK + kPad) * 2 + 8;
template <int NB8, int H>
constexpr int kSmallStages = (110592 - 1024) / kSmallStageBytes<NB8, H>;
template <int NB8, int H>
constexpr int kSmallSmem =
    kSmallStages<NB8, H> * kSmallStageBytes<NB8, H> + 1024;

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

// The byte offset of w's (k, n) 16-byte chunk (n a multiple of 8) in a
// stage: a box of [64 k][64 n] a 64 columns, rows of 128 bytes, chunk c
// of row k at c ^ (k % 8), as the TMA box lands with the 128-byte
// swizzle.
__device__ __forceinline__ int wtile_at(int k, int n) {
  return (n >> 6) * kWBox + k * 128 + ((((n & 63) >> 3) ^ (k & 7)) << 4);
}

// w's [64 k][64 H n] tile at (k0, n0) into the swizzled stage s with
// scalar loads (rows TMA cannot describe), zeros outside w: the same
// layout, so the same products, as the TMA boxes.
template <int H>
__device__ __forceinline__ void stage_w_scalar(unsigned char* s,
                                               const bf16* __restrict__ w,
                                               int K, int N, int k0, int n0) {
  for (int i = threadIdx.x; i < kSmallBK * 8 * H; i += kThreads) {
    const int r = i / (8 * H), c = (i % (8 * H)) * 8;
    bf16* dst = reinterpret_cast<bf16*>(s + wtile_at(r, c));
    const int gk = k0 + r;
#pragma unroll
    for (int e = 0; e < 8; ++e)
      dst[e] = (gk < K && n0 + c + e < N)
                   ? w[static_cast<size_t>(gk) * N + n0 + c + e]
                   : __float2bfloat16(0.f);
  }
}

// out^T [n, m] = w^T x^T over 8 NB8 rows of x and 64 H columns a CTA.
// Grid (N / 64 H, M / (8 NB8), splits); warp w owns columns n0 + 64 h +
// 16 w .. + 15 for h < H, each an A fragment (16 n x 16 k of w^T, one
// ldmatrix.trans) reused over NB8 blocks of 8 rows.  w streams through
// the ring by TMA (w_map; one thread issues a stage's H boxes, an
// mbarrier a stage reports them landed) where vec_w, else by scalar
// loads into the same layout; x by cp.async.
template <int NB8, int H>
__global__ void __launch_bounds__(kThreads, 2) dense_mma_sync(
    const __grid_constant__ CUtensorMap w_map, const bf16* __restrict__ x,
    const bf16* __restrict__ w, bf16* __restrict__ out, float* work,
    int* arrived, int M, int K, int N, int vec_x, int vec_w, int splits,
    int kt_per) {
  constexpr int TM = 8 * NB8, BN = 64 * H, BK = kSmallBK;
  constexpr int STAGES = kSmallStages<NB8, H>;
  constexpr int kWStage = H * kWBox;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ int last;
  // w's stages on a 1024-byte boundary (the swizzle atoms'), then x's,
  // then the barriers
  unsigned char* ws =
      smem_raw + ((1024 - (wg::smem_u32(smem_raw) & 1023)) & 1023);
  auto xs = reinterpret_cast<bf16(*)[TM][BK + kPad]>(ws + STAGES * kWStage);
  uint64_t* full = reinterpret_cast<uint64_t*>(
      ws + STAGES * (kWStage + TM * (BK + kPad) * 2));
  const int n0 = blockIdx.x * BN, m0 = blockIdx.y * TM, sp = blockIdx.z;
  const int kt0 = sp * kt_per;
  const int nt = min((K + BK - 1) / BK - kt0, kt_per);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (vec_w && threadIdx.x == 0) {
    for (int st = 0; st < STAGES; ++st) wg::mbar_init(&full[st], 1);
    wg::mbar_init_fence();
  }
  __syncthreads();
  auto load = [&](int t) {
    const int st = t % STAGES, k0 = (kt0 + t) * BK;
    stage<TM, BK>(&xs[st][0][0], x, M, K, m0, k0, vec_x != 0);
    if (!vec_w) {
      stage_w_scalar<H>(ws + st * kWStage, w, K, N, k0, n0);
    } else if (threadIdx.x == 0) {
      wg::mbar_expect_tx(&full[st], kWStage);
#pragma unroll
      for (int h = 0; h < H; ++h)
        wg::tma_load_3d(ws + st * kWStage + h * kWBox, &w_map, &full[st],
                        n0 + 64 * h, k0, 0);
    }
  };

  float acc[H][NB8][4] = {};
#pragma unroll
  for (int t = 0; t < STAGES - 1; ++t) {
    if (t < nt) load(t);
    tc::cp_async_commit();
  }
  for (int t = 0; t < nt; ++t) {
    const int st = t % STAGES;
    tc::cp_async_wait<STAGES - 2>();
    if (vec_w) wg::mbar_wait(&full[st], (t / STAGES) & 1);
    __syncthreads();  // stage t landed; stage t - 1 is free again
    if (t + STAGES - 1 < nt) load(t + STAGES - 1);
    tc::cp_async_commit();
    const unsigned char* wt = ws + st * kWStage;
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      // A = w^T [16 n x 16 k]: the transpose of w's [k][n] rows
      unsigned a[H][4];
#pragma unroll
      for (int h = 0; h < H; ++h)
        tc::ldsm_x4_trans(
            a[h], wt + wtile_at(kk * 16 + (lane & 7) + (lane >> 4) * 8,
                                h * 64 + warp * 16 + ((lane >> 3) & 1) * 8));
#pragma unroll
      for (int j = 0; j < NB8; ++j) {  // B = x^T [16 k x 8 m]
        unsigned b[2];
        tc::ldsm_x2(b, &xs[st][j * 8 + (lane & 7)]
                         [kk * 16 + ((lane >> 3) & 1) * 8]);
#pragma unroll
        for (int h = 0; h < H; ++h) tc::mma_bf16(acc[h][j], a[h], b[0], b[1]);
      }
    }
  }
  tc::cp_async_wait<0>();

  if (splits > 1 &&
      !split_sum<4 * NB8 * H>(&acc[0][0][0], work, arrived, &last,
                              blockIdx.y * gridDim.x + blockIdx.x, sp,
                              splits, kThreads, threadIdx.x,
                              [] { __syncthreads(); }))
    return;
  const int g = lane >> 2, t4 = lane & 3;
#pragma unroll
  for (int h = 0; h < H; ++h)
#pragma unroll
    for (int j = 0; j < NB8; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int n = n0 + h * 64 + warp * 16 + g + (i >> 1) * 8;
        const int m = m0 + j * 8 + t4 * 2 + (i & 1);
        if (m < M && n < N)
          out[static_cast<size_t>(m) * N + n] =
              __float2bfloat16(acc[h][j][i]);
      }
}

template <int NB8, int H>
int launch_small(const DenseLaunch& a, const bf16* x, const bf16* w,
                 bf16* out, cudaStream_t stream) {
  CUtensorMap w_map = {};  // unread where !vec_w
  if (a.vec_w) {
    const int err = weight_map(&w_map, w, a.K, a.N);
    if (err != 0) return kDriverError + err;
  }
  auto kernel = dense_mma_sync<NB8, H>;
  constexpr int bytes = kSmallSmem<NB8, H>;
  // once a process (a call a projection at decode)
  static const cudaError_t attr = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  kernel<<<dim3((a.N + 64 * H - 1) / (64 * H),
                (a.M + 8 * NB8 - 1) / (8 * NB8), a.splits),
           kThreads, bytes, stream>>>(w_map, x, w, out, a.work, a.arrived,
                                      a.M, a.K, a.N, a.vec_x, a.vec_w,
                                      a.splits, a.kt_per);
  return static_cast<int>(cudaGetLastError());
}

// The mma.sync tiles of a.width columns, 64 or 128.
template <int NB8>
int launch_rows(const DenseLaunch& a, const bf16* x, const bf16* w,
                bf16* out, cudaStream_t stream) {
  if (a.width == 64) return launch_small<NB8, 1>(a, x, w, out, stream);
  if (a.width == 128) return launch_small<NB8, 2>(a, x, w, out, stream);
  return -1;
}

// --------------------- bf16, M > 64, TMA-aligned rows: wgmma kernel

constexpr int WBM = 128, WBK = 64;
constexpr int kWThreads = 384;    // a producer and two consumer warpgroups
constexpr int kConsumers = 256;   // arrivals that free a stage
constexpr int kBox = 64 * WBK * 2;  // 8 KB: a box of 64 x 64
constexpr int kA = WBM * WBK * 2;   // 16 KB: x's share of a stage

// The shared memory of the [128 x BN] tiles: the ring (x, then w), each
// consumer's output rows, the ring's barriers and the split's flag, and
// the slack that puts the ring on a 1024-byte boundary.
template <int BN>
struct WgTile {
  static constexpr int kStages = BN == 256 ? 3 : 6;
  static constexpr int kStage = kA + BN * WBK * 2;  // 48 or 32 KB
  static constexpr int kOut = 64 * BN * 2;          // a consumer's rows out
  static constexpr int kSmem =
      kStages * kStage + 2 * kOut + 2 * kStages * 8 + 16 + 1024;
};
static_assert(WgTile<128>::kSmem <= 232448 && WgTile<256>::kSmem <= 232448,
              "the ring fits a CTA's shared memory");

template <int BN>
__device__ __forceinline__ void wgmma_tile(float (&acc)[BN / 2], uint64_t da,
                                           uint64_t db, int accumulate) {
  if constexpr (BN == 256)
    wg::wgmma_m64n256k16<0, 1>(acc, da, db, accumulate);
  else
    wg::wgmma_m64n128k16<0, 1>(acc, da, db, accumulate);
}

// Grid: min(units, SMs) CTAs of kWThreads walking units u = tile * splits
// + split (the splits of a tile adjacent); tile t is rows (t % mt) 128 ..
// and columns (t / mt) BN .. (the row tiles of one column tile adjacent,
// so they read its w from L2); split sp walks K steps sp kt_per .. (the
// last fewer).  Tensor maps (bf16, 3-D with one "expert", 128-byte
// swizzle): x_k over x [M][K], boxes 64 x 128 (K-major A); w_mn over w
// [K][N], 64 x 64 (MN-major B, BN / 64 a stage); o over out [M][N],
// 64 x 64.
template <int BN>
__global__ void __launch_bounds__(kWThreads, 1) dense_wgmma(
    const __grid_constant__ CUtensorMap x_k,
    const __grid_constant__ CUtensorMap w_mn,
    const __grid_constant__ CUtensorMap o, int mt, int units, int kb,
    int splits, int kt_per, float* work, int* arrived) {
  using S = WgTile<BN>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  // the ring's base on a 1024-byte boundary (the swizzle atoms'), then
  // each consumer's output rows, then the barriers and the flag
  unsigned char* ring =
      smem_raw + ((1024 - (wg::smem_u32(smem_raw) & 1023)) & 1023);
  unsigned char* outs = ring + S::kStages * S::kStage;
  uint64_t* full = reinterpret_cast<uint64_t*>(outs + 2 * S::kOut);
  uint64_t* empty = full + S::kStages;
  int* flag = reinterpret_cast<int*>(empty + S::kStages);
  if (threadIdx.x == 0) {
    for (int s = 0; s < S::kStages; ++s) {
      wg::mbar_init(&full[s], 1);
      wg::mbar_init(&empty[s], kConsumers);
    }
    wg::mbar_init_fence();
  }
  __syncthreads();
  const int group = threadIdx.x / 128;
  if (group == 0) {  // the producer
    if constexpr (BN == 256) wg::setmaxnreg_dec<40>();
    if (threadIdx.x != 0) return;
    int stage = 0;
    uint32_t phase = 0;
    for (int u = blockIdx.x; u < units; u += gridDim.x) {
      const int t = u / splits, k1 = min(kb, (u % splits + 1) * kt_per);
      const int m0 = (t % mt) * WBM, n0 = (t / mt) * BN;
      for (int k = (u % splits) * kt_per; k < k1; ++k) {
        wg::mbar_wait(&empty[stage], phase ^ 1);
        uint64_t* bar = &full[stage];
        wg::mbar_expect_tx(bar, S::kStage);
        unsigned char* a = ring + stage * S::kStage;
        unsigned char* b = a + kA;
        const int k0 = k * WBK;
        wg::tma_load_3d(a, &x_k, bar, k0, m0, 0);  // x rows m0.., cols k0..
        for (int j = 0; j < BN / 64; ++j)  // w rows k0.. as [k][n]
          wg::tma_load_3d(b + j * kBox, &w_mn, bar, n0 + 64 * j, k0, 0);
        if (++stage == S::kStages) {
          stage = 0;
          phase ^= 1;
        }
      }
    }
  } else {  // a consumer: rows 64 cw .. 64 cw + 63 of every tile
    // setmaxnreg.inc waits for registers the producer releases: only the
    // 256-wide tile's 128 accumulators a thread need more than the
    // launch's share
    if constexpr (BN == 256) wg::setmaxnreg_inc<232>();
    const int cw = group - 1;
    const int lane = threadIdx.x & 31, g = lane >> 2, t4 = lane & 3;
    const int row = 16 * ((threadIdx.x / 32) & 3) + g;  // and row + 8
    const bool leader = threadIdx.x % 128 == 0;
    unsigned char* out = outs + cw * S::kOut;  // boxes of [64][64] bf16
    int stage = 0;
    uint32_t phase = 0;
    float acc[BN / 2];
    for (int u = blockIdx.x; u < units; u += gridDim.x) {
      const int t = u / splits, sp = u % splits;
      const int m0 = (t % mt) * WBM, n0 = (t / mt) * BN;
      const int k0 = sp * kt_per, k1 = min(kb, k0 + kt_per);
      // the unit's K steps in order; a stage is freed once the group
      // after it has been issued and it has completed
      int prev = -1;
      for (int k = k0; k < k1; ++k) {
        wg::mbar_wait(&full[stage], phase);
        const unsigned char* a = ring + stage * S::kStage + cw * kBox;
        const unsigned char* b = ring + stage * S::kStage + kA;
        wg::wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < WBK / 16; ++kk)
          // x K-major: 16 values are 32 bytes of each 128-byte row; w
          // MN-major: 16 reduction rows are two 1024-byte atoms
          wgmma_tile<BN>(acc, wg::desc_sw128(a + kk * 32, 16, 1024),
                         wg::desc_sw128(b + kk * 2048, kBox, 1024),
                         k > k0 || kk > 0);
        wg::wgmma_commit();
        if (prev >= 0) {
          wg::wgmma_wait<1>();
          wg::mbar_arrive(&empty[prev]);
        }
        prev = stage;
        if (++stage == S::kStages) {
          stage = 0;
          phase ^= 1;
        }
      }
      wg::wgmma_wait<0>();
      wg::fence_regs(acc);
      wg::mbar_arrive(&empty[prev]);
      // a split unit: the tile's last split to arrive stores it (the
      // 256-wide tile runs unsplit: its 128 accumulators a thread leave no
      // registers for the sum)
      if constexpr (BN == 128) {
        if (splits > 1 &&
            !split_sum<BN / 2>(acc, work, arrived, flag, t, sp, splits,
                               kConsumers, threadIdx.x - 128,
                               [] { wg::named_sync(3, kConsumers); }))
          continue;
      }
      // the rows as bf16 into the 128-byte-swizzled boxes once the last
      // tile's store has read them, then one TMA store a box (the edges
      // past M or N are not written)
      if (leader) wg::bulk_wait_read<0>();
      wg::named_sync(1 + cw, 128);
#pragma unroll
      for (int j = 0; j < BN / 8; ++j)
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
        for (int q = 0; q < BN / 64; ++q)
          wg::tma_store_3d(&o, out + q * kBox, n0 + 64 * q, m0 + 64 * cw, 0);
        wg::bulk_commit();
      }
    }
    if (leader) wg::bulk_wait<0>();
  }
}

template <int BN>
int launch_wgmma(const DenseLaunch& a, const bf16* x, const bf16* w,
                 bf16* out, cudaStream_t stream) {
  using S = WgTile<BN>;
  CUtensorMap x_k, w_mn, o;
  int err = tensor_map(&x_k, x, a.M, a.K, 64, WBM);
  if (err == 0) err = weight_map(&w_mn, w, a.K, a.N);
  if (err == 0) err = tensor_map(&o, out, a.M, a.N, 64, 64);
  if (err != 0) return kDriverError + err;
  if constexpr (BN == 256) {
    // setmaxnreg.inc waits for registers the producer releases: the
    // consumers' 2 x 128 x (232 - r) must fit in its 128 x (r - 40), so
    // the kernel must start with r >= 168 registers a thread (it does,
    // built with __launch_bounds__(384, 1)); a build with fewer is
    // refused here rather than left to hang
    static const int regs = [] {
      cudaFuncAttributes f;
      return cudaFuncGetAttributes(&f, dense_wgmma<256>) == cudaSuccess
                 ? f.numRegs
                 : 0;
    }();
    if (regs < 168) return static_cast<int>(cudaErrorLaunchOutOfResources);
  }
  static const cudaError_t attr = cudaFuncSetAttribute(
      dense_wgmma<BN>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      S::kSmem);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const int mt = (a.M + WBM - 1) / WBM;
  const int units = mt * ((a.N + BN - 1) / BN) * a.splits;
  const int grid = units < a.sms ? units : a.sms;
  dense_wgmma<BN><<<grid, kWThreads, S::kSmem, stream>>>(
      x_k, w_mn, o, mt, units, (a.K + WBK - 1) / WBK, a.splits, a.kt_per,
      a.work, a.arrived);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// One call of the product under the launch *a (see DenseLaunch; from
// kernels/dense_matmul.py plan): x [M, K], w [K, N] and out [M, N]
// contiguous, M, K and N > 0; where a->splits > 1, a->work holds the
// splits' fp32 partials (a->splits x the launch's tiles x a tile's
// elements) and a->arrived a counter a tile, zero before the call and
// zero again after it.  One kernel launch on `stream`.  Returns
// cudaGetLastError() after it, 100000 + the driver's error where a tensor
// map cannot be encoded, or -1 for a launch the kernels do not take.
int dense_matmul_run(const DenseLaunch* a, const void* x, const void* w,
                     void* out, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (a->splits < 1 || a->kt_per < 1 ||
      (a->splits > 1 && (a->work == nullptr || a->arrived == nullptr)))
    return -1;
  if (a->dtype == 0 && a->variant == kF32) {
    dense_f32<<<dim3((a->N + kF32N - 1) / kF32N, (a->M + kF32M - 1) / kF32M,
                     a->splits),
                kThreads, 0, s>>>(static_cast<const float*>(x),
                                  static_cast<const float*>(w),
                                  static_cast<float*>(out), a->work,
                                  a->arrived, a->M, a->K, a->N, a->vec_x,
                                  a->vec_w, a->splits, a->kt_per);
    return static_cast<int>(cudaGetLastError());
  }
  if (a->dtype != 1) return -1;
  const bf16* xb = static_cast<const bf16*>(x);
  const bf16* wb = static_cast<const bf16*>(w);
  bf16* ob = static_cast<bf16*>(out);
  if (a->variant == kWgmma) {
    if (!a->vec_x || !a->vec_w) return -1;
    if (a->width == 256 && a->splits == 1)
      return launch_wgmma<256>(*a, xb, wb, ob, s);
    if (a->width == 128) return launch_wgmma<128>(*a, xb, wb, ob, s);
    return -1;
  }
  if (a->variant != kMmaSync) return -1;
  switch (a->rows8) {
    case 1:
      return launch_rows<1>(*a, xb, wb, ob, s);
    case 2:
      return launch_rows<2>(*a, xb, wb, ob, s);
    case 4:
      return launch_rows<4>(*a, xb, wb, ob, s);
    case 8:
      return launch_rows<8>(*a, xb, wb, ob, s);
    default:
      return -1;
  }
}

}  // extern "C"
