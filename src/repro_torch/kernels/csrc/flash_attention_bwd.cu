// Flash attention (backward) for Hopper (sm_90a): given q [B, Sq, H, D],
// k, v [B, Sk, Hkv, D], the forward's output o [B, Sq, H, D], its row
// logsumexp lse [B, H, Sq] (fp32, natural units) and the output's
// gradient do [B, Sq, H, D], returns dq [B, Sq, H, D] and dk, dv
// [B, Sk, Hkv, D] in q's type, under the forward's mask (causal, sliding
// window, query offset, ragged Sq and Sk) and grouped kv heads.
//
// Replaces no Pallas kernel: the JAX package's backward is the jnp
// function models/attention.py:_flash_bwd (the custom_vjp of its blocked
// flash attention, :147), which recomputes p from the saved logsumexp.
// The port's training path (models/lm.py:train_loss) differentiates
// through the forward kernel (csrc/flash_attention.cu), whose autograd
// Function (kernels/flash_attention.py) calls this kernel.
//
// What it computes, with scale = D^-0.5 and qpos = q_offset + i:
//   Dv_i = sum_d do_id o_id                             (pass 1)
//   p_ij = exp(scale q_i.k_j - lse_i) for visible (i, j), else 0
//   dp_ij = do_i . v_j,   ds_ij = p_ij (dp_ij - Dv_i) scale
//   dv_j = sum_i p_ij do_i,  dk_j = sum_i ds_ij q_i     (pass 2, key tiles)
//   dq_i = sum_j ds_ij k_j                              (pass 3, query tiles)
// with p, dp and ds in fp32, as _flash_bwd's einsums run in fp32.  GQA is
// summed inside pass 2: the CTA of a kv head's key tile walks the G query
// heads that read it; repeated K and V never exist.
//
// Deterministic, with no atomics: each element of dq, dk and dv is summed
// in a fixed order (pass 2: its split's share of the (query head, query
// tile) walk, then the splits in order; pass 3: key tiles in order), so
// two calls give the same bits and the port's checkpoint-resume is exact.
// dq keeps a pass of its own, which recomputes s and dp (seven products
// where five would do): summing dq across the key tiles of pass 2 in a
// fixed order would need an ordered chain between CTAs; the separate pass
// is deterministic by construction.
//
// What bounds it on an H100: operations.  qwen2-0.5b's layer at B 8, S
// 1024 (14/2 heads of 64, causal, bf16) needs 5 [S x S x D] products over
// the visible half (s, dp, dv, dk, dq: 37.6 GFLOP, 0.038 ms at the bf16
// tensor cores' 989 TFLOP/s) over 68 MB (0.020 ms).
//
// Which kernels run is chosen by the dtype in the C entry points:
//   * bf16 (every training run): the tensor-core kernels (tcb:: below).
//     What held the first version (the CUDA-core kernel below, on bf16
//     widened: 3.15 ms at qwen2's shape on an H100, 0.47-2.45 % of its
//     bound at the training shapes) back, and what this design does:
//     1. every product ran on the fp32 CUDA cores (67 TFLOP/s): here s =
//        q k^T and dp = do v^T take the bf16 operands as they are through
//        mma.sync.m16n8k16 (exact products, fp32 sums, tc_bf16.cuh); dv =
//        p^T do, dk = ds^T q and dq = ds k split the fp32 p and ds into
//        bf16 hi + lo (tc::split_bf16) and put both through the mma into
//        one fp32 accumulator, which carries them to within 2^-16 of their
//        value (the forward does the same for p; one bf16 rounding would
//        be off by 2^-8 and is not _flash_bwd's function);
//     2. seven products for five: kept (the separate dq pass above), but
//        each is now a tensor-core product;
//     3. tiles widened to fp32 in shared memory and staged in sync (111
//        KB a CTA at D 64, one CTA an SM): tiles stay bf16, rows padded by
//        16 bytes (ldmatrix's eight row addresses fall in distinct banks at
//        every D), and the streamed tiles (Q and dO in pass 2, K and V in
//        pass 3) come through a two-stage cp.async ring, the next tile in
//        flight while the current one is multiplied: 56 KB a CTA at D 64;
//     4. the output phase walked p and ds one row at a time from shared
//        memory: here s and dp are computed transposed in pass 2 (keys as
//        the mma's rows), so that their accumulators are, fragment for
//        fragment, the A operands of p^T do and ds^T q (the forward's
//        register reuse of p); do and q come through ldmatrix.trans;
//     5. the key pass left the card half idle with few kv heads: where
//        (key tiles x Hkv x B) CTAs fill less than half the SMs, the
//        (query head, query tile) walk of a key tile is cut into `splits`
//        shares (flash_attention.py:bwd_plan, from the shapes alone; 4 at
//        gemma3-1b's B 2, 1 at qwen2's B 8), each CTA writes its fp32
//        partial dk and dv to scratch, and a fourth kernel sums the
//        partials in split order.
//     A warp takes 16 keys (pass 2) or 16 query rows (pass 3) and all of
//     their output columns: 4 warps a CTA, 64 keys a key tile, query
//     steps of 64 rows (32 at D 128 and 256, to keep s, dp, dk and dv of a
//     warp in registers); at D 256 a second set of 4 warps takes the other
//     128 output columns of the same rows, and each warp of a pair
//     computes the pair's s and dp in full (a pair's dk and dv, 256 fp32
//     columns each, do not fit one warp's registers).  Both passes visit
//     only the tiles a mask leaves visible and mask per element only on a
//     tile at an edge (causal diagonal, window, ragged Sq or Sk).  Up to
//     D 64 a warp keeps the fragments it reads on every step (K and V in
//     pass 2, Q and dO in pass 3) in registers.  Pass 2 takes its key
//     tiles in zigzag order (0, 1, .., then the last, the last but one,
//     ..), so that the two CTAs an SM holds at qwen2's shape pair a heavy
//     causal tile (many query tiles to walk) with a light one; pass 3
//     starts the heaviest (last) query tiles first.  Both refinements
//     leave every sum's order, and so the bits, as they were (0.42 ->
//     0.38 ms at qwen2's shape on an H100 80GB HBM3 at 700 W).
//     What holds it now (0.38 ms there, 10 % of the bound): mma.sync at
//     220-280 TFLOP/s of its products, the elementwise p / ds work and
//     the hi + lo splits between them, with 8 warps an SM.
//     Left for later: wgmma with TMA and warp-specialised producers, and
//     five products (dq summed across pass 2's CTAs in a fixed order).
//   * fp32 (and, through flash_attention_bwd_launch_cuda_cores, bf16: the
//     first version, kept as the yardstick chip_smoke.py times the
//     tensor-core kernels against): every product in fp32 on the CUDA
//     cores, never TF32 (q, k, v and do widened to fp32 as they are
//     staged), so the kernel and the plain version
//     (flash_attention.py:flash_attention_bwd_ref) differ only in the
//     order of their sums.  256 threads a CTA.  Tiles
//     of BM query rows and BN keys (64 and 64; 32 and 32 at D 256) are
//     staged in shared memory with a padded row stride (D + 4 floats).
//     The score phase gives each thread a TM x TN block of s and dp (rows
//     ty + 16a, keys tx + 16b); p and ds go to shared tiles.  The output
//     phase gives each thread RO rows x NC float4 columns of its output
//     tile and walks the shared p / ds tile row by row.
//
// Head dims 16, 32, 64, 80 (zamba2-2.7b's shared block), 128 and 256 in
// both; whisper's encoder and cross-attention (1500 keys, non-causal) run
// the ragged last key tile through the same masks.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "tc_bf16.cuh"

namespace {

constexpr int kThreads = 256;
constexpr float kLog2e = 1.4426950408889634f;

// ---------------------- fp32 (and the bf16 yardstick): CUDA-core kernels

// Column lanes of an output tile: the largest power of two up to 16 that
// divides D / 4 (each lane holds float4 columns 4 (cx + CL j)).
__host__ __device__ constexpr int col_lanes(int D) {
  int w = 16;
  while ((D / 4) % w) w /= 2;
  return w;
}

template <int D>
struct Cfg {
  static constexpr int BM = D > 128 ? 32 : 64;  // query rows a tile
  static constexpr int BN = D > 128 ? 32 : 64;  // keys a tile
  static constexpr int LD = D + 4;              // q/k/v/do tile row stride
  static constexpr int PLD = BN + 16;           // p / ds tile row stride
  static constexpr int TM = BM / 16, TN = BN / 16;  // score block a thread
  static constexpr int CL = col_lanes(D);       // output column lanes
  static constexpr int NC = D / (4 * CL);       // float4 columns a thread
  static constexpr int RL = kThreads / CL;      // output row lanes
  static constexpr int RK = BN / RL;            // dk/dv rows a thread
  static constexpr int RQ = BM / RL;            // dq rows a thread
  // pass 2: K, V, Q, dO tiles, p and ds tiles, lse and Dv of the rows
  static constexpr int SMEM_KV =
      (2 * BN * LD + 2 * BM * LD + 2 * BM * PLD + 2 * BM) * 4;
  // pass 3: Q, dO, K, V tiles, the ds tile, lse and Dv
  static constexpr int SMEM_Q =
      (2 * BM * LD + 2 * BN * LD + BM * PLD + 2 * BM) * 4;
  static_assert(D % 4 == 0 && RK >= 1 && RQ >= 1, "tile shapes");
};

__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 raw = *reinterpret_cast<const uint2*>(p);
  const float2 a =
      __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.x));
  const float2 b =
      __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.y));
  return make_float4(a.x, a.y, b.x, b.y);
}
__device__ __forceinline__ void store4(float* p, float4 v) {
  *reinterpret_cast<float4*>(p) = v;
}
__device__ __forceinline__ void store4(__nv_bfloat16* p, float4 v) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(v.x, v.y);
  *reinterpret_cast<__nv_bfloat162*>(p + 2) = __floats2bfloat162_rn(v.z, v.w);
}
__device__ __forceinline__ float dot4(float4 a, float4 b, float acc) {
  acc = fmaf(a.x, b.x, acc);
  acc = fmaf(a.y, b.y, acc);
  acc = fmaf(a.z, b.z, acc);
  return fmaf(a.w, b.w, acc);
}
__device__ __forceinline__ void fma4(float4& acc, float s, float4 b) {
  acc.x = fmaf(s, b.x, acc.x);
  acc.y = fmaf(s, b.y, acc.y);
  acc.z = fmaf(s, b.z, acc.z);
  acc.w = fmaf(s, b.w, acc.w);
}

// n rows of D values (global row stride `stride` elements, rows past
// `valid` zero) widened into a shared tile of row stride LD.
template <int D, typename T>
__device__ __forceinline__ void stage(float* dst, const T* src,
                                      size_t stride, int n, int valid) {
  constexpr int LD = D + 4;
  for (int i = threadIdx.x; i < n * (D / 4); i += kThreads) {
    const int r = i / (D / 4), c = (i % (D / 4)) * 4;
    store4(dst + r * LD + c, r < valid ? load4(src + r * stride + c)
                                       : make_float4(0.f, 0.f, 0.f, 0.f));
  }
}

__device__ __forceinline__ bool visible(int qpos, int kpos, int Sk,
                                        int causal, int window) {
  return kpos < Sk && (!causal || kpos <= qpos) &&
         (window == 0 || qpos - kpos < window);
}

// The score phase of one (query tile, key tile): s = q k^T and dp = do v^T
// over D, then p and ds into shared tiles (p_s may be null: pass 3 needs
// ds only).  q_s/do_s [BM][LD] rows i0.., k_s/v_s [BN][LD] keys k0..;
// lse_s (log2 units) and dv_s of the tile's rows.
template <int D>
__device__ __forceinline__ void scores(
    const float* q_s, const float* do_s, const float* k_s, const float* v_s,
    const float* lse_s, const float* dv_s, float* p_s, float* ds_s, int i0,
    int rows, int k0, int Sk, int q_offset, int causal, int window,
    float scale, float scale_log2) {
  using C = Cfg<D>;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  float s[C::TM][C::TN], dp[C::TM][C::TN];
#pragma unroll
  for (int a = 0; a < C::TM; ++a)
#pragma unroll
    for (int b = 0; b < C::TN; ++b) s[a][b] = dp[a][b] = 0.f;
#pragma unroll 4
  for (int d = 0; d < D; d += 4) {
    float4 qv[C::TM], ov[C::TM];
#pragma unroll
    for (int a = 0; a < C::TM; ++a) {
      qv[a] = load4(q_s + (ty + 16 * a) * C::LD + d);
      ov[a] = load4(do_s + (ty + 16 * a) * C::LD + d);
    }
#pragma unroll
    for (int b = 0; b < C::TN; ++b) {
      const float4 kv = load4(k_s + (tx + 16 * b) * C::LD + d);
      const float4 vv = load4(v_s + (tx + 16 * b) * C::LD + d);
#pragma unroll
      for (int a = 0; a < C::TM; ++a) {
        s[a][b] = dot4(qv[a], kv, s[a][b]);
        dp[a][b] = dot4(ov[a], vv, dp[a][b]);
      }
    }
  }
#pragma unroll
  for (int a = 0; a < C::TM; ++a) {
    const int r = ty + 16 * a;
    const int qpos = q_offset + i0 + r;
#pragma unroll
    for (int b = 0; b < C::TN; ++b) {
      const int c = tx + 16 * b;
      float p = 0.f;
      if (r < rows && visible(qpos, k0 + c, Sk, causal, window))
        p = exp2f(s[a][b] * scale_log2 - lse_s[r]);
      if (p_s != nullptr) p_s[r * C::PLD + c] = p;
      ds_s[r * C::PLD + c] = p * (dp[a][b] - dv_s[r]) * scale;
    }
  }
}

// Pass 1: Dv[b, h, i] = sum_d do . o, one warp a row (b, i, h), lanes over
// D in order of a fixed xor tree.
template <typename T>
__global__ void __launch_bounds__(kThreads) flash_bwd_dot(
    const T* __restrict__ o, const T* __restrict__ dout,
    float* __restrict__ dv, int rows, int Sq, int H, int D) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * (kThreads / 32) + threadIdx.x / 32;
  if (row >= rows) return;  // whole warps leave together
  const T* orow = o + static_cast<size_t>(row) * D;
  const T* drow = dout + static_cast<size_t>(row) * D;
  float acc = 0.f;
  for (int c = lane * 4; c < D; c += 128)
    acc = dot4(load4(orow + c), load4(drow + c), acc);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (lane == 0) {  // row = (b Sq + i) H + h
    const int h = row % H, bi = row / H;
    dv[(static_cast<size_t>(bi / Sq) * H + h) * Sq + bi % Sq] = acc;
  }
}

// Pass 2 (CUDA cores): grid (key tiles, Hkv, B); dk and dv of BN keys of
// one kv head.
template <int D, typename T>
__global__ void __launch_bounds__(kThreads, 1) flash_bwd_dkdv(
    const T* __restrict__ q, const T* __restrict__ k,
    const T* __restrict__ v, const T* __restrict__ dout,
    const float* __restrict__ lse, const float* __restrict__ dvec,
    T* __restrict__ dk, T* __restrict__ dv, int Sq, int Sk, int H, int Hkv,
    int causal, int window, int q_offset, float scale) {
  using C = Cfg<D>;
  extern __shared__ __align__(16) float smem[];
  float* k_s = smem;
  float* v_s = k_s + C::BN * C::LD;
  float* q_s = v_s + C::BN * C::LD;
  float* do_s = q_s + C::BM * C::LD;
  float* p_s = do_s + C::BM * C::LD;
  float* ds_s = p_s + C::BM * C::PLD;
  float* lse_s = ds_s + C::BM * C::PLD;
  float* dv_s = lse_s + C::BM;
  const int k0 = blockIdx.x * C::BN, hk = blockIdx.y, b = blockIdx.z;
  const int G = H / Hkv, tid = threadIdx.x;
  const int keys = min(C::BN, Sk - k0);
  const size_t q_row = static_cast<size_t>(H) * D;
  const size_t kv_row = static_cast<size_t>(Hkv) * D;
  const float scale_log2 = scale * kLog2e;

  // the query rows that see a key of this tile
  int i_lo = causal ? max(0, k0 - q_offset) : 0;
  int i_hi = Sq - 1;
  if (window > 0) i_hi = min(i_hi, k0 + keys - 1 + window - 1 - q_offset);
  const int t_lo = i_lo / C::BM, t_hi = i_hi < i_lo ? -1 : i_hi / C::BM;

  const size_t kv_off =
      (static_cast<size_t>(b) * Sk + k0) * kv_row + static_cast<size_t>(hk) * D;
  stage<D>(k_s, k + kv_off, kv_row, C::BN, keys);
  stage<D>(v_s, v + kv_off, kv_row, C::BN, keys);

  const int cx = tid % C::CL, cy = tid / C::CL;
  float4 ak[C::RK][C::NC], av[C::RK][C::NC];
#pragma unroll
  for (int a = 0; a < C::RK; ++a)
#pragma unroll
    for (int j = 0; j < C::NC; ++j)
      ak[a][j] = av[a][j] = make_float4(0.f, 0.f, 0.f, 0.f);

  for (int g = 0; g < G; ++g) {
    const int h = hk * G + g;
    for (int t = t_lo; t <= t_hi; ++t) {
      const int i0 = t * C::BM, rows = min(C::BM, Sq - i0);
      __syncthreads();  // the previous tile's readers are done
      const size_t q_off = (static_cast<size_t>(b) * Sq + i0) * q_row +
                           static_cast<size_t>(h) * D;
      stage<D>(q_s, q + q_off, q_row, C::BM, rows);
      stage<D>(do_s, dout + q_off, q_row, C::BM, rows);
      if (tid < C::BM) {
        const size_t r = (static_cast<size_t>(b) * H + h) * Sq + i0 + tid;
        lse_s[tid] = tid < rows ? lse[r] * kLog2e : 0.f;
        dv_s[tid] = tid < rows ? dvec[r] : 0.f;
      }
      __syncthreads();
      scores<D>(q_s, do_s, k_s, v_s, lse_s, dv_s, p_s, ds_s, i0, rows, k0,
                Sk, q_offset, causal, window, scale, scale_log2);
      __syncthreads();
      for (int r = 0; r < rows; ++r) {
        float4 ov[C::NC], qv[C::NC];
#pragma unroll
        for (int j = 0; j < C::NC; ++j) {
          ov[j] = load4(do_s + r * C::LD + 4 * (cx + C::CL * j));
          qv[j] = load4(q_s + r * C::LD + 4 * (cx + C::CL * j));
        }
#pragma unroll
        for (int a = 0; a < C::RK; ++a) {
          const float p = p_s[r * C::PLD + cy + C::RL * a];
          const float ds = ds_s[r * C::PLD + cy + C::RL * a];
#pragma unroll
          for (int j = 0; j < C::NC; ++j) {
            fma4(av[a][j], p, ov[j]);
            fma4(ak[a][j], ds, qv[j]);
          }
        }
      }
    }
  }
#pragma unroll
  for (int a = 0; a < C::RK; ++a) {
    const int key = cy + C::RL * a;
    if (key >= keys) continue;
    const size_t off = (static_cast<size_t>(b) * Sk + k0 + key) * kv_row +
                       static_cast<size_t>(hk) * D;
#pragma unroll
    for (int j = 0; j < C::NC; ++j) {
      store4(dk + off + 4 * (cx + C::CL * j), ak[a][j]);
      store4(dv + off + 4 * (cx + C::CL * j), av[a][j]);
    }
  }
}

// Pass 3 (CUDA cores): grid (query tiles, H, B), the last (heaviest causal)
// first; dq of BM query rows of one head.
template <int D, typename T>
__global__ void __launch_bounds__(kThreads, 1) flash_bwd_dq(
    const T* __restrict__ q, const T* __restrict__ k,
    const T* __restrict__ v, const T* __restrict__ dout,
    const float* __restrict__ lse, const float* __restrict__ dvec,
    T* __restrict__ dq, int Sq, int Sk, int H, int Hkv, int causal,
    int window, int q_offset, float scale) {
  using C = Cfg<D>;
  extern __shared__ __align__(16) float smem[];
  float* q_s = smem;
  float* do_s = q_s + C::BM * C::LD;
  float* k_s = do_s + C::BM * C::LD;
  float* v_s = k_s + C::BN * C::LD;
  float* ds_s = v_s + C::BN * C::LD;
  float* lse_s = ds_s + C::BM * C::PLD;
  float* dv_s = lse_s + C::BM;
  const int i0 = (gridDim.x - 1 - blockIdx.x) * C::BM;
  const int h = blockIdx.y, b = blockIdx.z, tid = threadIdx.x;
  const int hk = h / (H / Hkv);
  const int rows = min(C::BM, Sq - i0);
  const size_t q_row = static_cast<size_t>(H) * D;
  const size_t kv_row = static_cast<size_t>(Hkv) * D;
  const float scale_log2 = scale * kLog2e;

  const size_t q_off = (static_cast<size_t>(b) * Sq + i0) * q_row +
                       static_cast<size_t>(h) * D;
  stage<D>(q_s, q + q_off, q_row, C::BM, rows);
  stage<D>(do_s, dout + q_off, q_row, C::BM, rows);
  if (tid < C::BM) {
    const size_t r = (static_cast<size_t>(b) * H + h) * Sq + i0 + tid;
    lse_s[tid] = tid < rows ? lse[r] * kLog2e : 0.f;
    dv_s[tid] = tid < rows ? dvec[r] : 0.f;
  }

  // the key tiles this tile's rows can see (the forward's walk)
  const int q_lo = q_offset + i0, q_hi = q_offset + i0 + rows - 1;
  int j_hi = (Sk + C::BN - 1) / C::BN - 1;
  if (causal) j_hi = q_hi < 0 ? -1 : min(j_hi, q_hi / C::BN);
  int j_lo = 0;
  if (window > 0 && q_lo - window + 1 > 0) j_lo = (q_lo - window + 1) / C::BN;

  const int cx = tid % C::CL, cy = tid / C::CL;
  float4 aq[C::RQ][C::NC];
#pragma unroll
  for (int a = 0; a < C::RQ; ++a)
#pragma unroll
    for (int j = 0; j < C::NC; ++j) aq[a][j] = make_float4(0.f, 0.f, 0.f, 0.f);

  for (int jt = j_lo; jt <= j_hi; ++jt) {
    const int k0 = jt * C::BN, keys = min(C::BN, Sk - k0);
    __syncthreads();  // the previous tile's readers are done
    const size_t kv_off = (static_cast<size_t>(b) * Sk + k0) * kv_row +
                          static_cast<size_t>(hk) * D;
    stage<D>(k_s, k + kv_off, kv_row, C::BN, keys);
    stage<D>(v_s, v + kv_off, kv_row, C::BN, keys);
    __syncthreads();
    scores<D>(q_s, do_s, k_s, v_s, lse_s, dv_s, nullptr, ds_s, i0, rows, k0,
              Sk, q_offset, causal, window, scale, scale_log2);
    __syncthreads();
    for (int c = 0; c < keys; ++c) {
      float4 kv[C::NC];
#pragma unroll
      for (int j = 0; j < C::NC; ++j)
        kv[j] = load4(k_s + c * C::LD + 4 * (cx + C::CL * j));
#pragma unroll
      for (int a = 0; a < C::RQ; ++a) {
        const float ds = ds_s[(cy + C::RL * a) * C::PLD + c];
#pragma unroll
        for (int j = 0; j < C::NC; ++j) fma4(aq[a][j], ds, kv[j]);
      }
    }
  }
#pragma unroll
  for (int a = 0; a < C::RQ; ++a) {
    const int r = cy + C::RL * a;
    if (r >= rows) continue;
    T* dst = dq + (static_cast<size_t>(b) * Sq + i0 + r) * q_row +
             static_cast<size_t>(h) * D;
#pragma unroll
    for (int j = 0; j < C::NC; ++j) store4(dst + 4 * (cx + C::CL * j), aq[a][j]);
  }
}

// ------------------------------------------- bf16: tensor-core kernels

namespace tcb {

using tc::bf16;
constexpr int kPad = 8;  // bf16 elements of padding per shared row

template <int D>
struct Tc {
  static constexpr int DS = D > 128 ? 2 : 1;  // warps that share 16 rows
  static constexpr int THREADS = 128 * DS;
  static constexpr int DC = D / DS;           // output columns a warp
  static constexpr int LD = D + kPad;         // shared row stride
  static constexpr int KN = 64;                     // pass 2: keys a CTA
  static constexpr int KM = D >= 128 ? 32 : 64;     // pass 2: rows a step
  static constexpr int QM = 64;                     // pass 3: rows a CTA
  static constexpr int QN = D > 128 ? 32 : 64;      // pass 3: keys a step
  // pass 2: K and V, two stages of Q and dO, two of lse and Dv
  static constexpr int SMEM_KV = (2 * KN + 4 * KM) * LD * 2 + 4 * KM * 4;
  // pass 3: Q and dO, two stages of K and V, lse and Dv of the rows
  static constexpr int SMEM_Q = (2 * QM + 4 * QN) * LD * 2 + 2 * QM * 4;
  static_assert(DC % 16 == 0 && KM % 16 == 0 && QN % 16 == 0, "tiles");
};

// 4 bytes from global src to shared dst, zero-filled past src_bytes (0 or
// 4): lse and Dv rows, whose offsets need not be 16-byte aligned.
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   tc::smem_addr(dst)),
               "l"(src), "r"(src_bytes));
}

// A warp's A fragments of one 16-deep step from four score fragments
// [2 kq], [2 kq + 1] (the mma's C layout is its A layout), each fp32 value
// split into bf16 hi + lo.
__device__ __forceinline__ void split_frags(const float (&a)[4],
                                            const float (&b)[4],
                                            unsigned (&hi)[4],
                                            unsigned (&lo)[4]) {
  tc::split_bf16(a[0], a[1], hi[0], lo[0]);
  tc::split_bf16(a[2], a[3], hi[1], lo[1]);
  tc::split_bf16(b[0], b[1], hi[2], lo[2]);
  tc::split_bf16(b[2], b[3], hi[3], lo[3]);
}

// acc[2 dq], acc[2 dq + 1] += (hi + lo) . b (hi first).
__device__ __forceinline__ void mma_split(float (&c0)[4], float (&c1)[4],
                                          const unsigned (&hi)[4],
                                          const unsigned (&lo)[4],
                                          const unsigned (&b)[4]) {
  tc::mma_bf16(c0, hi, b[0], b[1]);
  tc::mma_bf16(c0, lo, b[0], b[1]);
  tc::mma_bf16(c1, hi, b[2], b[3]);
  tc::mma_bf16(c1, lo, b[2], b[3]);
}

// Pass 2: one CTA per (key tile, batch, kv head, split), key tiles in
// zigzag order (below).  Warp w takes the tile's keys 16 (w % 4) .. + 15
// and output columns DC (w / 4) .. + DC - 1.  For each
// step of its share of the (query head, query tile) walk: S^T = K Q^T and
// dP^T = V dO^T [16 keys x KM rows] on the tensor cores, p and ds in
// registers, then dV += P^T dO and dK += dS^T Q with P and dS as hi + lo
// A fragments and dO, Q through ldmatrix.trans.  With one split dk and dv
// are written in bf16; else the split's fp32 partials go to `part`
// ([2][splits][B, Sk, Hkv, D]: dk's, then dv's).
template <int D>
__global__ void __launch_bounds__(Tc<D>::THREADS, 1) flash_bwd_dkdv_tc(
    const bf16* __restrict__ q, const bf16* __restrict__ k,
    const bf16* __restrict__ v, const bf16* __restrict__ dout,
    const float* __restrict__ lse, const float* __restrict__ dvec,
    bf16* __restrict__ dk, bf16* __restrict__ dv, float* __restrict__ part,
    int B, int Sq, int Sk, int H, int Hkv, int causal, int window,
    int q_offset, float scale, int splits) {
  using C = Tc<D>;
  constexpr int LD = C::LD, KN = C::KN, KM = C::KM, RUNS = D / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* k_s = reinterpret_cast<bf16*>(smem_raw);  // [KN][LD]
  bf16* v_s = k_s + KN * LD;                      // [KN][LD]
  bf16* q_s = v_s + KN * LD;                      // [2][KM][LD]
  bf16* o_s = q_s + 2 * KM * LD;                  // [2][KM][LD] (dO)
  float* l_s = reinterpret_cast<float*>(o_s + 2 * KM * LD);  // [2][KM]
  float* e_s = l_s + 2 * KM;                      // [2][KM] (Dv)

  int idx = blockIdx.x;
  const int split = idx % splits;
  idx /= splits;
  const int hk = idx % Hkv;
  idx /= Hkv;
  // key tiles in the order 0, 1, .., then the last, the last but one, ..,
  // so that the CTAs an SM takes second, beside the heaviest causal tiles
  // (the first, which walk the most query tiles), are the lightest
  const int nkt = (Sk + KN - 1) / KN, half = (nkt + 1) / 2, pos = idx / B;
  const int b = idx % B;
  const int k0 = (pos < half ? pos : nkt - 1 - (pos - half)) * KN;
  const int keys = min(KN, Sk - k0), G = H / Hkv;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int krow = (warp & 3) * 16, c0 = (warp >> 2) * C::DC;
  const int g = lane >> 2, t4 = lane & 3;
  const float scale_log2 = scale * kLog2e;
  const size_t q_row = static_cast<size_t>(H) * D;
  const size_t kv_row = static_cast<size_t>(Hkv) * D;

  // the query tiles that see a key of this tile, and this split's share
  // of the walk over (query head, query tile), heads outermost
  const int i_lo = causal ? max(0, k0 - q_offset) : 0;
  int i_hi = Sq - 1;
  if (window > 0) i_hi = min(i_hi, k0 + keys - 1 + window - 1 - q_offset);
  const int t_lo = i_lo / KM;
  const int nt = i_hi < i_lo ? 0 : i_hi / KM - t_lo + 1;
  const int n = G * nt, per = (n + splits - 1) / splits;
  const int u0 = min(n, split * per), u1 = min(n, u0 + per);

  auto load_q = [&](int u, int st) {
    const int h = hk * G + u / nt, i0 = (t_lo + u % nt) * KM;
    const int rows = min(KM, Sq - i0);
    bf16* qd = q_s + st * KM * LD;
    bf16* od = o_s + st * KM * LD;
    for (int i = tid; i < KM * RUNS; i += C::THREADS) {
      const int r = i / RUNS, c = (i % RUNS) * 8;
      const bool in = r < rows;
      const size_t off = in ? (static_cast<size_t>(b) * Sq + i0 + r) * q_row +
                                  static_cast<size_t>(h) * D + c
                            : 0;
      tc::cp_async16(qd + r * LD + c, q + off, in ? 16 : 0);
      tc::cp_async16(od + r * LD + c, dout + off, in ? 16 : 0);
    }
    for (int r = tid; r < KM; r += C::THREADS) {
      const bool in = r < rows;
      const size_t off =
          in ? (static_cast<size_t>(b) * H + h) * Sq + i0 + r : 0;
      cp_async4(l_s + st * KM + r, lse + off, in ? 4 : 0);
      cp_async4(e_s + st * KM + r, dvec + off, in ? 4 : 0);
    }
  };
  if (u0 < u1) {
    for (int i = tid; i < KN * RUNS; i += C::THREADS) {
      const int r = i / RUNS, c = (i % RUNS) * 8;
      const bool in = r < keys;
      const size_t off = in ? (static_cast<size_t>(b) * Sk + k0 + r) *
                                      kv_row +
                                  static_cast<size_t>(hk) * D + c
                            : 0;
      tc::cp_async16(k_s + r * LD + c, k + off, in ? 16 : 0);
      tc::cp_async16(v_s + r * LD + c, v + off, in ? 16 : 0);
    }
    load_q(u0, 0);
  }
  tc::cp_async_commit();

  float ak[C::DC / 8][4] = {}, av[C::DC / 8][4] = {};
  // up to D 64 the warp's K and V fragments stay in registers for the walk
  constexpr bool REG = D <= 64;
  unsigned kf[REG ? D / 16 : 1][4], vf[REG ? D / 16 : 1][4];
  for (int u = u0; u < u1; ++u) {
    const int st = (u - u0) & 1;
    if (u + 1 < u1) load_q(u + 1, st ^ 1);  // in flight during this step
    tc::cp_async_commit();
    tc::cp_async_wait<1>();
    __syncthreads();
    const bf16* qs = q_s + st * KM * LD;
    const bf16* os = o_s + st * KM * LD;
    const float* ls = l_s + st * KM;
    const float* es = e_s + st * KM;
    const int i0 = (t_lo + u % nt) * KM;

    if constexpr (REG) {
      if (u == u0) {
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk) {
          const int a_off =
              (krow + (lane & 15)) * LD + kk * 16 + (lane >> 4) * 8;
          tc::ldsm_x4(kf[kk], k_s + a_off);
          tc::ldsm_x4(vf[kk], v_s + a_off);
        }
      }
    }
    // S^T = K Q^T and dP^T = V dO^T: [16 keys x KM rows] a warp
    float s[KM / 8][4] = {}, dp[KM / 8][4] = {};
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      unsigned ka[4], va[4];
      if constexpr (REG) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          ka[e] = kf[kk][e];
          va[e] = vf[kk][e];
        }
      } else {
        const int a_off =
            (krow + (lane & 15)) * LD + kk * 16 + (lane >> 4) * 8;
        tc::ldsm_x4(ka, k_s + a_off);
        tc::ldsm_x4(va, v_s + a_off);
      }
#pragma unroll
      for (int p = 0; p < KM / 16; ++p) {  // two blocks of 8 rows
        const int b_off = (p * 16 + (lane & 7) + (lane >> 4) * 8) * LD +
                          kk * 16 + ((lane >> 3) & 1) * 8;
        unsigned qb[4], ob[4];
        tc::ldsm_x4(qb, qs + b_off);
        tc::ldsm_x4(ob, os + b_off);
        tc::mma_bf16(s[2 * p], ka, qb[0], qb[1]);
        tc::mma_bf16(s[2 * p + 1], ka, qb[2], qb[3]);
        tc::mma_bf16(dp[2 * p], va, ob[0], ob[1]);
        tc::mma_bf16(dp[2 * p + 1], va, ob[2], ob[3]);
      }
    }

    // p and ds of key krow + g + 8 (e >> 1), row 8 nf + 2 t4 + (e & 1);
    // only a step on an edge needs the mask
    const int qpos0 = q_offset + i0, kpos0 = k0 + krow + g;
    const bool edge = k0 + KN > Sk || i0 + KM > Sq ||
                      (causal && k0 + KN - 1 > qpos0) ||
                      (window > 0 && qpos0 + KM - 1 - k0 >= window);
#pragma unroll
    for (int nf = 0; nf < KM / 8; ++nf) {
      const int r0 = nf * 8 + 2 * t4;
      const float2 lv = *reinterpret_cast<const float2*>(ls + r0);
      const float2 ev = *reinterpret_cast<const float2*>(es + r0);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = r0 + (e & 1);
        const float l2 = (e & 1 ? lv.y : lv.x) * kLog2e;
        float p = exp2f(s[nf][e] * scale_log2 - l2);
        if (edge && !(i0 + r < Sq && visible(qpos0 + r, kpos0 + 8 * (e >> 1),
                                             Sk, causal, window)))
          p = 0.f;
        s[nf][e] = p;
        dp[nf][e] = p * (dp[nf][e] - (e & 1 ? ev.y : ev.x)) * scale;
      }
    }

    // dV += P^T dO, dK += dS^T Q over this step's rows, 16 at a time
#pragma unroll
    for (int kq = 0; kq < KM / 16; ++kq) {
      unsigned ph[4], pl[4], sh[4], sl[4];
      split_frags(s[2 * kq], s[2 * kq + 1], ph, pl);
      split_frags(dp[2 * kq], dp[2 * kq + 1], sh, sl);
#pragma unroll
      for (int dq = 0; dq < C::DC / 16; ++dq) {  // two blocks of 8 columns
        const int t_off =
            (kq * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * LD + c0 +
            dq * 16 + (lane >> 4) * 8;
        unsigned ob[4], qb[4];
        tc::ldsm_x4_trans(ob, os + t_off);
        tc::ldsm_x4_trans(qb, qs + t_off);
        mma_split(av[2 * dq], av[2 * dq + 1], ph, pl, ob);
        mma_split(ak[2 * dq], ak[2 * dq + 1], sh, sl, qb);
      }
    }
    __syncthreads();  // this stage is overwritten by the step after next
  }
  tc::cp_async_wait<0>();

  const size_t n_out = static_cast<size_t>(B) * Sk * kv_row;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int key = krow + g + 8 * r;
    if (key >= keys) continue;
    const size_t off = (static_cast<size_t>(b) * Sk + k0 + key) * kv_row +
                       static_cast<size_t>(hk) * D + c0 + 2 * t4;
    if (splits == 1) {
#pragma unroll
      for (int nf = 0; nf < C::DC / 8; ++nf) {
        *reinterpret_cast<__nv_bfloat162*>(dk + off + nf * 8) =
            __floats2bfloat162_rn(ak[nf][2 * r], ak[nf][2 * r + 1]);
        *reinterpret_cast<__nv_bfloat162*>(dv + off + nf * 8) =
            __floats2bfloat162_rn(av[nf][2 * r], av[nf][2 * r + 1]);
      }
    } else {
      float* pk = part + static_cast<size_t>(split) * n_out + off;
      float* pv = part + static_cast<size_t>(splits + split) * n_out + off;
#pragma unroll
      for (int nf = 0; nf < C::DC / 8; ++nf) {
        *reinterpret_cast<float2*>(pk + nf * 8) =
            make_float2(ak[nf][2 * r], ak[nf][2 * r + 1]);
        *reinterpret_cast<float2*>(pv + nf * 8) =
            make_float2(av[nf][2 * r], av[nf][2 * r + 1]);
      }
    }
  }
}

// Pass 2's second step where the walk is split: dk and dv (n values each)
// = the splits' fp32 partials summed in split order, four values a thread.
__global__ void __launch_bounds__(kThreads) flash_bwd_sum(
    const float* __restrict__ part, bf16* __restrict__ dk,
    bf16* __restrict__ dv, int splits, size_t n) {
  const size_t i =
      (static_cast<size_t>(blockIdx.x) * kThreads + threadIdx.x) * 4;
  if (i >= 2 * n) return;
  const bool second = i >= n;
  const size_t j = second ? i - n : i;
  const float* src = part + (second ? static_cast<size_t>(splits) * n : 0) + j;
  float4 acc = load4(src);
  for (int s = 1; s < splits; ++s) {
    const float4 x = load4(src + static_cast<size_t>(s) * n);
    acc.x += x.x;
    acc.y += x.y;
    acc.z += x.z;
    acc.w += x.w;
  }
  store4((second ? dv : dk) + j, acc);
}

// Pass 3: one CTA per (query tile, batch, head), the last (heaviest
// causal) tiles first.  Warp w takes rows 16 (w % 4) .. + 15 and dq's
// columns DC (w / 4) .. + DC - 1; for each visible key tile, S = Q K^T and
// dP = dO V^T on the tensor cores, p and ds in registers, dQ += dS K with
// dS as hi + lo A fragments and K through ldmatrix.trans.
template <int D>
__global__ void __launch_bounds__(Tc<D>::THREADS, 1) flash_bwd_dq_tc(
    const bf16* __restrict__ q, const bf16* __restrict__ k,
    const bf16* __restrict__ v, const bf16* __restrict__ dout,
    const float* __restrict__ lse, const float* __restrict__ dvec,
    bf16* __restrict__ dq, int B, int Sq, int Sk, int H, int Hkv,
    int causal, int window, int q_offset, float scale) {
  using C = Tc<D>;
  constexpr int LD = C::LD, QM = C::QM, QN = C::QN, RUNS = D / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* q_s = reinterpret_cast<bf16*>(smem_raw);  // [QM][LD]
  bf16* o_s = q_s + QM * LD;                      // [QM][LD] (dO)
  bf16* k_s = o_s + QM * LD;                      // [2][QN][LD]
  bf16* v_s = k_s + 2 * QN * LD;                  // [2][QN][LD]
  float* l_s = reinterpret_cast<float*>(v_s + 2 * QN * LD);  // [QM]
  float* e_s = l_s + QM;                                     // [QM] (Dv)

  int idx = blockIdx.x;
  const int h = idx % H;
  idx /= H;
  const int b = idx % B;
  const int i0 = ((Sq + QM - 1) / QM - 1 - idx / B) * QM;
  const int hk = h / (H / Hkv), rows = min(QM, Sq - i0);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int qrow = (warp & 3) * 16, c0 = (warp >> 2) * C::DC;
  const int g = lane >> 2, t4 = lane & 3;
  const float scale_log2 = scale * kLog2e;
  const size_t q_row = static_cast<size_t>(H) * D;
  const size_t kv_row = static_cast<size_t>(Hkv) * D;

  for (int i = tid; i < QM * RUNS; i += C::THREADS) {
    const int r = i / RUNS, c = (i % RUNS) * 8;
    const bool in = r < rows;
    const size_t off = in ? (static_cast<size_t>(b) * Sq + i0 + r) * q_row +
                                static_cast<size_t>(h) * D + c
                          : 0;
    tc::cp_async16(q_s + r * LD + c, q + off, in ? 16 : 0);
    tc::cp_async16(o_s + r * LD + c, dout + off, in ? 16 : 0);
  }
  for (int r = tid; r < QM; r += C::THREADS) {
    const bool in = r < rows;
    const size_t off = in ? (static_cast<size_t>(b) * H + h) * Sq + i0 + r : 0;
    cp_async4(l_s + r, lse + off, in ? 4 : 0);
    cp_async4(e_s + r, dvec + off, in ? 4 : 0);
  }
  auto load_kv = [&](int j, int st) {
    const int kt0 = j * QN;
    for (int i = tid; i < QN * RUNS; i += C::THREADS) {
      const int t = i / RUNS, c = (i % RUNS) * 8;
      const bool in = kt0 + t < Sk;
      const size_t off = in ? (static_cast<size_t>(b) * Sk + kt0 + t) *
                                      kv_row +
                                  static_cast<size_t>(hk) * D + c
                            : 0;
      tc::cp_async16(k_s + (st * QN + t) * LD + c, k + off, in ? 16 : 0);
      tc::cp_async16(v_s + (st * QN + t) * LD + c, v + off, in ? 16 : 0);
    }
  };

  // the key tiles this tile's rows can see (the forward's walk)
  const int q_lo = q_offset + i0, q_hi = q_offset + i0 + rows - 1;
  int j_hi = (Sk + QN - 1) / QN - 1;
  if (causal) j_hi = q_hi < 0 ? -1 : min(j_hi, q_hi / QN);
  int j_lo = 0;
  if (window > 0 && q_lo - window + 1 > 0) j_lo = (q_lo - window + 1) / QN;
  if (j_lo <= j_hi) load_kv(j_lo, 0);
  tc::cp_async_commit();

  float acc[C::DC / 8][4] = {};
  // up to D 64 the warp's Q and dO fragments stay in registers for the walk
  constexpr bool REG = D <= 64;
  unsigned qf[REG ? D / 16 : 1][4], of[REG ? D / 16 : 1][4];
  for (int j = j_lo; j <= j_hi; ++j) {
    const int st = (j - j_lo) & 1;
    if (j < j_hi) load_kv(j + 1, st ^ 1);  // in flight during this tile
    tc::cp_async_commit();
    tc::cp_async_wait<1>();
    __syncthreads();
    const bf16* ks = k_s + st * QN * LD;
    const bf16* vs = v_s + st * QN * LD;
    const int k0 = j * QN;

    if constexpr (REG) {
      if (j == j_lo) {
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk) {
          const int a_off =
              (qrow + (lane & 15)) * LD + kk * 16 + (lane >> 4) * 8;
          tc::ldsm_x4(qf[kk], q_s + a_off);
          tc::ldsm_x4(of[kk], o_s + a_off);
        }
      }
    }
    // S = Q K^T and dP = dO V^T: [16 rows x QN keys] a warp
    float s[QN / 8][4] = {}, dp[QN / 8][4] = {};
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      unsigned qa[4], oa[4];
      if constexpr (REG) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          qa[e] = qf[kk][e];
          oa[e] = of[kk][e];
        }
      } else {
        const int a_off =
            (qrow + (lane & 15)) * LD + kk * 16 + (lane >> 4) * 8;
        tc::ldsm_x4(qa, q_s + a_off);
        tc::ldsm_x4(oa, o_s + a_off);
      }
#pragma unroll
      for (int p = 0; p < QN / 16; ++p) {  // two blocks of 8 keys
        const int b_off = (p * 16 + (lane & 7) + (lane >> 4) * 8) * LD +
                          kk * 16 + ((lane >> 3) & 1) * 8;
        unsigned kb[4], vb[4];
        tc::ldsm_x4(kb, ks + b_off);
        tc::ldsm_x4(vb, vs + b_off);
        tc::mma_bf16(s[2 * p], qa, kb[0], kb[1]);
        tc::mma_bf16(s[2 * p + 1], qa, kb[2], kb[3]);
        tc::mma_bf16(dp[2 * p], oa, vb[0], vb[1]);
        tc::mma_bf16(dp[2 * p + 1], oa, vb[2], vb[3]);
      }
    }

    // ds of row qrow + g + 8 (e >> 1), key 8 nf + 2 t4 + (e & 1)
    const bool edge = k0 + QN > Sk || i0 + QM > Sq ||
                      (causal && k0 + QN - 1 > q_lo) ||
                      (window > 0 && q_lo + QM - 1 - k0 >= window);
    float l2[2], ev[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l2[r] = l_s[qrow + g + 8 * r] * kLog2e;
      ev[r] = e_s[qrow + g + 8 * r];
    }
#pragma unroll
    for (int nf = 0; nf < QN / 8; ++nf)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = qrow + g + 8 * (e >> 1);
        float p = exp2f(s[nf][e] * scale_log2 - l2[e >> 1]);
        if (edge && !(r < rows && visible(q_lo + r, k0 + nf * 8 + 2 * t4 +
                                                        (e & 1),
                                          Sk, causal, window)))
          p = 0.f;
        dp[nf][e] = p * (dp[nf][e] - ev[e >> 1]) * scale;
      }

    // dQ += dS K over this tile's keys, 16 at a time
#pragma unroll
    for (int kq = 0; kq < QN / 16; ++kq) {
      unsigned sh[4], sl[4];
      split_frags(dp[2 * kq], dp[2 * kq + 1], sh, sl);
#pragma unroll
      for (int dc = 0; dc < C::DC / 16; ++dc) {  // two blocks of 8 columns
        unsigned kb[4];
        tc::ldsm_x4_trans(
            kb, ks + (kq * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * LD +
                    c0 + dc * 16 + (lane >> 4) * 8);
        mma_split(acc[2 * dc], acc[2 * dc + 1], sh, sl, kb);
      }
    }
    __syncthreads();  // this stage is overwritten by the tile after next
  }
  tc::cp_async_wait<0>();

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = qrow + g + 8 * r;
    if (row >= rows) continue;
    bf16* dst = dq + (static_cast<size_t>(b) * Sq + i0 + row) * q_row +
                static_cast<size_t>(h) * D + c0 + 2 * t4;
#pragma unroll
    for (int nf = 0; nf < C::DC / 8; ++nf)
      *reinterpret_cast<__nv_bfloat162*>(dst + nf * 8) =
          __floats2bfloat162_rn(acc[nf][2 * r], acc[nf][2 * r + 1]);
  }
}

}  // namespace tcb

template <typename K>
cudaError_t allow_smem(K kernel, int bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

// Pass 1 on `stream`: Dv of every (b, i, h) row into dvec.
template <typename T>
cudaError_t launch_dot(const void* o, const void* dout, void* dvec, int B,
                       int Sq, int H, int D, cudaStream_t stream) {
  const int rows = B * Sq * H;
  flash_bwd_dot<T><<<(rows + kThreads / 32 - 1) / (kThreads / 32), kThreads,
                     0, stream>>>(static_cast<const T*>(o),
                                  static_cast<const T*>(dout),
                                  static_cast<float*>(dvec), rows, Sq, H, D);
  return cudaGetLastError();
}

// The CUDA-core kernels (fp32, and bf16 widened: the first version).
template <int D, typename T>
int launch(const void* q, const void* k, const void* v, const void* o,
           const void* dout, const void* lse, void* dvec, void* dq, void* dk,
           void* dv, int B, int Sq, int Sk, int H, int Hkv, int causal,
           int window, int q_offset, float scale, cudaStream_t stream) {
  using C = Cfg<D>;
  const T* qp = static_cast<const T*>(q);
  const T* kp = static_cast<const T*>(k);
  const T* vp = static_cast<const T*>(v);
  const T* dop = static_cast<const T*>(dout);
  const float* lp = static_cast<const float*>(lse);
  float* dvp = static_cast<float*>(dvec);
  cudaError_t err = launch_dot<T>(o, dout, dvec, B, Sq, H, D, stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  auto kv_kernel = flash_bwd_dkdv<D, T>;
  err = allow_smem(kv_kernel, C::SMEM_KV);
  if (err != cudaSuccess) return static_cast<int>(err);
  kv_kernel<<<dim3((Sk + C::BN - 1) / C::BN, Hkv, B), kThreads, C::SMEM_KV,
              stream>>>(qp, kp, vp, dop, lp, dvp, static_cast<T*>(dk),
                        static_cast<T*>(dv), Sq, Sk, H, Hkv, causal, window,
                        q_offset, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  auto q_kernel = flash_bwd_dq<D, T>;
  err = allow_smem(q_kernel, C::SMEM_Q);
  if (err != cudaSuccess) return static_cast<int>(err);
  q_kernel<<<dim3((Sq + C::BM - 1) / C::BM, H, B), kThreads, C::SMEM_Q,
             stream>>>(qp, kp, vp, dop, lp, dvp, static_cast<T*>(dq), Sq, Sk,
                       H, Hkv, causal, window, q_offset, scale);
  return static_cast<int>(cudaGetLastError());
}

// The tensor-core kernels (bf16): pass 1, pass 2 (split `splits` ways,
// then summed when splits > 1), pass 3.
template <int D>
int launch_tc(const void* q, const void* k, const void* v, const void* o,
              const void* dout, const void* lse, void* dvec, void* dq,
              void* dk, void* dv, int B, int Sq, int Sk, int H, int Hkv,
              int causal, int window, int q_offset, float scale, int splits,
              float* part, cudaStream_t stream) {
  using C = tcb::Tc<D>;
  using tc::bf16;
  const bf16* qp = static_cast<const bf16*>(q);
  const bf16* kp = static_cast<const bf16*>(k);
  const bf16* vp = static_cast<const bf16*>(v);
  const bf16* dop = static_cast<const bf16*>(dout);
  const float* lp = static_cast<const float*>(lse);
  float* dvp = static_cast<float*>(dvec);
  cudaError_t err = launch_dot<bf16>(o, dout, dvec, B, Sq, H, D, stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  auto kv_kernel = tcb::flash_bwd_dkdv_tc<D>;
  err = allow_smem(kv_kernel, C::SMEM_KV);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int kv_ctas = (Sk + C::KN - 1) / C::KN * B * Hkv * splits;
  kv_kernel<<<kv_ctas, C::THREADS, C::SMEM_KV, stream>>>(
      qp, kp, vp, dop, lp, dvp, static_cast<bf16*>(dk), static_cast<bf16*>(dv),
      part, B, Sq, Sk, H, Hkv, causal, window, q_offset, scale, splits);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  if (splits > 1) {
    const size_t n = static_cast<size_t>(B) * Sk * Hkv * D;
    tcb::flash_bwd_sum<<<static_cast<unsigned>((2 * n / 4 + kThreads - 1) /
                                               kThreads),
                         kThreads, 0, stream>>>(part, static_cast<bf16*>(dk),
                                                static_cast<bf16*>(dv),
                                                splits, n);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  auto q_kernel = tcb::flash_bwd_dq_tc<D>;
  err = allow_smem(q_kernel, C::SMEM_Q);
  if (err != cudaSuccess) return static_cast<int>(err);
  q_kernel<<<(Sq + C::QM - 1) / C::QM * H * B, C::THREADS, C::SMEM_Q,
             stream>>>(qp, kp, vp, dop, lp, dvp, static_cast<bf16*>(dq), B,
                       Sq, Sk, H, Hkv, causal, window, q_offset, scale);
  return static_cast<int>(cudaGetLastError());
}

#define FLASH_BWD_DIMS(X) X(16) X(32) X(64) X(80) X(128) X(256)

template <typename T>
int launch_cc(int D, const void* q, const void* k, const void* v,
              const void* o, const void* dout, const void* lse, void* dvec,
              void* dq, void* dk, void* dv, int B, int Sq, int Sk, int H,
              int Hkv, int causal, int window, int q_offset, float scale,
              cudaStream_t s) {
  switch (D) {
#define FLASH_BWD_CASE(d)                                                  \
  case d:                                                                  \
    return launch<d, T>(q, k, v, o, dout, lse, dvec, dq, dk, dv, B, Sq,    \
                        Sk, H, Hkv, causal, window, q_offset, scale, s);
    FLASH_BWD_DIMS(FLASH_BWD_CASE)
#undef FLASH_BWD_CASE
    default:
      return -1;
  }
}

int launch_bf16(int D, const void* q, const void* k, const void* v,
                const void* o, const void* dout, const void* lse, void* dvec,
                void* dq, void* dk, void* dv, int B, int Sq, int Sk, int H,
                int Hkv, int causal, int window, int q_offset, float scale,
                int splits, float* part, cudaStream_t s) {
  switch (D) {
#define FLASH_BWD_CASE(d)                                                  \
  case d:                                                                  \
    return launch_tc<d>(q, k, v, o, dout, lse, dvec, dq, dk, dv, B, Sq,    \
                        Sk, H, Hkv, causal, window, q_offset, scale, splits, \
                        part, s);
    FLASH_BWD_DIMS(FLASH_BWD_CASE)
#undef FLASH_BWD_CASE
    default:
      return -1;
  }
}

}  // namespace

extern "C" {

// Bytes of dynamic shared memory a CTA takes at head dim D: which 0 and 1
// the CUDA-core kernels' pass 2 and pass 3 (fp32), 2 and 3 the
// tensor-core kernels' (bf16); -1 for a D without an instantiation.
int flash_attention_bwd_smem_bytes(int which, int D) {
  switch (D) {
#define FLASH_BWD_SMEM(d)                                              \
  case d:                                                              \
    return which == 0   ? Cfg<d>::SMEM_KV                              \
           : which == 1 ? Cfg<d>::SMEM_Q                               \
           : which == 2 ? tcb::Tc<d>::SMEM_KV                          \
                        : tcb::Tc<d>::SMEM_Q;
    FLASH_BWD_DIMS(FLASH_BWD_SMEM)
#undef FLASH_BWD_SMEM
    default:
      return -1;
  }
}

// q, o, dout, dq [B, Sq, H, D]; k, v, dk, dv [B, Sk, Hkv, D]: contiguous,
// 16-byte aligned, one type (dtype 0 fp32, 1 bf16); lse [B, H, Sq] fp32
// from the forward (natural units); dvec [B, H, Sq] fp32 scratch (pass 1
// writes it).  D one of 16, 32, 64, 80, 128, 256; H a multiple of Hkv; mask
// and scale as the forward's.  splits (bf16 only; 1 for fp32): the shares
// of pass 2's walk a key tile is cut into, 1-64; with splits > 1, part is
// fp32 scratch of 2 splits B Sk Hkv D values.  Three kernels on `stream`
// (four with splits > 1); returns cudaGetLastError() after each launch
// (the first failure), -1 for a bad dtype code or D, -2 for a bad splits.
int flash_attention_bwd_launch_split(int dtype, const void* q, const void* k,
                                     const void* v, const void* o,
                                     const void* dout, const void* lse,
                                     void* dvec, void* dq, void* dk,
                                     void* dv, int B, int Sq, int Sk, int H,
                                     int Hkv, int D, int causal, int window,
                                     int q_offset, float scale, int splits,
                                     void* part, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (splits < 1 || splits > 64 || (splits > 1 && (dtype != 1 || !part)))
    return -2;
  switch (dtype) {
    case 0:
      return launch_cc<float>(D, q, k, v, o, dout, lse, dvec, dq, dk, dv, B,
                              Sq, Sk, H, Hkv, causal, window, q_offset,
                              scale, s);
    case 1:
      return launch_bf16(D, q, k, v, o, dout, lse, dvec, dq, dk, dv, B, Sq,
                         Sk, H, Hkv, causal, window, q_offset, scale, splits,
                         static_cast<float*>(part), s);
    default:
      return -1;
  }
}

// flash_attention_bwd_launch_split with one split (no scratch).
int flash_attention_bwd_launch(int dtype, const void* q, const void* k,
                               const void* v, const void* o,
                               const void* dout, const void* lse,
                               void* dvec, void* dq, void* dk, void* dv,
                               int B, int Sq, int Sk, int H, int Hkv, int D,
                               int causal, int window, int q_offset,
                               float scale, void* stream) {
  return flash_attention_bwd_launch_split(
      dtype, q, k, v, o, dout, lse, dvec, dq, dk, dv, B, Sq, Sk, H, Hkv, D,
      causal, window, q_offset, scale, 1, nullptr, stream);
}

// The CUDA-core kernels for either dtype (bf16 widened to fp32 as it is
// staged): the fp32 path's kernels, and for bf16 the kernel the
// tensor-core kernels replaced, kept as the yardstick that chip_smoke.py
// times beside them.  Arguments and returns as flash_attention_bwd_launch.
int flash_attention_bwd_launch_cuda_cores(
    int dtype, const void* q, const void* k, const void* v, const void* o,
    const void* dout, const void* lse, void* dvec, void* dq, void* dk,
    void* dv, int B, int Sq, int Sk, int H, int Hkv, int D, int causal,
    int window, int q_offset, float scale, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return launch_cc<float>(D, q, k, v, o, dout, lse, dvec, dq, dk, dv, B,
                              Sq, Sk, H, Hkv, causal, window, q_offset,
                              scale, s);
    case 1:
      return launch_cc<__nv_bfloat16>(D, q, k, v, o, dout, lse, dvec, dq, dk,
                                      dv, B, Sq, Sk, H, Hkv, causal, window,
                                      q_offset, scale, s);
    default:
      return -1;
  }
}

}  // extern "C"
