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
// every product in fp32 on the CUDA cores (q, k, v, o and do widened as
// they are staged), as _flash_bwd's einsums run in fp32: the kernel and
// the plain version (flash_attention.py:flash_attention_bwd_ref) differ
// only in the order of their sums.  GQA is summed inside pass 2: the CTA
// of a kv head's key tile walks the G query heads that read it; repeated K
// and V never exist.
//
// Deterministic, with no atomics: each element of dq, dk and dv is written
// by one CTA that sums its terms in a fixed order (pass 2: query heads,
// then query tiles, then rows; pass 3: key tiles, then keys), so two calls
// give the same bits and the port's checkpoint-resume is exact.
//
// What bounds it on an H100: operations.  qwen2-0.5b's layer at B 8, S
// 1024 (14/2 heads of 64, causal, bf16) needs 5 [S x S x D] products over
// the visible half (s, dp, dv, dk, dq: 37.6 GFLOP, 0.038 ms on the bf16
// tensor cores) over 68 MB (0.020 ms).  This kernel does 7 (s and dp once
// in each pass), 52.7 GFLOP, in fp32 on the CUDA cores (67 TFLOP/s: 0.79
// ms at best).
//
// Head dims 16, 32, 64, 80 (zamba2-2.7b's shared block, whose output
// tile takes 4 column lanes of 5 float4s), 128 and 256; whisper's
// encoder and cross-attention (1500 keys, non-causal) run the ragged last
// key tile through the same masks.
//
// Design (simple first; tensor cores, wgmma and TMA are later work): 256
// threads a CTA.  Tiles of BM query rows and BN keys (64 and 64; 32 and 32
// at D 256, so that a thread's dK and dV rows stay in registers) are
// widened to fp32 in shared memory with a padded row stride (D + 4 floats,
// conflict-free 16-byte reads).  The score phase gives each thread a
// TM x TN block of s and dp (rows ty + 16a, keys tx + 16b) summed over D
// from float4 reads; p and ds go to shared tiles.  The output phase gives
// each thread RO rows x NC float4 columns of its output tile and walks the
// shared p / ds tile row by row.  Both passes visit only the tiles a mask
// leaves visible (the forward's skip, causal and windowed), and a
// tile's elements outside the mask get p = ds = 0.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr float kLog2e = 1.4426950408889634f;

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

// Pass 2: grid (key tiles, Hkv, B); dk and dv of BN keys of one kv head.
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

// Pass 3: grid (query tiles, H, B), the last (heaviest causal) first; dq
// of BM query rows of one head.
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

template <typename K>
cudaError_t allow_smem(K kernel, int bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

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
  const int rows = B * Sq * H;
  flash_bwd_dot<T><<<(rows + kThreads / 32 - 1) / (kThreads / 32), kThreads,
                     0, stream>>>(static_cast<const T*>(o), dop, dvp, rows,
                                  Sq, H, D);
  cudaError_t err = cudaGetLastError();
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

template <typename T>
int launch_dtype(int D, const void* q, const void* k, const void* v,
                 const void* o, const void* dout, const void* lse,
                 void* dvec, void* dq, void* dk, void* dv, int B, int Sq,
                 int Sk, int H, int Hkv, int causal, int window,
                 int q_offset, float scale, cudaStream_t s) {
  switch (D) {
#define FLASH_BWD_CASE(d)                                                  \
  case d:                                                                  \
    return launch<d, T>(q, k, v, o, dout, lse, dvec, dq, dk, dv, B, Sq,    \
                        Sk, H, Hkv, causal, window, q_offset, scale, s);
    FLASH_BWD_CASE(16)
    FLASH_BWD_CASE(32)
    FLASH_BWD_CASE(64)
    FLASH_BWD_CASE(80)
    FLASH_BWD_CASE(128)
    FLASH_BWD_CASE(256)
#undef FLASH_BWD_CASE
    default:
      return -1;
  }
}

}  // namespace

extern "C" {

// Bytes of dynamic shared memory a CTA of pass 2 (which = 0) or pass 3
// (which = 1) takes at head dim D (-1 for a D without an instantiation).
int flash_attention_bwd_smem_bytes(int which, int D) {
  switch (D) {
#define FLASH_BWD_SMEM(d) \
  case d:                 \
    return which ? Cfg<d>::SMEM_Q : Cfg<d>::SMEM_KV;
    FLASH_BWD_SMEM(16)
    FLASH_BWD_SMEM(32)
    FLASH_BWD_SMEM(64)
    FLASH_BWD_SMEM(80)
    FLASH_BWD_SMEM(128)
    FLASH_BWD_SMEM(256)
#undef FLASH_BWD_SMEM
    default:
      return -1;
  }
}

// q, o, dout, dq [B, Sq, H, D]; k, v, dk, dv [B, Sk, Hkv, D]: contiguous,
// 16-byte aligned, one type (dtype 0 fp32, 1 bf16); lse [B, H, Sq] fp32
// from the forward (natural units); dvec [B, H, Sq] fp32 scratch (pass 1
// writes it).  D one of 16, 32, 64, 80, 128, 256; H a multiple of Hkv; mask
// and scale as the forward's.  Three kernels on `stream`; returns
// cudaGetLastError() after each launch (the first failure), -1 for a bad
// dtype code or D.
int flash_attention_bwd_launch(int dtype, const void* q, const void* k,
                               const void* v, const void* o,
                               const void* dout, const void* lse,
                               void* dvec, void* dq, void* dk, void* dv,
                               int B, int Sq, int Sk, int H, int Hkv, int D,
                               int causal, int window, int q_offset,
                               float scale, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return launch_dtype<float>(D, q, k, v, o, dout, lse, dvec, dq, dk, dv,
                                 B, Sq, Sk, H, Hkv, causal, window, q_offset,
                                 scale, s);
    case 1:
      return launch_dtype<__nv_bfloat16>(D, q, k, v, o, dout, lse, dvec, dq,
                                         dk, dv, B, Sq, Sk, H, Hkv, causal,
                                         window, q_offset, scale, s);
    default:
      return -1;
  }
}

}  // extern "C"
