// Flash attention (forward) for Hopper (sm_90a): q [B, Sq, H, D] against
// k, v [B, Sk, Hkv, D], causal or not, with an optional sliding window and
// grouped kv heads (query head h reads kv head h / G, G = H / Hkv).
//
// Replaces the Pallas TPU kernel flash_attention_tpu
// (repro/kernels/flash_attention.py:84).  The port calls it for the
// non-causal attention of the multimodal encoder's trunk
// (models/mm_encoder.py, fp32, D 448 at qwen2-0.5b's width with two
// heads) and for the causal attention of the monolithic forward
// (models/lm.py:_attn_layer), which the draft model's bucketed prefill
// runs on the speculative path.
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
// the 67 TFLOP/s fp32 rate (20 flops per byte at 3.35 TB/s).  This first
// version is simple and right: fp32 products on the CUDA cores from
// shared memory, no tensor cores (no wgmma, no TMA).  Against the Pallas
// grid (B, H, q blocks, k blocks) with the k axis sequential and the
// running (m, l, acc) in VMEM scratch:
//   * the grid is (tile of kRows query rows, head, batch); a loop inside
//     the CTA walks the key tiles in order, which takes the place of the
//     TPU's sequential k axis, and keeps (m, l, acc) in shared memory;
//   * the loop covers only the key tiles the tile's rows can see: from
//     the first tile inside the window of its earliest row to the tile of
//     its latest row when causal (the Pallas kernel's pl.when(live_block)
//     skip), so a causal prefill does about half the tiles;
//   * each [kCols, D] K and V tile is staged in shared memory once for all
//     kRows rows, with 16-byte loads, K padded to D + 1 floats a row so
//     that threads reading different keys hit different banks;
//   * the ragged edges of Sq and Sk are masked per element: no host-side
//     padding or transposed copy; q, k and v are read in place.
// Later work: mma/wgmma tensor-core tiles of 64 rows, TMA/cp.async double
// buffering, one CTA per kv head for all G query heads.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

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

}  // namespace

extern "C" {

// Bytes of dynamic shared memory one CTA needs for head dim D; the
// wrapper checks it against the card's 227 KB before launching.
int flash_attention_smem_bytes(int D) {
  return static_cast<int>(sizeof(float)) * smem_floats(D);
}

// Query rows one CTA takes.
int flash_attention_tile_rows() { return kRows; }

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
      return launch<__nv_bfloat16>(q, k, v, out, B, Sq, Sk, H, Hkv, D,
                                   causal, window, q_offset, scale, s);
    default:
      return -1;
  }
}

}  // extern "C"
