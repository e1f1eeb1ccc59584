// bf16 tensor-core building blocks for Hopper (sm_90a), shared by the
// grouped matmul (moe_gmm.cu) and flash attention (flash_attention.cu):
// 16-byte cp.async copies into shared memory, ldmatrix fragment loads and
// the mma.sync m16n8k16 product with fp32 accumulators, as raw PTX.
//
// Fragment layouts of mma.sync.m16n8k16 (lane = 4 * g + t, g = lane / 4,
// t = lane % 4), each 32-bit register holding two bf16 with the lower
// column in the low half:
//   A (16 x 16, row major): a0 (row g, cols 2t, 2t+1), a1 (row g + 8),
//     a2 (row g, cols 2t + 8, 2t + 9), a3 (row g + 8, cols 2t + 8, +9);
//   B (16 x 8, k x n):      b0 (k 2t, 2t+1; n g), b1 (k 2t + 8, +9; n g);
//   C/D (16 x 8, fp32):     c0, c1 (row g, cols 2t, 2t+1), c2, c3 (row
//     g + 8).
// ldmatrix.x4 loads four 8 x 8 bf16 matrices; lanes 8i .. 8i + 7 give the
// row addresses of matrix i, whose register i then holds (row g, cols 2t,
// 2t + 1), or with .trans (rows 2t, 2t + 1, col g) of the matrix as stored.
// bf16 x bf16 products are exact in fp32; the sums are fp32.
#pragma once

#include <cuda_bf16.h>

namespace tc {

using bf16 = __nv_bfloat16;

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// 16 bytes from global src to shared dst; only the first src_bytes are
// read, the rest of the 16 are zero-filled (0 reads nothing: a ragged
// edge costs no branch).  Both addresses 16-byte aligned.
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Waits until at most n of this thread's committed groups are in flight.
template <int n>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(n) : "memory");
}

__device__ __forceinline__ void ldsm_x4(unsigned (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldsm_x4_trans(unsigned (&r)[4],
                                              const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

// Two matrices: lanes 0-15 give the row addresses.
__device__ __forceinline__ void ldsm_x2(unsigned (&r)[2], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(smem_addr(p)));
}

// d += a . b on the tensor cores: bf16 operands, fp32 accumulators.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const unsigned (&a)[4],
                                         unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ unsigned as_u32(__nv_bfloat162 v) {
  return *reinterpret_cast<unsigned*>(&v);
}

// Two fp32 values as one register of bf16 (x0 in the low half).
__device__ __forceinline__ unsigned pack_bf16(float x0, float x1) {
  return as_u32(__floats2bfloat162_rn(x0, x1));
}

// Two fp32 values split into bf16 hi = bf16(x) and lo = bf16(x - hi), so
// that hi + lo is within 2^-16 of x (bf16 keeps 8 significant bits: lo's
// rounding is off by 2^-8 of the up to 2^-8 of x that hi leaves): two
// products with the same bf16 operand then give x's product to that
// error, where one bf16 rounding of x is off by up to 2^-8.
__device__ __forceinline__ void split_bf16(float x0, float x1, unsigned& hi,
                                           unsigned& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
  const float2 hf = __bfloat1622float2(h);
  hi = as_u32(h);
  lo = pack_bf16(x0 - hf.x, x1 - hf.y);
}

}  // namespace tc
