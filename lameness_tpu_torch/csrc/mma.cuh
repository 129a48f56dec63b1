// Warp-level primitives of the bf16 attention kernel (attention.cuh):
// the m16n8k16 tensor-core product, cp.async copies into shared memory,
// bf16 packing and a butterfly shuffle.  Kept apart so that the kernel body
// reads as plain C++ over these few names.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace lameness {

// d += a · b on the tensor cores: a is a 16x16 bf16 row-major fragment
// (4 registers), b a 16x8 bf16 column-major fragment (2 registers), d a
// 16x8 f32 fragment.  Lane l holds rows l/4 and l/4 + 8, columns
// 2·(l%4) + {0, 1} (PTX ISA, "mma.m16n8k16" fragment layouts).
__device__ __forceinline__ void mma_bf16_16816(float (&d)[4],
                                               const uint32_t (&a)[4],
                                               uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Four 8x8 bf16 matrices from shared memory: lanes 8i..8i+7 give the row
// addresses (16 bytes each) of matrix i, and r[i] of lane l holds row l/4,
// columns 2·(l%4) + {0, 1} of it -- the B fragment layout of K^T.
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4],
                                            const void* row) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(row));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a));
}

// The same, transposed: r[i] of lane l holds rows 2·(l%4) + {0, 1},
// column l/4 of matrix i -- the B fragment layout of V.
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const void* row) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(row));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a));
}

// 16 bytes from global to shared memory, asynchronously; zeros when
// !valid (gmem must still be a valid address).
__device__ __forceinline__ void cp_async_16(void* smem, const void* gmem,
                                            bool valid) {
  const uint32_t dst = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  const int n = valid ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(gmem), "r"(n));
}

// 4 bytes, through L1 (.ca: the only variant below 16 bytes); zeros when
// !valid.  For rows that are 4-byte aligned only (the window routine's bias
// tables).
__device__ __forceinline__ void cp_async_4(void* smem, const void* gmem,
                                           bool valid) {
  const uint32_t dst = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  const int n = valid ? 4 : 0;
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst),
               "l"(gmem), "r"(n));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// wait until at most N committed groups are still in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// two floats -> one register of two bf16, lo in the low half
__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

__device__ __forceinline__ float shfl_xor(float v, int mask) {
  return __shfl_xor_sync(0xffffffffu, v, mask);
}

}  // namespace lameness
