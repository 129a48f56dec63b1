// Host emulation of ../mma.cuh: the same names and fragment layouts, the
// warp's lanes exchanging registers through emu_lane_* and warp barriers.
#pragma once
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace lameness {

inline float emu_half(uint32_t reg, int hi) {
  return __bfloat162float({(uint16_t)(hi ? reg >> 16 : reg & 0xffffu)});
}

inline void mma_bf16_16816(float (&d)[4], const uint32_t (&a)[4],
                           uint32_t b0, uint32_t b1) {
  const int w = threadIdx.x / 32, l = threadIdx.x % 32;
  uint32_t* mine = emu_lane_regs[w][l];
  for (int i = 0; i < 4; ++i) mine[i] = a[i];
  mine[4] = b0;
  mine[5] = b1;
  emu_warp_sync();
  float r[4];
  for (int i = 0; i < 4; ++i) {
    const int row = l / 4 + (i >= 2) * 8, col = 2 * (l % 4) + (i & 1);
    double sum = d[i];
    for (int k = 0; k < 16; ++k) {
      // A (row, k): lane (row % 8)·4 + (k % 8)/2, register (row >= 8) +
      // 2·(k >= 8); B (k, col): lane col·4 + (k % 8)/2, register k >= 8
      const uint32_t ra =
          emu_lane_regs[w][(row % 8) * 4 + (k % 8) / 2][(row >= 8) + 2 * (k >= 8)];
      const uint32_t rb = emu_lane_regs[w][col * 4 + (k % 8) / 2][4 + (k >= 8)];
      sum += (double)emu_half(ra, k & 1) * emu_half(rb, k & 1);
    }
    r[i] = (float)sum;
  }
  emu_warp_sync();
  for (int i = 0; i < 4; ++i) d[i] = r[i];
}

template <bool TRANS>
inline void emu_ldmatrix(uint32_t (&r)[4], const void* row) {
  const int w = threadIdx.x / 32, l = threadIdx.x % 32;
  emu_lane_ptrs[w][l] = row;
  emu_warp_sync();
  auto at = [](const void* p, int col) {
    uint16_t v;
    std::memcpy(&v, static_cast<const char*>(p) + 2 * col, 2);
    return (uint32_t)v;
  };
  for (int i = 0; i < 4; ++i) {
    const void* const* rows = emu_lane_ptrs[w] + 8 * i;
    const int t = l % 4;
    r[i] = TRANS ? at(rows[2 * t], l / 4) | (at(rows[2 * t + 1], l / 4) << 16)
                 : at(rows[l / 4], 2 * t) | (at(rows[l / 4], 2 * t + 1) << 16);
  }
  emu_warp_sync();
}
inline void ldmatrix_x4(uint32_t (&r)[4], const void* row) {
  emu_ldmatrix<false>(r, row);
}
inline void ldmatrix_x4_trans(uint32_t (&r)[4], const void* row) {
  emu_ldmatrix<true>(r, row);
}

inline void cp_async_16(void* smem, const void* gmem, bool valid) {
  if (valid)
    std::memcpy(smem, gmem, 16);
  else
    std::memset(smem, 0, 16);
}
inline void cp_async_4(void* smem, const void* gmem, bool valid) {
  if (valid)
    std::memcpy(smem, gmem, 4);
  else
    std::memset(smem, 0, 4);
}
inline void cp_async_commit() {}
template <int N>
inline void cp_async_wait() {}

inline uint32_t pack_bf16x2(float lo, float hi) {
  return (uint32_t)__float2bfloat16(lo).x |
         ((uint32_t)__float2bfloat16(hi).x << 16);
}

inline float shfl_xor(float v, int mask) {
  const int w = threadIdx.x / 32, l = threadIdx.x % 32;
  emu_lane_floats[w][l] = v;
  emu_warp_sync();
  const float r = emu_lane_floats[w][l ^ mask];
  emu_warp_sync();
  return r;
}

// the kernels' dynamic shared memory
extern __shared__ __align__(16) unsigned char mma_smem[];
extern __shared__ float smem[];

}  // namespace lameness
