// The C entries of the SAM global attention on q, k, v and the projected
// tables -- K3 (sam_global_attention.cu), K4 (sam_global_attention_v1.cu)
// and K5 (sam_global_attention_v2.cu) compute one function on one set of
// operands -- and the one place that chooses their route by shape (a
// failed build or launch raises in the Python wrapper; nothing falls back):
//   * bfloat16, head dim 64, bias rows that fit in shared memory (square
//     grids up to 68x68, every SAM canvas up to 1088^2, and the rect
//     (36, 64) grid): the Hopper routine of hopper_attention.cuh -- wgmma
//     for QK^T and PV, K/V tiles brought in by TMA from a producer
//     warpgroup, 192 query rows per block in three consumer warpgroups;
//   * anything else (float32, head dims 16, 32, 80, 128 -- 80 is SAM ViT-H
//     -- and larger grids): the mma.sync / FMA routine of attention.cuh.
// Both routes read the tables where the rel-pos einsum leaves them, so the
// wrappers copy nothing.  The CPU emulation (scripts/emulate_cuda_kernels.py,
// LAMENESS_EMULATION) has no wgmma or TMA and always takes the second route.
#pragma once

#include "attention.cuh"
#ifndef LAMENESS_EMULATION
#include "hopper_attention.cuh"
#endif

namespace lameness {

// q, k, v, o (BH, N, D); rel_h (BH, GH, GW, GH), rel_w (BH, GH, GW, GW).
// strides (18 values): q, k, v and o as {head, unused, token}; rel_h and
// rel_w as {head, grid row, grid column}.  dtype: 0 = float32, 1 = bfloat16.
// Returns a cudaError_t as int.
inline int global_entry(const void* q, const void* k, const void* v,
                        const void* rel_h, const void* rel_w, void* o,
                        int batch_heads, int tokens, int head_dim, int gw,
                        const long long* strides, int dtype, void* stream) {
  AttnArgs a = sam_args(q, k, v, rel_h, rel_w, o, tokens, 1, gw,
                        1.0f / sqrtf((float)head_dim), strides);
  // one head per batch index: the tables' middle stride is the grid row's
  a.rh_row = a.rh_s[1];
  a.rw_row = a.rw_s[1];
  a.rh_s[1] = a.rw_s[1] = 0;
#ifndef LAMENESS_EMULATION
  if (hopper_global_takes(a, batch_heads, head_dim, dtype))
    return launch_hopper_global(a, batch_heads, stream);
#endif
  return launch<true>(a, batch_heads, head_dim, dtype, stream);
}

}  // namespace lameness
