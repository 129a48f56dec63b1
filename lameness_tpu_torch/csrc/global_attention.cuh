// The C entries of the SAM global attention on q, k, v and the projected
// tables -- K3 (sam_global_attention.cu), K4 (sam_global_attention_v1.cu)
// and K5 (sam_global_attention_v2.cu) compute one function on one set of
// operands, K6 (sam_global_attention_v3.cu) the same function on head-last
// views of the qkv output -- and the one place that chooses their route by
// shape (a failed build or launch raises in the Python wrapper; nothing
// falls back):
//   * bfloat16, head dim 64 or 80 (SAM ViT-B and ViT-H), bias rows that
//     fit in shared memory (at hd 64 square grids up to 68x68, at hd 80 up
//     to 83x83: every SAM canvas up to 1088^2 and 1328^2, and the rect
//     (36, 64) grid): the Hopper routine of hopper_attention.cuh -- wgmma
//     for QK^T and PV, K/V tiles brought in by TMA from a producer
//     warpgroup, 64 query rows per consumer warpgroup (three at hd 64, two
//     at hd 80);
//   * anything else (float32, head dims 16, 32, 128, and larger grids):
//     the mma.sync / FMA routine of attention.cuh.
// Both routes read q, k, v and the tables where the qkv Linear and the
// rel-pos einsum leave them, so the wrappers copy nothing.  The CPU
// emulation (scripts/emulate_cuda_kernels.py, LAMENESS_EMULATION) has no
// wgmma or TMA and always takes the second route.
#pragma once

#include "attention.cuh"
#ifndef LAMENESS_EMULATION
#include "hopper_attention.cuh"
#endif

namespace lameness {

// q, k, v, o (outer, heads, N, D) and the tables at {outer, head, ·}
// element strides (18 values: q, k, v, rel_h, rel_w, o).
//   * heads == 1 (K3-K5): q, k, v and o as {head, unused, token}; rel_h
//     (BH, GH, GW, GH) and rel_w (BH, GH, GW, GW) as {head, grid row, grid
//     column}: the middle stride moves into rh_row / rw_row;
//   * heads > 1 (K6): every tensor as {outer, head, token}; the tables are
//     token-major, so sam_args' rh_row = GW·rh_s[2] holds and the staging
//     takes the evenly spaced loop.
// dtype: 0 = float32, 1 = bfloat16.  Returns a cudaError_t as int.
inline int global_entry(const void* q, const void* k, const void* v,
                        const void* rel_h, const void* rel_w, void* o,
                        int outer, int heads, int tokens, int head_dim, int gw,
                        const long long* strides, int dtype, void* stream) {
  AttnArgs a = sam_args(q, k, v, rel_h, rel_w, o, tokens, heads, gw,
                        1.0f / sqrtf((float)head_dim), strides);
  if (heads == 1) {
    a.rh_row = a.rh_s[1];
    a.rw_row = a.rw_s[1];
    a.rh_s[1] = a.rw_s[1] = 0;
  }
#ifndef LAMENESS_EMULATION
  if (hopper_global_takes(a, outer * heads, head_dim, dtype))
    return head_dim == 80 ? launch_hopper_global<80>(a, outer, stream)
                          : launch_hopper_global<64>(a, outer, stream);
#endif
  return launch<true>(a, outer * heads, head_dim, dtype, stream);
}

}  // namespace lameness
