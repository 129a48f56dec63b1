// K4: SAM ViTDet global attention with the decomposed rel-pos bias, the
// LAMENESS_GLB_KERNEL=v1 kernel.
//
// Replaces the TPU kernel lameness_tpu/ops/sam_attention.py::_kernel
// (pallas_call in sam_global_attention under LAMENESS_GLB_KERNEL=v1), which
// builds bias_h by a one-hot spread matmul and bias_w by a lane repeat, one
// program per qh row of the grid.  It computes K3's function on K3's layout,
// so it shares K3's device routine (attention.cuh: rel_w in registers on the
// 64x64 grid, the per-score gather elsewhere): q, k, v (BH, N, D); rel_h
// (BH, GH, GW, GH), rel_w (BH, GH, GW, GW); output (BH, N, D).
//
// Bound on the card: K3's (per head N = 4096, D = 64: 4.3 GFLOP against
// ~3.1 MB in bf16, ~1400 FLOP/byte) -- bound by operations.  Left on the
// table: as K3.
#include "attention.cuh"

// strides: q, k, v, rel_h, rel_w, o as {head, unused, token} (18 values).
extern "C" int lameness_sam_global_attention_v1(
    const void* q, const void* k, const void* v, const void* rel_h,
    const void* rel_w, void* o, int batch_heads, int tokens, int head_dim,
    int gw, const long long* strides, int dtype, void* stream) {
  return lameness::launch<true>(
      lameness::sam_args(q, k, v, rel_h, rel_w, o, tokens, 1, gw,
                         1.0f / sqrtf((float)head_dim), strides),
      batch_heads, head_dim, dtype, stream);
}
