// K4: SAM ViTDet global attention with the decomposed rel-pos bias, the
// LAMENESS_GLB_KERNEL=v1 kernel.
//
// Replaces the TPU kernel lameness_tpu/ops/sam_attention.py::_kernel
// (pallas_call in sam_global_attention under LAMENESS_GLB_KERNEL=v1), which
// builds bias_h by a one-hot spread matmul and bias_w by a lane repeat, one
// program per qh row of the grid.  It computes K3's function on K3's
// operands, so it takes K3's routes (global_attention.cuh): q, k, v
// (BH, N, D); rel_h (BH, GH, GW, GH), rel_w (BH, GH, GW, GW) where the
// einsum leaves them; output (BH, N, D).  bf16 at head dim 64 and 80 (SAM
// ViT-B and ViT-H) runs the Hopper routine (hopper_attention.cuh: wgmma,
// TMA), the rest attention.cuh.
//
// Bound on the card: K3's (per head N = 4096, D = 64: 4.3 GFLOP against
// ~3.1 MB in bf16, ~1400 FLOP/byte) -- bound by operations.  Left on the
// table: as K3.
#include "global_attention.cuh"

extern "C" int lameness_sam_global_attention_v1(
    const void* q, const void* k, const void* v, const void* rel_h,
    const void* rel_w, void* o, int batch_heads, int tokens, int head_dim,
    int gw, const long long* strides, int dtype, void* stream) {
  return lameness::global_entry(q, k, v, rel_h, rel_w, o, batch_heads, 1,
                                tokens, head_dim, gw, strides, dtype, stream);
}
