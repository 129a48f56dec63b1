// K5: SAM ViTDet global attention, head-major, on the entry's own operands.
//
// Replaces the TPU kernel lameness_tpu/ops/sam_attention.py::_global_kernel_v2
// (pallas_call in sam_global_attention_v2), reached with
// LAMENESS_GLB_KERNEL set to any value but v1 and v4 (v3 when hd + G > 128).
// The TPU entry builds qa = [q*scale | rel_h] and ka = [k | spread^T] so that
// rel_h rides in one K = 128 MXU contraction, which the MXU pads to anyway.
// On the card that doubles QK^T and writes two (BH, N, 128) operands to HBM,
// so this kernel takes what K3 takes: q, k, v (BH, N, D), rh (BH, GH, GW, GH)
// and rw (BH, GH, GW, GW), the projected tables in q's dtype, and adds
// rh[t, j / GW] + rw[t, j % GW] per score.  The function is the same; only
// the rounding points differ from the TPU's (rh is rounded to the compute
// dtype by the caller, p is normalised after PV), inside the parity gates.
//
// Bounds on the card, per head N = 4096, D = 64 (SAM ViT-B 1024^2):
//   * tensor cores: 4*N*N*D = 4.3 GFLOP, ~1400 FLOP/byte in bf16: at
//     989 TFLOP/s, 1.15 ms for the engine's 264 heads;
//   * exponentials: N*N = 16.8M exp2 per head, 4.4e9 for 264 heads, at 16 per
//     clock per SM on 132 SMs (~1.8 GHz): ~1.2 ms, as long as the products.
// A kernel that runs the softmax and the products in series cannot go below
// ~2.4 ms.  The design hides the products behind the softmax: PV of one
// tile runs while the same warpgroup's softmax of the next runs, and three
// warpgroups issue their products in turn (ping-pong); the row sums go to
// the tensor cores and the softmax's FP32 work is kept small.  3.13 ms on
// the H100, bound by the softmax (PERF.md).
//
// Routes (global_attention.cuh, shared with K3 and K4, which compute the
// same function on the same operands, bit for bit): bf16 at head dim 64 or
// 80 (SAM ViT-H) with bias rows that fit in shared memory takes the Hopper
// kernel of hopper_attention.cuh -- wgmma for QK^T and PV, K/V tiles brought
// in by TMA from a producer warpgroup, 64 query rows per consumer warpgroup
// (three at hd 64, two at hd 80); float32 and the other head dims the
// mma.sync / FMA routine of attention.cuh.
#include "global_attention.cuh"

extern "C" int lameness_sam_global_attention_v2(
    const void* q, const void* k, const void* v, const void* rh,
    const void* rw, void* o, int batch_heads, int tokens, int head_dim,
    int gw, const long long* strides, int dtype, void* stream) {
  return lameness::global_entry(q, k, v, rh, rw, o, batch_heads, 1, tokens,
                                head_dim, gw, strides, dtype, stream);
}
