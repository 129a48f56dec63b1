// K5: SAM ViTDet global attention on augmented operands, head-major.
//
// Replaces the TPU kernel lameness_tpu/ops/sam_attention.py::_global_kernel_v2
// (pallas_call in sam_global_attention_v2), reached with
// LAMENESS_GLB_KERNEL set to any value but v1 and v4 (v3 when hd + G > 128).
// The wrapper builds, as the JAX entry does, qa = [q*scale | rel_h] and
// ka = [k | spread^T] (BH, N, A) with spread^T[j, r] = 1 iff j / GW == r, so
// that qa . ka^T = scale*q.k^T + rel_h[t, j / GW]; A = D + GH, padded with
// zeros to a multiple of 8.  The kernel adds rel_w[t, j % GW] per score (in
// registers on the 64x64 grid), with the shared routine of attention.cuh at
// DQK = A rounded up to 16 and DV = D.  v (BH, N, D); output (BH, N, D).
//
// Bound on the card: the function is K3's (per head N = 4096, D = 64:
// 4.3 GFLOP, ~1400 FLOP/byte in bf16) -- bound by operations.  The
// contraction runs over A = 128 instead of D = 64 at SAM ViT-B's shapes:
// QK^T costs twice K3's and PV the same, so the tensor cores do 1.5x the
// products of K3 in exchange for no per-score rel_h add.  Left on the
// table: as K3.
#include "attention.cuh"

// strides: qa, ka, v, (unused), rw, o as {outer, head, token} (18 values);
// qa and ka hold qk_width columns (a multiple of 8), v and o head_dim.
extern "C" int lameness_sam_global_attention_v2(
    const void* qa, const void* ka, const void* v, const void* rw, void* o,
    int outer, int heads, int tokens, int head_dim, int qk_width, int gw,
    const long long* strides, int dtype, void* stream) {
  lameness::AttnArgs a = lameness::sam_args(qa, ka, v, nullptr, rw, o,
                                            tokens, heads, gw, 1.0f, strides);
  a.qk_width = qk_width;
  return lameness::launch_augmented<true>(a, outer * heads, head_dim, dtype,
                                          stream);
}
