// K8: SAM ViTDet windowed attention as batched augmented attention,
// head-major.
//
// Replaces the TPU kernel lameness_tpu/ops/sam_attention.py::_window_kernel_v2
// (pallas_call in sam_window_attention_v2), reached with
// LAMENESS_WIN_KERNEL=v2.  The bias rh[t, j / win] + rw[t, j % win] is a
// rank-2*win correction, folded into the contraction: the wrapper builds, as
// the JAX entry does, qa = [q*scale | rh | rw] and ka = [k | spread^T |
// mod^T] (BW, nH, N, A) with one-hot spread^T[j, r] = (j / win == r) and
// mod^T[j, c] = (j % win == c); A = hd + 2*win (92 for SAM's 14x14 windows
// at hd 64), padded with zeros to a multiple of 8.  The kernel is the shared
// routine of attention.cuh with no bias at DQK = A rounded up to 16 (96) and
// DV = hd.  v (BW, nH, N, hd); output (BW, nH, N, hd).
//
// Bound on the card: K2's work (~90 FLOP/byte at N = 196, hd = 64 in bf16)
// -- bound by bytes; the augmented QK^T does 1.5x K2's QK products (96
// against 64 columns) in exchange for no per-score bias gather.  Left on the
// table: as K2.
#include "attention.cuh"

// strides: qa, ka, v, (unused), (unused), o as {outer, head, token} (18
// values); qa and ka hold qk_width columns (a multiple of 8), v and o
// head_dim.
extern "C" int lameness_sam_window_attention_v2(
    const void* qa, const void* ka, const void* v, void* o, int outer,
    int heads, int tokens, int head_dim, int qk_width,
    const long long* strides, int dtype, void* stream) {
  lameness::AttnArgs a = lameness::sam_args(qa, ka, v, nullptr, nullptr, o,
                                            tokens, heads, 0, 1.0f, strides);
  a.qk_width = qk_width;
  return lameness::launch_augmented(a, outer * heads, head_dim, dtype,
                                    stream);
}
