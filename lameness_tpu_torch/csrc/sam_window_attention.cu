// K2: SAM ViTDet windowed attention with the decomposed rel-pos bias.
//
// Replaces the TPU kernel lameness_tpu/ops/sam_attention.py::_window_kernel_v3
// (pallas_call in sam_window_attention_v3).  Same head-last signature: q, k, v
// are (BW, N, nH, hd) slices of the fused qkv output, read in place through
// their strides; rh, rw are (BW, N, nH, win) q-projected tables; the output
// is (BW, N, nH*hd).  Pad tokens of the edge windows take part unmasked, as
// in the reference ViTDet.
//
// Bound on the card: per (window, head) N = 196, hd = 64: 4*N*N*hd = 9.8
// MFLOP against ~4*N*hd*2 + 2*N*win*2 bytes (~111 KB bf16), ~90 FLOP/byte --
// bound by bytes: 0.22 ms for the engine's 550 x 12 window-heads (ViT-B),
// 0.36 ms for ViT-H's 550 x 16 at hd 80.
//
// Routes, chosen by shape in window_entry (window_attention.cuh), the one
// choice of K2, K7, K8 and K9 (a failed launch raises in the Python wrapper;
// nothing falls back):
//   * bfloat16, head dim 64 or 80, windows of <= 256 tokens (every SAM
//     window): the window routine of window_attention.cuh -- one block per
//     (window, head) with the window's K and V in shared memory, loaded
//     once by cp.async;
//     the bias contracted on the tensor cores as the TPU kernel does on the
//     MXU, [q | rh | rw] against [k | spread^T | mod^T] (the one-hot columns
//     built in shared memory, never read from HBM); a one-pass softmax;
//   * anything else (float32, head dims 16, 32, 128): the online-softmax
//     routine of attention.cuh, adding rh[t, j / win] + rw[t, j % win] per
//     score.
#include "attention.cuh"
#include "window_attention.cuh"

// strides: q, k, v, rh, rw, o as {window, head, token} (18 values); the
// output o is addressed as (BW, N, nH, hd).
extern "C" int lameness_sam_window_attention(
    const void* q, const void* k, const void* v, const void* rh,
    const void* rw, void* o, int windows, int heads, int tokens,
    int head_dim, int win, const long long* strides, int dtype,
    void* stream) {
  const lameness::AttnArgs a =
      lameness::sam_args(q, k, v, rh, rw, o, tokens, heads, win,
                         1.0f / sqrtf((float)head_dim), strides);
  return lameness::window_entry(a, windows * heads, head_dim, dtype, stream);
}
