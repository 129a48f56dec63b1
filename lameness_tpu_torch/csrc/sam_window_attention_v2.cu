// K8: SAM ViTDet windowed attention with the decomposed rel-pos bias,
// head-major, as K7's function.
//
// Replaces the TPU kernel lameness_tpu/ops/sam_attention.py::_window_kernel_v2
// (pallas_call in sam_window_attention_v2), reached with
// LAMENESS_WIN_KERNEL=v2.  The TPU kernel is batched attention on augmented
// operands that its entry builds in HBM: qa = [q*scale | rh | rw] against
// ka = [k | spread^T | mod^T], so that qa·ka^T carries the bias.  Here that
// contraction runs in shared memory: K7's signature (q, k, v (BW, nH, N, D);
// rh, rw (BW, nH, N, win) q-projected tables; output (BW, nH, N, D)), read
// where the engine's head-major path leaves them, and window_entry
// (window_attention.cuh) chooses the route.  In bfloat16 at head dim 64 or
// 80 the window routine forms [q | rh | rw] and [k | c·spread^T | c·mod^T]
// (c = 1/scale at hd 64, 1 at hd 80) in a block's shared memory; nothing is
// built in HBM, and the output is K7's bit for bit.  Float32, other head dims and windows past 16 x 16 take
// attention.cuh's per-score bias routine.
//
// The TPU kernel's scheduling has no counterpart: it runs several windows'
// heads per program (LAMENESS_SAM_WPP) to fill the MXU and amortise the
// grid step; on the card one block per (window, head) already keeps two
// blocks on every SM, and LAMENESS_SAM_WPP is not read.
//
// Bound on the card: K7's work, per (window, head) at N = 196, hd = 64: 9.8
// MFLOP against ~111 KB in bf16, ~90 FLOP/byte -- bound by bytes: 0.2193 ms
// for the engine's 550 x 12 window-heads at 3.35 TB/s.  Left on the table:
// the window routine's loads and products add up instead of overlapping
// (PERF.md §7).
#include "attention.cuh"
#include "window_attention.cuh"

// strides: q, k, v, rh, rw, o as {window, head, token} (18 values).
extern "C" int lameness_sam_window_attention_v2(
    const void* q, const void* k, const void* v, const void* rh,
    const void* rw, void* o, int windows, int heads, int tokens,
    int head_dim, int win, const long long* strides, int dtype,
    void* stream) {
  const lameness::AttnArgs a =
      lameness::sam_args(q, k, v, rh, rw, o, tokens, heads, win,
                         1.0f / sqrtf((float)head_dim), strides);
  return lameness::window_entry(a, windows * heads, head_dim, dtype, stream);
}
