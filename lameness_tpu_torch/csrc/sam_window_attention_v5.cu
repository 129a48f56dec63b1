// K9: SAM ViTDet windowed attention with the decomposed rel-pos bias,
// head-last, as K2's function.
//
// Replaces the TPU kernel lameness_tpu/ops/sam_attention.py::_window_kernel_v5
// (pallas_call in sam_window_attention_v5), reached with
// LAMENESS_WIN_KERNEL=v5 where hd + 2*win <= 128.  The TPU kernel runs K8's
// augmented contraction, qa = [q4*scale | rh4 | rw4] against ka = [k4 |
// spread^T | mod^T] built by its entry in HBM, on the layouts of the qkv
// output, and applies the softmax denominator after PV.  Here that
// contraction runs in shared memory: K2's signature (q4, k4, v4 (BW, N, nH,
// hd) slices of the fused qkv output; rh4, rw4 (BW, N, nH, win) as
// project_rel_tables_hl leaves them; output (BW, N, nH*hd)), read in place,
// and window_entry (window_attention.cuh) chooses the route.  In bfloat16 at
// head dim 64 or 80 the window routine forms the augmented columns in a
// block's shared memory; nothing is built in HBM, and the output is K2's bit
// for bit (the routine, too, divides after PV).  Float32, other head dims and
// windows past 16 x 16 take attention.cuh's per-score bias routine.
//
// The TPU kernel's scheduling has no counterpart: several windows per
// program (LAMENESS_SAM_WPP5) and a software-pipelined head loop (head h's
// QK^T on the MXU issued before head h-1's softmax and PV on the VPU) keep
// one core's units busy in turn.  On the card one block per (window, head)
// keeps two blocks on every SM, whose warps overlap one another's products
// and softmax; LAMENESS_SAM_WPP5 is not read.
//
// Bound on the card: K2's work, per (window, head) at N = 196, hd = 64: 9.8
// MFLOP against ~111 KB in bf16, ~90 FLOP/byte -- bound by bytes: 0.2193 ms
// for the engine's 550 x 12 window-heads at 3.35 TB/s.  Left on the table:
// the window routine's loads and products add up instead of overlapping
// (PERF.md §7).
#include "attention.cuh"
#include "window_attention.cuh"

// strides: q, k, v, rh, rw, o as {window, head, token} (18 values); the
// output o is addressed as (BW, N, nH, hd).
extern "C" int lameness_sam_window_attention_v5(
    const void* q, const void* k, const void* v, const void* rh,
    const void* rw, void* o, int windows, int heads, int tokens,
    int head_dim, int win, const long long* strides, int dtype,
    void* stream) {
  const lameness::AttnArgs a =
      lameness::sam_args(q, k, v, rh, rw, o, tokens, heads, win,
                         1.0f / sqrtf((float)head_dim), strides);
  return lameness::window_entry(a, windows * heads, head_dim, dtype, stream);
}
