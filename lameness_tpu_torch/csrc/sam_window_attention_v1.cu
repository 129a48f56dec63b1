// K7: SAM ViTDet windowed attention with the decomposed rel-pos bias, on the
// head-major layout.
//
// Replaces the TPU kernel lameness_tpu/ops/sam_attention.py::_window_kernel
// (pallas_call in sam_window_attention), reached with LAMENESS_WIN_KERNEL=v1
// (any value but v2, v3 and v5), and by windows whose head-last packing
// would overflow 128 lanes (hd + 2*win > 128).  Same signature: q, k, v
// (BW, nH, N, D); rh, rw (BW, nH, N, win) q-projected tables; output
// (BW, nH, N, D).  The TPU kernel runs all heads of a window in one program
// and builds the bias by a one-hot spread matmul and a lane repeat.  Here
// K2's routes serve it at head-major strides, chosen by window_entry:
// bfloat16 at head dims 64 and 80 takes the window routine
// (window_attention.cuh: one block per (window, head), the bias contracted
// on the tensor cores from one-hot columns built in shared memory),
// anything else attention.cuh's routine.  q, k and v may be
// strided views of the qkv output: the head-major transpose is a view, not a
// copy.
//
// Bound on the card: K2's work (per (window, head) N = 196, hd = 64: 9.8
// MFLOP against ~111 KB in bf16, ~90 FLOP/byte) -- bound by bytes.
#include "attention.cuh"
#include "window_attention.cuh"

// strides: q, k, v, rh, rw, o as {window, head, token} (18 values).
extern "C" int lameness_sam_window_attention_v1(
    const void* q, const void* k, const void* v, const void* rh,
    const void* rw, void* o, int windows, int heads, int tokens,
    int head_dim, int win, const long long* strides, int dtype,
    void* stream) {
  const lameness::AttnArgs a =
      lameness::sam_args(q, k, v, rh, rw, o, tokens, heads, win,
                         1.0f / sqrtf((float)head_dim), strides);
  return lameness::window_entry(a, windows * heads, head_dim, dtype, stream);
}
