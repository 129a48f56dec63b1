// K2: SAM ViTDet windowed attention with the decomposed rel-pos bias.
//
// Replaces the TPU kernel lameness_tpu/ops/sam_attention.py::_window_kernel_v3
// (pallas_call in sam_window_attention_v3).  Same head-last signature: q, k, v
// are (BW, N, nH, hd) slices of the fused qkv output, read in place through
// their strides; rh, rw are (BW, N, nH, win) q-projected tables; the output
// is (BW, N, nH*hd).  The TPU's augmented operands [q*scale|rh|rw] /
// [k|one-hot] only fed its 128-deep MXU and are not built: the bias
// rh[t, j / win] + rw[t, j % win] is added per score element.  Pad tokens of
// the edge windows take part unmasked, as in the reference ViTDet.
//
// Bound on the card: per (window, head) N = 196, hd = 64: 4*N*N*hd = 9.8
// MFLOP against ~4*N*hd*2 + 2*N*win*2 bytes (~111 KB bf16), ~90 FLOP/byte --
// bound by bytes.  The bf16 path runs on the tensor cores (attention.cuh).
// Left on the table: 196 rows fill 4 64-row q blocks and 4 64-key tiles
// (23% padding each way); each q block re-stages the window's K/V and its
// bias rows; the per-element bias gather from shared memory costs about as
// many instructions as the products.
#include "attention.cuh"

// strides: q, k, v, rh, rw, o as {window, head, token} (18 values); the
// output o is addressed as (BW, N, nH, hd).
extern "C" int lameness_sam_window_attention(
    const void* q, const void* k, const void* v, const void* rh,
    const void* rw, void* o, int windows, int heads, int tokens,
    int head_dim, int win, const long long* strides, int dtype,
    void* stream) {
  return lameness::launch<true>(
      lameness::sam_args(q, k, v, rh, rw, o, tokens, heads, win,
                         1.0f / sqrtf((float)head_dim), strides),
      windows * heads, head_dim, dtype, stream);
}
