// K9: SAM ViTDet windowed attention on augmented operands, head-last.
//
// Replaces the TPU kernel lameness_tpu/ops/sam_attention.py::_window_kernel_v5
// (pallas_call in sam_window_attention_v5), reached with
// LAMENESS_WIN_KERNEL=v5 where hd + 2*win <= 128.  K8's function on the
// layouts of the qkv output: the wrapper builds qa = [q4*scale | rh4 | rw4]
// and ka = [k4 | spread^T | mod^T] as (BW, N, nH, A), A padded with zeros to
// a multiple of 8; v4 (BW, N, nH, hd) is read in place; the output is
// (BW, N, nH*hd).  The TPU kernel pipelines its head loop (head h's QK^T
// issued before head h-1's softmax and PV) and folds the softmax
// denominator in after PV; here every block is independent and the online
// softmax always applies the denominator after PV.  Same device routine as
// K8 (attention.cuh).
//
// Bound on the card: as K8 -- bound by bytes.  Left on the table: as K2.
#include "attention.cuh"

// strides: qa, ka, v, (unused), (unused), o as {outer, head, token} (18
// values); qa and ka hold qk_width columns (a multiple of 8), v and o
// head_dim.
extern "C" int lameness_sam_window_attention_v5(
    const void* qa, const void* ka, const void* v, void* o, int outer,
    int heads, int tokens, int head_dim, int qk_width,
    const long long* strides, int dtype, void* stream) {
  lameness::AttnArgs a = lameness::sam_args(qa, ka, v, nullptr, nullptr, o,
                                            tokens, heads, 0, 1.0f, strides);
  a.qk_width = qk_width;
  return lameness::launch_augmented(a, outer * heads, head_dim, dtype,
                                    stream);
}
