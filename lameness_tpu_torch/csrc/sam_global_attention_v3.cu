// K6: SAM ViTDet global attention on augmented operands, head-last.
//
// Replaces the TPU kernel lameness_tpu/ops/sam_attention.py::_global_kernel_v3
// (pallas_call in sam_global_attention_v3), reached with
// LAMENESS_GLB_KERNEL=v3 where hd + G <= 128.  K5's function on the layouts
// of the qkv output: the wrapper builds qa = [q4*scale | rh4] and
// ka = [k4 | spread^T] as (B, N, nH, A), A = hd + GH padded with zeros to a
// multiple of 8; v4 (B, N, nH, hd) is read in place from the qkv output and
// rw4 (B, N, nH, GW) as projected; the output is (B, N, nH*hd).  The TPU
// pads every head's slice of qa, ka, rw and v to 128 lanes so that its grid
// can select a head by lane block; here the kernel takes per-tensor
// {image, head, token} strides and nothing is padded beyond A.  Same device
// routine as K5 (attention.cuh).
//
// Bound on the card: as K5 -- bound by operations.  Left on the table: as
// K3.
#include "attention.cuh"

// strides: qa, ka, v, (unused), rw, o as {outer, head, token} (18 values);
// qa and ka hold qk_width columns (a multiple of 8), v and o head_dim.
extern "C" int lameness_sam_global_attention_v3(
    const void* qa, const void* ka, const void* v, const void* rw, void* o,
    int outer, int heads, int tokens, int head_dim, int qk_width, int gw,
    const long long* strides, int dtype, void* stream) {
  lameness::AttnArgs a = lameness::sam_args(qa, ka, v, nullptr, rw, o,
                                            tokens, heads, gw, 1.0f, strides);
  a.qk_width = qk_width;
  return lameness::launch_augmented<true>(a, outer * heads, head_dim, dtype,
                                          stream);
}
