// K3: SAM ViTDet global attention over the 64x64 token grid with the
// decomposed rel-pos bias, never materialising the (N, N) bias.
//
// Replaces the TPU kernel lameness_tpu/ops/sam_attention.py::_global_kernel_v4
// (pallas_call in sam_global_attention_v4, reached through
// sam_global_attention).  Same signature: q, k, v (BH, N, D); rel_h
// (BH, GH, GW, GH) and rel_w (BH, GH, GW, GW) from project_rel_tables; output
// (BH, N, D).  The TPU keeps a head's whole K/V in VMEM for a one-pass
// softmax; a head's K/V here is 1 MB in bf16, far above the 227 KB of shared
// memory, so the kernel streams 64-key tiles with an online softmax and adds
// rel_h[t, j / GW] + rel_w[t, j % GW] per score element from the block's
// bias rows staged in shared memory.  The TPU's augmented operands
// (qa = [q*scale|rel_h], ka = [k|spread]) are not built.
//
// Bound on the card: per head N = 4096, D = 64: 4*N*N*D = 4.3 GFLOP against
// 4*N*D*2 + 2*N*64*2 bytes (~3.1 MB bf16), ~1400 FLOP/byte -- bound by
// operations.  The bf16 path runs on the tensor cores with mma.sync
// (attention.cuh).  Left on the table: wgmma (mma.sync reaches only part of
// the 989 TFLOP/s), TMA-fed K/V with warp specialisation, ldmatrix
// fragment loads, and a cheaper bias add than two shared-memory reads per
// score.
#include "attention.cuh"

// strides: q, k, v, rel_h, rel_w, o as {head, unused, token} (18 values).
extern "C" int lameness_sam_global_attention(
    const void* q, const void* k, const void* v, const void* rel_h,
    const void* rel_w, void* o, int batch_heads, int tokens, int head_dim,
    int gw, const long long* strides, int dtype, void* stream) {
  return lameness::launch<true>(
      lameness::sam_args(q, k, v, rel_h, rel_w, o, tokens, 1, gw,
                         1.0f / sqrtf((float)head_dim), strides),
      batch_heads, head_dim, dtype, stream);
}
