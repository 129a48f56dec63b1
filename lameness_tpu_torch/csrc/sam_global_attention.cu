// K3: SAM ViTDet global attention over the 64x64 token grid with the
// decomposed rel-pos bias, never materialising the (N, N) bias.
//
// Replaces the TPU kernel lameness_tpu/ops/sam_attention.py::_global_kernel_v4
// (pallas_call in sam_global_attention_v4, reached through
// sam_global_attention).  Same signature: q, k, v (BH, N, D); rel_h
// (BH, GH, GW, GH) and rel_w (BH, GH, GW, GW) from project_rel_tables, read
// where the einsum leaves them; output (BH, N, D).  The TPU keeps a head's
// whole K/V in VMEM for a one-pass softmax; a head's K/V here is 1 MB in
// bf16, far above the 227 KB of shared memory, so the kernel streams key
// tiles with an online softmax and adds rel_h[t, j / GW] + rel_w[t, j % GW]
// per score from the block's bias rows staged in shared memory.  The TPU's
// augmented operands (qa = [q*scale|rel_h], ka = [k|spread]) are not built.
//
// Bound on the card, per head N = 4096, D = 64: 4*N*N*D = 4.3 GFLOP against
// 4*N*D*2 + 2*N*64*2 bytes (~3.1 MB bf16), ~1400 FLOP/byte -- bound by
// operations: 1.15 ms for the engine's 264 heads at 989 TFLOP/s; its
// N*N exponentials need about as long again (16 per clock per SM).
//
// Routes (global_attention.cuh, shared with K4 and K5, which compute the
// same function on the same operands, bit for bit, and with K6, which
// computes it on head-last views, bit for bit on the same values): bf16 at
// head dim 64 (SAM ViT-B) and 80 (ViT-H: 352 heads, 4.49 ms on the H100
// against 12.63 on the mma.sync route, PERF.md) takes the Hopper routine of
// hopper_attention.cuh (wgmma, TMA-fed K/V, a producer warpgroup, ping-pong
// consumers; bound by its softmax, PERF.md); float32 and the other head
// dims attention.cuh's mma.sync / FMA routine.
// Left on the table: what K5's routine leaves (PERF.md: the softmax's FP32
// work, a persistent grid).
#include "global_attention.cuh"

extern "C" int lameness_sam_global_attention(
    const void* q, const void* k, const void* v, const void* rel_h,
    const void* rel_w, void* o, int batch_heads, int tokens, int head_dim,
    int gw, const long long* strides, int dtype, void* stream) {
  return lameness::global_entry(q, k, v, rel_h, rel_w, o, batch_heads, 1,
                                tokens, head_dim, gw, strides, dtype, stream);
}
