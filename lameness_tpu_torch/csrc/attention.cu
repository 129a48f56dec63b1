// K1: unbiased softmax attention for the DINOv2 ViT-B/14 encoder.
//
// Replaces the TPU kernel lameness_tpu/ops/attention.py::_block_attn_kernel
// (pallas_call in _pallas_attention), which pads S to 256 and masks the pad
// keys; here keys past S are masked in the kernel and nothing is padded.
//
// Bound on the card: at the path's shapes (B*5*12 heads, S = 257, D = 64)
// the work is 4*S*S*D = 17 MFLOP per head against 4*S*D*2 bytes of q, k, v,
// o in bf16 (130 KB): about 130 FLOP/byte, under the H100's ~295 bf16
// FLOP/byte ridge, so it is bound by bytes (4.7 µs for the engine's 120
// heads); the products (2.1 µs) and the exponentials (about 2 µs) are not
// far behind, so a call this short is bound by its latency chain.
//
// Routes, chosen in one place, dino_entry below (a failed launch raises in
// the Python wrapper; nothing falls back):
//   * bfloat16 at head dim 64 with n_q == n_k <= 272 (every DINOv2 width at
//     224²: 257 tokens): the Hopper routine of dino_attention.cuh -- the
//     head's whole K and V in shared memory by TMA, QKᵀ over all keys at
//     once and PV on wgmma, the TPU kernel's one-pass softmax;
//   * anything else (float32, head dims 16, 32, 80, 128, and token counts
//     too large to hold, such as DINO at 518²: 1370 tokens): the online
//     softmax routine of attention.cuh (mma.sync / FMA).
// Both read q, k and v at the strides given (the layer's head-last views)
// and write the (B, S, H, D) output in place.  The CPU emulation
// (scripts/emulate_cuda_kernels.py, LAMENESS_EMULATION) has no wgmma or TMA
// and always takes the second route.
#include "attention.cuh"
#ifndef LAMENESS_EMULATION
#include "dino_attention.cuh"
#endif

namespace lameness {

// outer = B; a.heads = H.  Returns a cudaError_t as int.
inline int dino_entry(const AttnArgs& a, int outer, int head_dim, int dtype,
                      void* stream) {
#ifndef LAMENESS_EMULATION
  if (dino_takes(a, outer * a.heads, head_dim, dtype))
    return launch_dino(a, outer, stream);
#endif
  return launch<false>(a, outer * a.heads, head_dim, dtype, stream);
}

}  // namespace lameness

// q, k, v, o: (B, H, S, D) with the feature axis contiguous and strides
// {B, H, S} given in `strides` as q, k, v, o (12 values).
extern "C" int lameness_attention(const void* q, const void* k, const void* v,
                                  void* o, int batch, int heads, int seq,
                                  int head_dim, const long long* strides,
                                  float scale, int dtype, void* stream) {
  lameness::AttnArgs a = {};
  a.q = q;
  a.k = k;
  a.v = v;
  a.o = o;
  a.n_q = seq;
  a.n_k = seq;
  a.heads = heads;
  a.gw = 1;
  a.scale = scale;
  lameness::copy_strides(a.q_s, strides + 0);
  lameness::copy_strides(a.k_s, strides + 3);
  lameness::copy_strides(a.v_s, strides + 6);
  lameness::copy_strides(a.o_s, strides + 9);
  return lameness::dino_entry(a, batch, head_dim, dtype, stream);
}
