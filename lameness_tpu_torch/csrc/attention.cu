// K1: unbiased softmax attention for the DINOv2 ViT-B/14 encoder.
//
// Replaces the TPU kernel lameness_tpu/ops/attention.py::_block_attn_kernel
// (pallas_call in _pallas_attention), which pads S to 256 and masks the pad
// keys; here keys past S are masked in the kernel and nothing is padded.
//
// Bound on the card: at the path's shapes (B*5*12 heads, S = 257, D = 64)
// the work is 4*S*S*D = 17 MFLOP per head against 4*S*D*2 bytes of q, k, v,
// o in bf16 (130 KB): about 130 FLOP/byte, under the H100's ~295 bf16
// FLOP/byte ridge, so it is bound by bytes.  The bf16 path runs QK^T and PV
// on the tensor cores (attention.cuh).  Left on the table: 257 rows fill 5
// 64-row q blocks and 5 64-key tiles, the last of each holding one token
// (about 20% of the products are padding); each q block re-reads the head's
// K/V (from L2); no TMA or wgmma.
#include "attention.cuh"

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
  return lameness::launch<false>(a, batch * heads, head_dim, dtype, stream);
}
