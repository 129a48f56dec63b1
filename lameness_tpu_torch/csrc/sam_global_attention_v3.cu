// K6: SAM ViTDet global attention over head-last layouts.
//
// Replaces the TPU kernel lameness_tpu/ops/sam_attention.py::_global_kernel_v3
// (pallas_call in sam_global_attention_v3), reached with
// LAMENESS_GLB_KERNEL=v3 where hd + G <= 128.  The TPU entry builds
// augmented operands qa = [q4*scale | rh4] and ka = [k4 | spread^T], padded
// per head to 128 lanes, so that rh rides in one MXU contraction and its
// grid selects a head by lane block.  On the card that doubles QK^T (128
// columns in place of 64) and writes two (B, N, nH, 128) operands to HBM
// (1.2 ms a call), so this kernel computes K3's function on K6's own
// layouts instead: q4, k4, v4 (B, N, nH, hd) slices of the qkv output and
// rh4 (B, N, nH, GH), rw4 (B, N, nH, GW) as project_rel_tables_hl leaves
// them, all read in place at {image, head, token} strides; the output is
// (B, N, nH*hd).  Nothing is built in HBM.
//
// Bound on the card: K3's, per head N = 4096, D = 64: 4.3 GFLOP against
// ~3.1 MB in bf16 -- bound by operations (1.15 ms for the engine's 264
// heads at 989 TFLOP/s), and the N*N exponentials need about as long again.
//
// Routes (global_attention.cuh, shared with K3, K4 and K5): bf16 at head
// dim 64 or 80 takes the Hopper routine of hopper_attention.cuh (wgmma,
// TMA-fed K/V through 4-D maps {columns, tokens, heads, images}, a producer
// warpgroup, ping-pong consumers); its output equals K3's bit for bit on
// head-major copies of the same values.  float32 and the other head dims
// take the mma.sync / FMA routine of attention.cuh, which reads head
// strides too.
// Left on the table: what K3's routine leaves (PERF.md: the softmax's FP32
// work, a persistent grid); head-last K/V tiles are 128-byte rows at the
// token stride, where head-major ones are one contiguous run.
#include "global_attention.cuh"

// strides: q, k, v, rh, rw, o as {image, head, token} (18 values).
extern "C" int lameness_sam_global_attention_v3(
    const void* q, const void* k, const void* v, const void* rh,
    const void* rw, void* o, int outer, int heads, int tokens, int head_dim,
    int gw, const long long* strides, int dtype, void* stream) {
  long long st[18];
  for (int i = 0; i < 18; ++i) st[i] = strides[i];
  // one head: global_entry reads the tables' middle stride as their grid
  // row's, which is GW tokens of these token-major tables
  if (heads == 1) {
    st[10] = (long long)gw * st[11];
    st[13] = (long long)gw * st[14];
  }
  return lameness::global_entry(q, k, v, rh, rw, o, outer, heads, tokens,
                                head_dim, gw, st, dtype, stream);
}
