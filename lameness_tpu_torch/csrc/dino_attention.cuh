// K1's Hopper routine: softmax(scale·q·kᵀ)·v in bf16 at head dim 64 for a
// head whose keys all fit in one block (n <= kDinoKeys = 272: the 257
// tokens of every DINOv2 width at 224², S, B, L and g), with TMA and wgmma
// (sm_90a).  attention.cu's dino_entry chooses it by shape.  q, k, v and o
// are addressed as (outer, head, token) with a stride each, so the DINO
// layer's head-last views of its q, k and v Linear outputs (token stride
// 768) are read in place through 4-D TMA maps {64, tokens, heads, outer},
// and the output goes straight into its (B, S, H, D) buffer.
//
// The TPU kernel (lameness_tpu/ops/attention.py::_block_attn_kernel) holds
// a head's whole K/V in VMEM and takes a one-pass softmax, with no online
// rescaling; so does this routine, on the card's own terms:
//   * one block per (outer, head): two consumer warpgroups take the head's
//     64-row query tiles in turn (five at 257 tokens: 0, 2, 4 and 1, 3);
//   * Q (a 64-row box per tile), K and V (272 rows each, two 136-row boxes:
//     a box has at most 256) come in by TMA under the 128-byte swizzle,
//     rows past n as zeros, each Q tile, K and V on an mbarrier of its own.
//     The first thread of each warpgroup issues copies at the start, in the
//     order of use: one the first Q tile and K, the other the second Q
//     tile, V and the other Q tiles; so the first tiles' products start
//     while V and the last Q tiles still stream in;
//   * S = Q·Kᵀ over all keys at once: per k-step two wgmma m64n128k16 and
//     one m64n16k16 (keys padded to 272, not to 320), 136 f32 a thread; a
//     zero key still scores 0, so keys past n are set to -inf;
//   * the softmax in one pass, in the exp2 domain: the row max from the
//     registers (4 chains, then the 4 lanes of a row by shuffles), exp2 of
//     scale·log2e·(s - max), the row sums in f32, P packed to bf16 in
//     registers.  A warp whose 16 rows all lie past n (3 of the 4 in the
//     last tile at 257 tokens) skips it and gives zeros;
//   * O = P·V: 17 wgmma m64n64k16, A = P from registers, B = V MN-major
//     (the descriptor's transpose bit); V's zero rows and P's zero columns
//     past n keep the padded keys out exactly;
//   * the denominator applied after PV, as in every kernel of the port;
//     O in bf16 into the tile's Q slot, then one TMA store a tile (rows
//     past n are not written).  With stores straight from the accumulators
//     (16 bytes of 8 rows each) the loads and stores alone took 7.2 µs;
//     this way, 4.2 (scripts/k1_breakdown.py).
// The grid, and why: S alone takes 136 registers a thread (230 in all), so
// an SM holds two consumer warpgroups, whichever way they are grouped.  One
// block per head (120 blocks, 109 KB of shared memory each) reads every
// byte from HBM once.  One block per 64-row tile (600 blocks of one
// warpgroup, two an SM) reads a head's K/V from L2 five times and was
// slower; so was a cluster of a head's five blocks sharing K/V by TMA
// multicast, which paid for the cluster's scheduling and barriers (PERF.md,
// scripts/k1_breakdown.py).
// What bounds it, at the engine's shapes (120 heads of 257 tokens): the
// function moves 15.8 MB (4.7 µs at 3.35 TB/s) for 2.0 GFLOP (2.1 µs at 989
// TFLOP/s) and 7.9 M exponentials (2 µs at 16 a clock per SM).  Measured on
// the H100 (PERF.md): the loads and stores alone take 4.2 µs of about 12,
// and the softmax most of the rest: scripts/k1_phases.py puts it at
// 3300-3500 clocks for the two warpgroups' tiles together, about 10
// exponentials a clock on an SM.  Neither moving a quarter of them to the
// FMA pipe (a cubic) nor packing P on the integer pipe changed the whole,
// nor did taking the two warpgroups' softmax in turn.
#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

#include "attention.cuh"
#include "hopper.cuh"

namespace lameness {

constexpr int kDinoKeys = 272;     // keys held: 17 x 16 (S: 136 f32 a thread)
constexpr int kDinoBox = 136;      // rows of a K or V TMA box: two a tensor
constexpr int kDinoWGs = 2;        // consumer warpgroups a block
constexpr int kDinoTiles = 5;      // 64-row query tiles a block: 320 rows
constexpr int kDinoThreads = 128 * kDinoWGs;
constexpr int kDinoQBytes = 64 * 128;               // a Q tile: 8 KB
constexpr int kDinoKVBytes = kDinoKeys * 128;       // K or V: 34 KB
// 1 KB of alignment slack, Q, K, V, the mbarriers of K, V and each Q tile
constexpr size_t kDinoSmem = 1024 + kDinoTiles * kDinoQBytes +
                             2 * kDinoKVBytes + 8 * (2 + kDinoTiles);

// The scores of a warp's rows against all kDinoKeys keys, as the
// accumulators of the three products of dino_qk: (nt, i) is element i of
// n-tile nt (keys 8·nt ..), row g + 8·(i / 2), key 8·nt + 2·t4 + i % 2.
// Three arrays, not one cast into three: an array reached through a cast
// may be placed in local memory, and the accumulators of a wgmma must be
// registers.
struct DinoScores {
  float lo[64], hi[64], tail[8];   // keys 0-127, 128-255, 256-271
  __device__ __forceinline__ float& operator()(int nt, int i) {
    return nt < 16 ? lo[4 * nt + i]
                   : nt < 32 ? hi[4 * (nt - 16) + i] : tail[4 * (nt - 32) + i];
  }
};

// S = Q·Kᵀ of one tile over all kDinoKeys keys, 4 k-steps of 16 (+2 in the
// descriptors): keys 0-127, 128-255 (+16 KB, +1024) and 256-271 (+32 KB)
__device__ __forceinline__ void dino_qk(DinoScores& s, uint32_t q_tile,
                                        uint32_t k_s) {
  using namespace sm90;
  const uint64_t dq = desc_sw128(q_tile), dk = desc_sw128(k_s);
  fence_operands(s.lo);
  fence_operands(s.hi);
  fence_operands(s.tail);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    wgmma_m64n128k16_ss(s.lo, dq + 2 * kk, dk + 2 * kk, kk > 0);
    wgmma_m64n128k16_ss(s.hi, dq + 2 * kk, dk + 1024 + 2 * kk, kk > 0);
    wgmma_m64n16k16_ss(s.tail, dq + 2 * kk, dk + 2048 + 2 * kk, kk > 0);
  }
  wgmma_commit();
  wgmma_wait<0>();
  fence_operands(s.lo);
  fence_operands(s.hi);
  fence_operands(s.tail);
}

// The one-pass softmax of a warp's rows (g and g + 8 of its 16): keys past
// n to -inf, the row max, exp2(c2·(s - max)) packed to bf16 as the A
// fragments of PV's 17 k-steps, and the two rows' sums in l.
__device__ __forceinline__ void dino_softmax(DinoScores& s, int n, float c2,
                                             uint32_t (&p)[kDinoKeys / 16][4],
                                             float (&l)[2]) {
  constexpr int NT = kDinoKeys / 8;
  const int t4 = threadIdx.x % 4;
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
    if (nt * 8 + 8 <= n) continue;
#pragma unroll
    for (int j = 0; j < 2; ++j)
      if (nt * 8 + 2 * t4 + j >= n) s(nt, j) = s(nt, 2 + j) = -INFINITY;
  }
  float mc[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float c[4] = {-INFINITY, -INFINITY, -INFINITY, -INFINITY};
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
      c[nt % 4] = fmaxf(c[nt % 4], fmaxf(s(nt, 2 * h), s(nt, 2 * h + 1)));
    mc[h] = fmaxf(fmaxf(c[0], c[1]), fmaxf(c[2], c[3]));
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) mc[h] = fmaxf(mc[h], shfl_xor(mc[h], 1));
#pragma unroll
  for (int h = 0; h < 2; ++h)   // key 0 is valid: the max is finite
    mc[h] = fmaxf(mc[h], shfl_xor(mc[h], 2)) * c2;
  float sum[2][2] = {{0.f, 0.f}, {0.f, 0.f}};
#pragma unroll
  for (int c = 0; c < kDinoKeys / 16; ++c) {
    float e[8];
#pragma unroll
    for (int i = 0; i < 8; ++i)
      e[i] = sm90::exp2_ftz(fmaf(s(2 * c + i / 4, i % 4), c2,
                                 -mc[(i / 2) % 2]));
    p[c][0] = pack_bf16x2(e[0], e[1]);
    p[c][1] = pack_bf16x2(e[2], e[3]);
    p[c][2] = pack_bf16x2(e[4], e[5]);
    p[c][3] = pack_bf16x2(e[6], e[7]);
    sum[0][c % 2] += (e[0] + e[1]) + (e[4] + e[5]);
    sum[1][c % 2] += (e[2] + e[3]) + (e[6] + e[7]);
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l[h] = sum[h][0] + sum[h][1];
    l[h] += shfl_xor(l[h], 1);
    l[h] += shfl_xor(l[h], 2);
  }
}

// O = P·V over the 17 k-steps: the V tile advances 16 rows (+128) a step
__device__ __forceinline__ void dino_pv(float (&o)[32],
                                        uint32_t (&p)[kDinoKeys / 16][4],
                                        uint32_t v_s) {
  using namespace sm90;
  const uint64_t dv = desc_sw128(v_s);
#pragma unroll
  for (int c = 0; c < kDinoKeys / 16; ++c) fence_operands(p[c]);
  fence_operands(o);
  wgmma_fence();
#pragma unroll
  for (int c = 0; c < kDinoKeys / 16; ++c)
    wgmma_m64n64k16_rs(o, p[c], dv + 128 * c);
  wgmma_commit();
  wgmma_wait<0>();
  fence_operands(o);
}

// One consumer warpgroup on the 64-row query tile at q0; `to` is the
// output's TMA map.
__device__ __forceinline__ void dino_tile(const AttnArgs& a,
                                          const CUtensorMap* to, int outer,
                                          int head, int q0, uint32_t q_tile,
                                          uint32_t k_s, uint32_t v_s,
                                          uint32_t bar_q, uint32_t bar_k,
                                          uint32_t bar_v) {
  using namespace sm90;
  const int warp = (threadIdx.x % 128) / 32, lane = threadIdx.x % 32;
  DinoScores s;
#pragma unroll
  for (int nt = 0; nt < kDinoKeys / 8; ++nt)
#pragma unroll
    for (int i = 0; i < 4; ++i) s(nt, i) = 0.f;
  mbar_wait(bar_q, 0);
  mbar_wait(bar_k, 0);
  dino_qk(s, q_tile, k_s);

  uint32_t p[kDinoKeys / 16][4];
  float l[2] = {1.f, 1.f};
  if (q0 + 16 * warp < a.n_q) {
    dino_softmax(s, a.n_k, a.scale * kLog2e, p, l);
  } else {   // no row of this warp is stored
#pragma unroll
    for (int c = 0; c < kDinoKeys / 16; ++c)
      p[c][0] = p[c][1] = p[c][2] = p[c][3] = 0u;
  }

  float o[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) o[i] = 0.f;
  mbar_wait(bar_v, 0);
  dino_pv(o, p, v_s);

  // O / l in bf16 into the tile's Q slot (Q is read) as TMA lays a box
  // out under the 128-byte swizzle -- 16-byte chunk j of row r at j ^ r % 8,
  // so the 8 rows of a store hit 32 banks -- then one TMA store of the
  // tile; rows past n are not written
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = 16 * warp + lane / 4 + 8 * h;
    const float inv = 1.f / l[h];
#pragma unroll
    for (int j = 0; j < 8; ++j)
      st_shared_u32(q_tile + r * 128 + ((j ^ (r % 8)) * 16) + 4 * (lane % 4),
                    pack_bf16x2(o[4 * j + 2 * h] * inv,
                                o[4 * j + 2 * h + 1] * inv));
  }
  fence_proxy_async();
  named_barrier_sync(1 + threadIdx.x / 128, 128);
  if (threadIdx.x % 128 == 0) {
    tma_store_4d(to, q_tile, 0, q0, head, outer);
    bulk_commit();
  }
}

__global__ void __launch_bounds__(kDinoThreads, 1)
    dino_attention_kernel(const __grid_constant__ CUtensorMap tq,
                          const __grid_constant__ CUtensorMap tk,
                          const __grid_constant__ CUtensorMap tv,
                          const __grid_constant__ CUtensorMap to,
                          const AttnArgs a) {
  using namespace sm90;
  extern __shared__ __align__(1024) unsigned char dino_smem[];
  // the 128-byte swizzle repeats every 1024 bytes: tiles start on that
  const uint32_t raw = smem_u32(dino_smem);
  const uint32_t q_s = raw + ((1024u - (raw & 1023u)) & 1023u);
  const uint32_t k_s = q_s + kDinoTiles * kDinoQBytes;
  const uint32_t v_s = k_s + kDinoKVBytes;
  // mbarriers: K, V, then one per Q tile
  const uint32_t bar_k = v_s + kDinoKVBytes, bar_v = bar_k + 8;
  auto bar_q = [&](int t) { return bar_v + 8 + 8 * t; };
  const int bh = blockIdx.x / a.n_qblocks;
  const int outer = bh / a.heads, head = bh % a.heads;
  const int tile0 = (blockIdx.x % a.n_qblocks) * kDinoTiles;
  const int tiles = min(kDinoTiles, (a.n_q + 63) / 64 - tile0);

  if (threadIdx.x == 0) {
    for (int i = 0; i < 2 + tiles; ++i) mbar_init(bar_k + 8 * i, 1);
    fence_barrier_init();
  }
  __syncthreads();

  // every copy at once, in the order of use, from the first thread of each
  // warpgroup: the first Q tile and K; the other warpgroup's first Q tile,
  // V and the other Q tiles
  auto load_q = [&](int t) {
    mbar_arrive_expect_tx(bar_q(t), kDinoQBytes);
    tma_load_4d(q_s + t * kDinoQBytes, &tq, bar_q(t), 0, (tile0 + t) * 64,
                head, outer);
  };
  auto load_kv = [&](uint32_t dst, const CUtensorMap* map, uint32_t bar) {
    mbar_arrive_expect_tx(bar, kDinoKVBytes);
    for (int b = 0; b < kDinoKeys / kDinoBox; ++b)
      tma_load_4d(dst + b * kDinoBox * 128, map, bar, 0, b * kDinoBox, head,
                  outer);
  };
  if (threadIdx.x == 0) {
    load_q(0);
    load_kv(k_s, &tk, bar_k);
  }
  if (threadIdx.x == (kDinoWGs - 1) * 128) {
    for (int t = 1; t < min(tiles, kDinoWGs); ++t) load_q(t);
    load_kv(v_s, &tv, bar_v);
    for (int t = kDinoWGs; t < tiles; ++t) load_q(t);
  }
  for (int t = threadIdx.x / 128; t < tiles; t += kDinoWGs)
    dino_tile(a, &to, outer, head, (tile0 + t) * 64, q_s + t * kDinoQBytes,
              k_s, v_s, bar_q(t), bar_k, bar_v);
  // the output tiles' shared memory stays until their stores have read it
  if (threadIdx.x % 128 == 0) bulk_wait_read();
}

// ---------------------------------------------------------------------------
// host side
// ---------------------------------------------------------------------------
// The shapes this routine takes (batch = outer x heads): bf16, head dim 64,
// as many queries as keys, all keys held (n <= 272), and a positive scale
// (the row max of the raw scores is then that of the scaled ones).
inline bool dino_takes(const AttnArgs& a, int batch, int head_dim,
                       int dtype) {
  return !bad_shape(a, batch, dtype, false) && dtype == 1 &&
         head_dim == kTileWidth && a.n_q == a.n_k && a.n_k <= kDinoKeys &&
         a.scale > 0.f;
}

// Returns a cudaError_t as int: cudaErrorInvalidValue for operands TMA
// cannot read (the Python wrapper checks them first), cudaErrorNotSupported
// without the tensor-map encoder of libcuda.
inline int launch_dino(AttnArgs a, int outer, void* stream) {
  const EncodeTiledFn enc = encode_tiled();
  if (enc == nullptr) return (int)cudaErrorNotSupported;
  CUtensorMap tq, tk, tv, to;
  if (!tile_map(enc, &tq, a.q, a.q_s, outer, a.heads, a.n_q, 64) ||
      !tile_map(enc, &tk, a.k, a.k_s, outer, a.heads, a.n_k, kDinoBox) ||
      !tile_map(enc, &tv, a.v, a.v_s, outer, a.heads, a.n_k, kDinoBox) ||
      !tile_map(enc, &to, a.o, a.o_s, outer, a.heads, a.n_q, 64))
    return (int)cudaErrorInvalidValue;
  const int tiles = (a.n_q + 63) / 64;
  a.n_qblocks = (tiles + kDinoTiles - 1) / kDinoTiles;
  cudaError_t err = cudaFuncSetAttribute(
      dino_attention_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)kDinoSmem);
  if (err != cudaSuccess) return (int)err;
  dino_attention_kernel<<<outer * a.heads * a.n_qblocks, kDinoThreads,
                          kDinoSmem, static_cast<cudaStream_t>(stream)>>>(
      tq, tk, tv, to, a);
  return (int)cudaGetLastError();
}

}  // namespace lameness
