// The Hopper global attention routine: softmax(scale·q·kᵀ + rh[t, j / GW] +
// rw[t, j % GW]) · v in bf16 with wgmma and TMA (sm_90a), at head dim 64
// (SAM ViT-B) or 80 (ViT-H).  K3, K4, K5 and K6 launch it through
// global_entry (global_attention.cuh), which chooses it by shape.  The
// tensors are addressed as (outer, head, token) with a stride each: K3-K5
// have one head per outer index, K6 reads head-last (B, N, nH, hd) slices of
// the qkv output and its (B, N, nH, ·) tables in place, so the TMA maps are
// 4-D, {columns, tokens, heads, outer}.
//
// A block owns 192 query rows (hd 64) or 128 (hd 80) of one (outer, head)
// and walks the keys in tiles of 128 with an online softmax:
//   * three (two) consumer warpgroups of 64 rows each, then the producer
//     warpgroup, one lane of which issues every copy.  The producer gives
//     up registers (setmaxnreg: 24 a thread) so that the consumers get 160
//     (240) and keep S, O and P in registers;
//   * Q (BlockQ x hd) comes in once by TMA; K and V tiles (128 x hd each)
//     through rings of stages, K and V each with a "full" mbarrier (TMA
//     bytes) and an "empty" one (one arrival per consumer warp) a stage: K
//     of a tile is freed once its QKᵀ is in, V one step later, once its PV
//     is;
//   * a row of Q, K or V is stored as its first 64 columns (128 bytes under
//     the 128-byte swizzle, one wgmma atom) and, at hd 80, the other 16 (32
//     bytes under the 32-byte swizzle) in a tile of their own: two TMA maps
//     per operand that differ in column offset, width and swizzle (padding
//     the 16 columns to a 64-wide atom would cost 48 KB of Q and 32 KB a
//     stage);
//   * S = Q·Kᵀ: 4 wgmma m64n128k16 over the 128-byte parts (+ at hd 80 a
//     fifth over the 32-byte parts), both operands in shared memory,
//     K-major;
//   * the bias in the exp2 domain from the block's f32 bias rows staged in
//     shared memory, as K3 adds it: on the 64-column grid a key tile is two
//     grid rows, so rh is two values per row and tile and rw one per column
//     (each read once for two scores); otherwise rh and rw are gathered per
//     score; keys past N -> -inf;
//   * the online softmax in registers (the row max over the 4 lanes of a
//     row by shuffles, both rows of a lane at each step), P packed to bf16
//     in registers;
//   * O += P·V: 8 wgmma m64n64k16 (+ at hd 80 8 m64n16k16) with A = P from
//     registers and B = the V tile, MN-major (the descriptor's transpose
//     bit); the row sums on the tensor cores too, as P times a block of
//     ones (8 wgmma m64n8k16), which takes 64 additions per tile off each
//     thread.  PV of tile i - 1 is issued with S of tile i, and runs on the
//     tensor cores while the warpgroup computes the softmax of tile i;
//   * the denominator applied at the end; bf16 stores straight from the
//     accumulators;
//   * the warpgroups issue their products in turn (ping-pong on named
//     barriers), so that one's exponentials run while another's products
//     do.
// Shared memory (HopShape, hopper_smem_bytes; a block may have 232,448
// bytes): 1 KB of alignment slack, Q, the stages, 128 bytes of mbarriers,
// 1 KB of ones and 4·BlockQ·(GH + GW + 2) bytes of bias rows.  hd 64: 192
// rows, 3 stages of 32 KB, 224,896 bytes at the 64 x 64 grid.  hd 80: a
// stage is 40 KB, and 192 rows would leave room for 2 stages only (214,656
// bytes), where three warpgroups at 160 registers spill; so a block takes
// 128 rows in two warpgroups at 240 registers (the rw values of the 64 x 64
// grid held in registers too) and 3 stages: 212,096 bytes, the rect (36,
// 64) grid 197,760.  It streams each head's K/V 32 times, not 22.
// Blocks of one head are adjacent in the grid, so its K/V (1-1.3 MB) stays
// in L2.  Head-last K/V tiles are 128 rows at the token stride (4608 bytes
// in the engine's fused qkv output at hd 64): the same bytes, in more rows.
// What bounds it, at the engine's shapes (264 heads of 4096 x 64; measured
// on the H100 by scripts/k5_breakdown.py, which builds copies of this
// kernel with parts left out, PERF.md): the whole
// 3.13 ms; without the products 2.79, without the softmax 1.72, the K/V
// stream and the bias staging alone 0.84.  So the softmax bounds it: its
// exponentials alone need 1.2 ms (16 per clock per SM), and its FP32 work
// shares the warps' issue slots with them.  The design spends FP32
// instructions sparingly (the row sums on the tensor cores, the max in four
// chains) and hides the products behind the softmax.  At hd 80 (352 heads
// of ViT-H) the products are 25% more per score, and the tensor cores'
// bound (1.91 ms) passes the exponentials' (1.6 ms); PERF.md has the
// breakdown (scripts/k5_breakdown.py 80).
#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

#include "attention.cuh"
#include "hopper.cuh"

namespace lameness {

constexpr int kHopBlockK = 128;     // keys per K/V tile
constexpr int kHopWide = 64;        // columns of a row's 128-byte part
constexpr int kHopBarBytes = 128;   // 4 x stages + 1 mbarriers, padded
constexpr int kHopOnesBytes = 1024; // bf16 ones: B of the row sums
constexpr size_t kHopMaxSmem = 232448;   // a block's limit on the H100

// The block of each head dim: its query rows (64 a consumer warpgroup) and
// the K/V stages of its rings.  hd 80 at 192 rows and 3 stages would need
// 255,616 bytes at the 64x64 grid; at 192 rows and 2 stages three consumer
// warpgroups need more than their 160 registers (S, O and P alone take
// 140): ptxas spills and serialises the products (8.45 ms a K5 call against
// 5.33 at 128 rows, PERF.md).
template <int D> struct HopShape;
template <> struct HopShape<64> {
  static constexpr int kBlockQ = 192, kStages = 3;
};
template <> struct HopShape<80> {
  static constexpr int kBlockQ = 128, kStages = 3;
};

// What follows from the head dim and its block.  A row of Q, K or V is its
// first 64 columns (128 bytes, 128-byte swizzle) and, at hd 80, 16 more (32
// bytes, 32-byte swizzle), each part a tile of its own.
template <int D>
struct Hop {
  static constexpr int kBlockQ = HopShape<D>::kBlockQ;
  static constexpr int kStages = HopShape<D>::kStages;
  static constexpr int kNarrow = D - kHopWide;   // 0 or 16 columns
  static_assert(kNarrow == 0 || kNarrow == 16, "head dim 64 or 80");
  static_assert(kBlockQ % 64 == 0 && 4 * kStages + 1 <= kHopBarBytes / 8,
                "block shape");
  static constexpr int kConsumers = kBlockQ / 64 * 128;   // warpgroups x 128
  static constexpr int kThreads = kConsumers + 128;  // + the producer's
  // a consumer's registers beside a producer at 24: 160 for three
  // warpgroups, 240 (the most setmaxnreg gives) for two
  static constexpr int kRegs =
      (65536 - 128 * 24) / kConsumers / 8 * 8 < 240
          ? (65536 - 128 * 24) / kConsumers / 8 * 8
          : 240;
  static constexpr int kWideBytes = kHopBlockK * kHopWide * 2;  // 16 KB
  static constexpr int kNarrowBytes = kHopBlockK * kNarrow * 2; // 4 KB or 0
  static constexpr int kTileBytes = kWideBytes + kNarrowBytes;  // K or V
  static constexpr int kStageBytes = 2 * kTileBytes;
  static constexpr int kQWideBytes = kBlockQ * kHopWide * 2;
  static constexpr int kQBytes = kBlockQ * D * 2;
};

// Shared memory: 1 KB of alignment slack; Q; kStages x (K, V); the
// mbarriers; the ones; the f32 bias rows sRH[BlockQ][GH + 1] and
// sRW[BlockQ][GW + 1].
template <int D>
inline size_t hopper_smem_bytes(int gh, int gw) {
  using C = Hop<D>;
  return 1024 + C::kQBytes + (size_t)C::kStageBytes * C::kStages +
         kHopBarBytes + kHopOnesBytes +
         sizeof(float) * C::kBlockQ * (size_t)(gh + 1 + gw + 1);
}

// op over the 32 values of row h of an m64n128 accumulator that a lane
// holds (s[4n + 2h], s[4n + 2h + 1]), in four independent chains
template <typename Op>
__device__ __forceinline__ float row_reduce(const float (&s)[64], int h,
                                            Op op) {
  float c[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) c[i] = op(s[4 * i + 2 * h], s[4 * i + 2 * h + 1]);
#pragma unroll
  for (int n = 4; n < 16; ++n)
    c[n % 4] = op(c[n % 4], op(s[4 * n + 2 * h], s[4 * n + 2 * h + 1]));
  return op(op(c[0], c[1]), op(c[2], c[3]));
}

// Rows q0 .. q0 + ROWS - 1 of a bf16 (GH, GW, width) table (token t at
// (t / GW)·row + (t % GW)·col) into dst[r·pitch + c] as f32·log2e, zeros
// past n_q; run by the THREADS consumers.  Where width, the strides and the
// address allow, in 16-byte loads, a thread's four loads issued before its
// stores (a block stages 48 KB of tables before its first tile: one
// dependent load per element made that a large share of the kernel).
template <int ROWS, int THREADS>
__device__ __forceinline__ void stage_rows(float* dst, int pitch,
                                           const __nv_bfloat16* src,
                                           long long row_s, long long col_s,
                                           int gw, int width, int q0,
                                           int n_q) {
  const int tid = threadIdx.x;
  auto row = [&](int tok) {
    return src + table_row(row_s, col_s, gw, tok);
  };
  if (width % 8 || row_s % 8 || col_s % 8 ||
      reinterpret_cast<uintptr_t>(src) % 16) {
    for (int i = tid; i < ROWS * width; i += THREADS) {
      const int r = i / width, c = i - r * width, tok = q0 + r;
      dst[r * pitch + c] =
          tok < n_q ? __bfloat162float(row(tok)[c]) * kLog2e : 0.f;
    }
    return;
  }
  constexpr int U = 4;
  const int chunks = width / 8, total = ROWS * chunks;
  for (int base = tid; base < total; base += U * THREADS) {
    uint4 v[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int i = base + u * THREADS;
      const int r = i / chunks, tok = q0 + r;
      v[u] = make_uint4(0, 0, 0, 0);
      if (i < total && tok < n_q)
        v[u] = __ldg(reinterpret_cast<const uint4*>(row(tok) +
                                                    (i - r * chunks) * 8));
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int i = base + u * THREADS;
      if (i < total) {
        const int r = i / chunks;
        float* d = dst + r * pitch + (i - r * chunks) * 8;
        const uint32_t w[4] = {v[u].x, v[u].y, v[u].z, v[u].w};
#pragma unroll
        for (int k = 0; k < 4; ++k) {   // bf16 -> f32 is a 16-bit shift
          d[2 * k] = __uint_as_float(w[k] << 16) * kLog2e;
          d[2 * k + 1] = __uint_as_float(w[k] & 0xffff0000u) * kLog2e;
        }
      }
    }
  }
}

// Addresses in the block's shared memory: Q, the K/V stages, the mbarriers
// and the ones (shared-window addresses), and the bias rows.  A stage holds
// K's and V's 128-byte parts, then (hd 80) their 32-byte parts.
template <int D>
struct HopLayout {
  using C = Hop<D>;
  uint32_t q;       // Q's 128-byte part, 1024-byte aligned; its 32-byte after
  float* rh;        // sRH[BlockQ][GH + 1], then sRW[BlockQ][GW + 1]
  __device__ uint32_t q_narrow() const { return q + C::kQWideBytes; }
  __device__ uint32_t stage(int s) const {
    return q + C::kQBytes + C::kStageBytes * s;
  }
  __device__ uint32_t k_tile(int s) const { return stage(s); }
  __device__ uint32_t v_tile(int s) const { return stage(s) + C::kWideBytes; }
  __device__ uint32_t k_narrow(int s) const {
    return stage(s) + 2 * C::kWideBytes;
  }
  __device__ uint32_t v_narrow(int s) const {
    return k_narrow(s) + C::kNarrowBytes;
  }
  __device__ uint32_t bar(int i) const { return stage(C::kStages) + 8 * i; }
  // K and V have rings of their own barriers: K of a tile is read by its
  // QKᵀ, V one step later by its PV
  __device__ uint32_t k_full(int s) const { return bar(s); }
  __device__ uint32_t v_full(int s) const { return bar(C::kStages + s); }
  __device__ uint32_t k_empty(int s) const { return bar(2 * C::kStages + s); }
  __device__ uint32_t v_empty(int s) const { return bar(3 * C::kStages + s); }
  __device__ uint32_t q_bar() const { return bar(4 * C::kStages); }
  __device__ uint32_t ones() const { return bar(0) + kHopBarBytes; }
};

// The consumer warpgroups of hopper_global_kernel (tid < kConsumers).
template <int D, bool ROW_TILE>
__device__ __forceinline__ void consume(const AttnArgs& a,
                                        const HopLayout<D>& L, int outer,
                                        int head, int q0, int n_tiles) {
  using T = __nv_bfloat16;
  using C = Hop<D>;
  using namespace sm90;
  constexpr int NT = kHopBlockK / 8;   // n-tiles of a score row: 16
  constexpr int NG = NT / 2;           // n-tiles of one 64-key grid row
  constexpr int ND = kHopWide / 8;     // n-tiles of the 128-byte part: 8
  constexpr int NN = C::kNarrow / 8;   // n-tiles of the 32-byte part: 0, 2
  const int gh = a.n_k / a.gw;
  const int rhp = gh + 1, rwp = a.gw + 1;   // odd pitches: fewer conflicts
  float* sRH = L.rh;
  float* sRW = sRH + C::kBlockQ * rhp;
  const int tid = threadIdx.x;

  // the block's bias rows, f32, in the exp2 domain
  stage_rows<C::kBlockQ, C::kConsumers>(
      sRH, rhp, static_cast<const T*>(a.rh) + offset(a.rh_s, outer, head),
      a.rh_row, a.rh_s[2], a.gw, gh, q0, a.n_q);
  stage_rows<C::kBlockQ, C::kConsumers>(
      sRW, rwp, static_cast<const T*>(a.rw) + offset(a.rw_s, outer, head),
      a.rw_row, a.rw_s[2], a.gw, a.gw, q0, a.n_q);
  // the ones (B of the row sums: any layout of ones reads as ones)
  uint32_t* ones = reinterpret_cast<uint32_t*>(sRH) - kHopOnesBytes / 4;
  for (int i = tid; i < kHopOnesBytes / 4; i += C::kConsumers)
    ones[i] = 0x3F803F80u;   // two bf16 1.0
  fence_proxy_async();       // generic stores, read by wgmma
  named_barrier_sync(1, C::kConsumers);

  const int wg = tid / 128, warp = (tid % 128) / 32, lane = tid % 32;
  const int g = lane / 4, t4 = lane % 4;
  const int row0 = wg * 64 + warp * 16 + g;   // this lane's rows: row0, +8
  const float scale2 = a.scale * kLog2e;
  const float inv_gw = 1.f / (float)a.gw;

  // ROW_TILE: this lane's rw values, column 8n + 2·t4 + j of rows row0 and
  // row0 + 8; with registers to spare (two warpgroups: 240), held in
  // registers for the whole key loop rather than read again each tile
  const float* rw_lo = sRW + row0 * rwp + 2 * t4;
  const float* rw_hi = rw_lo + 8 * rwp;
  constexpr bool RW_REGS = ROW_TILE && C::kRegs >= 240;
  float rwr[2][RW_REGS ? 2 * NG : 1];
  if constexpr (RW_REGS) {
#pragma unroll
    for (int n = 0; n < NG; ++n)
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        rwr[0][2 * n + j] = rw_lo[8 * n + j];
        rwr[1][2 * n + j] = rw_hi[8 * n + j];
      }
  }
  auto rw_at = [&](int h, int n, int j) {
    if constexpr (RW_REGS) return rwr[h][2 * n + j];
    else return (h ? rw_hi : rw_lo)[8 * n + j];
  };

  float s[4 * NT];        // scores, then weights: the m64n128 accumulator
  float o[4 * ND];        // output columns 0-63: the m64n64 accumulator
  float on[4 * 2];        // hd 80: columns 64-79, the m64n16 accumulator
  uint32_t p[NT / 2][4];  // the weights in bf16: A of PV's 8 k-steps
#pragma unroll
  for (int i = 0; i < 4 * NT; ++i) s[i] = 0.f;
#pragma unroll
  for (int i = 0; i < 4 * ND; ++i) o[i] = 0.f;
#pragma unroll
  for (int i = 0; i < 4 * NN; ++i) on[i] = 0.f;
  float m_run[2] = {-INFINITY, -INFINITY};
  // row sums of the bf16 weights, taken by the tensor cores as P times a
  // block of ones (m64n8: every column of row r holds its sum)
  float l_acc[4] = {0.f, 0.f, 0.f, 0.f};
  const uint64_t desc_ones = desc_plain(L.ones(), 128, 256);
  float alpha[2];

  mbar_wait(L.q_bar(), 0);
  const uint64_t desc_q = desc_sw128(L.q + wg * 64 * 128);
  const uint64_t desc_qn = desc_sw32(L.q_narrow() + wg * 64 * 32);

  // S = Q Kᵀ of one stage, over the head dim: 4 k-steps of 16 (+2 each) in
  // the 128-byte parts, at hd 80 a fifth in the 32-byte parts
  auto issue_qk = [&](int stage) {
    const uint64_t desc_k = desc_sw128(L.k_tile(stage));
#pragma unroll
    for (int kk = 0; kk < kHopWide / 16; ++kk)
      wgmma_m64n128k16_ss(s, desc_q + 2 * kk, desc_k + 2 * kk, kk > 0);
    if constexpr (NN > 0)
      wgmma_m64n128k16_ss(s, desc_qn, desc_sw32(L.k_narrow(stage)), 1);
    wgmma_commit();
  };
  // O += P V of one stage: the V tile advances 16 rows (+128 in the
  // 128-byte part, +32 in the 32-byte one) per k-step
  auto issue_pv = [&](int stage) {
    const uint64_t desc_v = desc_sw128(L.v_tile(stage));
#pragma unroll
    for (int c = 0; c < NT / 2; ++c)
      wgmma_m64n64k16_rs(o, p[c], desc_v + 128 * c);
    if constexpr (NN > 0) {
      const uint64_t desc_vn = desc_sw32(L.v_narrow(stage));
#pragma unroll
      for (int c = 0; c < NT / 2; ++c)
        wgmma_m64n16k16_rs(on, p[c], desc_vn + 32 * c);
    }
#pragma unroll
    for (int c = 0; c < NT / 2; ++c)
      wgmma_m64n8k16_rs(l_acc, p[c], desc_ones);
    wgmma_commit();
  };
  // scale, bias and mask of tile `it` in the exp2 domain, then the online
  // softmax step: s -> exp2(s - new max), and alpha, the factor of the old
  // O and row sums.  h = 0 is row0, h = 1 is row0 + 8.  Every tile
  // holds a valid key, so the new max is finite and exp2(-inf - max) == 0
  // masks.
  auto softmax = [&](int it) {
    const int k0 = it * kHopBlockK;
    if (ROW_TILE) {
      // keys k0 .. k0 + 127 are grid rows 2·it and 2·it + 1 (a row past GH
      // reads the pad column and is masked below)
      float rh_t[2][2];
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int half = 0; half < 2; ++half)
          rh_t[h][half] = sRH[(row0 + 8 * h) * rhp + 2 * it + half];
#pragma unroll
      for (int n = 0; n < NG; ++n)
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const float lo = rw_at(0, n, j), hi = rw_at(1, n, j);
#pragma unroll
          for (int half = 0; half < 2; ++half) {
            const int i = 4 * (n + NG * half) + j;
            s[i] = fmaf(s[i], scale2, rh_t[0][half] + lo);
            s[i + 2] = fmaf(s[i + 2], scale2, rh_t[1][half] + hi);
          }
        }
    } else {
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int key = min(k0 + n * 8 + 2 * t4 + j, a.n_k - 1);
          // exact for key < 2^22: (key + 0.5) / gw is >= 0.5 / gw from an
          // integer
          const int kh = (int)(((float)key + 0.5f) * inv_gw);
          const int kw = key - kh * a.gw;
          s[4 * n + j] = fmaf(s[4 * n + j], scale2,
                              sRH[row0 * rhp + kh] + sRW[row0 * rwp + kw]);
          s[4 * n + 2 + j] =
              fmaf(s[4 * n + 2 + j], scale2,
                   sRH[(row0 + 8) * rhp + kh] + sRW[(row0 + 8) * rwp + kw]);
        }
    }
    if (k0 + kHopBlockK > a.n_k) {   // the ragged last tile
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int j = 0; j < 2; ++j)
          if (k0 + n * 8 + 2 * t4 + j >= a.n_k)
            s[4 * n + j] = s[4 * n + 2 + j] = -INFINITY;
    }
    // the max over the lane's 32 values of a row in four chains (one chain
    // of 32 dependent operations stalls the warps of a scheduler), both
    // rows at each step, so that one row's exponentials can overlap the
    // other's reduction
    const auto fmax2 = [](float x, float y) { return fmaxf(x, y); };
    float mx[2];
#pragma unroll
    for (int h = 0; h < 2; ++h)
      mx[h] = fmaxf(m_run[h], row_reduce(s, h, fmax2));
#pragma unroll
    for (int h = 0; h < 2; ++h) mx[h] = fmaxf(mx[h], shfl_xor(mx[h], 1));
#pragma unroll
    for (int h = 0; h < 2; ++h) mx[h] = fmaxf(mx[h], shfl_xor(mx[h], 2));
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      alpha[h] = exp2_ftz(m_run[h] - mx[h]);
      m_run[h] = mx[h];
    }
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int i = 0; i < 4; ++i)
        s[4 * n + i] = exp2_ftz(s[4 * n + i] - mx[i / 2]);
  };
  // O and the row sums times alpha, and the weights of n-tiles 2c, 2c+1
  // packed as the A fragment of k-step c
  auto rescale_and_pack = [&]() {
#pragma unroll
    for (int j = 0; j < ND; ++j) {
      o[4 * j + 0] *= alpha[0];
      o[4 * j + 1] *= alpha[0];
      o[4 * j + 2] *= alpha[1];
      o[4 * j + 3] *= alpha[1];
    }
#pragma unroll
    for (int j = 0; j < NN; ++j) {
      on[4 * j + 0] *= alpha[0];
      on[4 * j + 1] *= alpha[0];
      on[4 * j + 2] *= alpha[1];
      on[4 * j + 3] *= alpha[1];
    }
    l_acc[0] *= alpha[0];
    l_acc[1] *= alpha[0];
    l_acc[2] *= alpha[1];
    l_acc[3] *= alpha[1];
#pragma unroll
    for (int c = 0; c < NT / 2; ++c) {
      p[c][0] = pack_bf16x2(s[8 * c + 0], s[8 * c + 1]);
      p[c][1] = pack_bf16x2(s[8 * c + 2], s[8 * c + 3]);
      p[c][2] = pack_bf16x2(s[8 * c + 4], s[8 * c + 5]);
      p[c][3] = pack_bf16x2(s[8 * c + 6], s[8 * c + 7]);
    }
  };
  // the accumulators PV writes
  auto fence_acc = [&]() {
    fence_operands(o);
    if constexpr (NN > 0) fence_operands(on);
    fence_operands(l_acc);
  };
  auto fence_p = [&]() {
#pragma unroll
    for (int c = 0; c < NT / 2; ++c) fence_operands(p[c]);
  };
  // a stage's K or V is read when this warp's wgmma_wait returns: one
  // arrival per warp
  auto release = [&](uint32_t bar) {
    if (lane == 0) mbar_arrive(bar);
  };

  // Tile 0 alone; then each step issues S of tile it and PV of tile it - 1
  // together, so that the tensor cores run PV while the softmax of tile it
  // runs on the same warpgroup.  K of tile it is released when S is in, V
  // of tile it - 1 when PV is.
  // Ping-pong: the warpgroups issue their products in turn (named barriers
  // 2, 3, 4: a warpgroup waits for its own, then lets the next one go), so
  // that one's exponentials run while another's products do.  The last
  // warpgroup primes the first one's barrier; each barrier then has at most
  // one arrival pending, and the last turn of the last warpgroup lets no
  // one go.
  constexpr int S = C::kStages;
  constexpr int WGS = C::kConsumers / 128;
  auto my_turn = [&]() { named_barrier_sync(2 + wg, 256); };
  auto next_turn = [&]() { named_barrier_arrive(2 + (wg + 1) % WGS, 256); };
  if (wg == WGS - 1) next_turn();
  mbar_wait(L.k_full(0), 0);
  my_turn();
  wgmma_fence();
  issue_qk(0);
  next_turn();
  wgmma_wait<0>();
  fence_operands(s);
  release(L.k_empty(0));
  softmax(0);
  rescale_and_pack();
  for (int it = 1; it < n_tiles; ++it) {
    const int stage = it % S;
    const int prev = (it - 1) % S;
    mbar_wait(L.k_full(stage), (it / S) & 1);
    mbar_wait(L.v_full(prev), ((it - 1) / S) & 1);
    fence_acc();
    fence_p();
    my_turn();
    wgmma_fence();
    issue_qk(stage);
    issue_pv(prev);
    next_turn();
    wgmma_wait<1>();   // S is in; PV may still run
    fence_operands(s);
    release(L.k_empty(stage));
    softmax(it);
    wgmma_wait<0>();
    fence_acc();
    fence_p();
    release(L.v_empty(prev));
    rescale_and_pack();
  }
  const int last = n_tiles - 1;
  mbar_wait(L.v_full(last % S), (last / S) & 1);
  fence_acc();
  fence_p();
  my_turn();
  wgmma_fence();
  issue_pv(last % S);
  if (wg != WGS - 1) next_turn();
  wgmma_wait<0>();
  fence_acc();

  T* out = static_cast<T*>(a.o) + offset(a.o_s, outer, head);
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const float inv = 1.f / l_acc[2 * h];
    const int tok = q0 + row0 + 8 * h;
    if (tok >= a.n_q) continue;
    T* orow = out + tok * a.o_s[2] + 2 * t4;
#pragma unroll
    for (int j = 0; j < ND; ++j)
      *reinterpret_cast<uint32_t*>(orow + j * 8) =
          pack_bf16x2(o[4 * j + 2 * h] * inv, o[4 * j + 2 * h + 1] * inv);
#pragma unroll
    for (int j = 0; j < NN; ++j)
      *reinterpret_cast<uint32_t*>(orow + kHopWide + j * 8) =
          pack_bf16x2(on[4 * j + 2 * h] * inv, on[4 * j + 2 * h + 1] * inv);
  }
}

// tn, kn, vn: the maps of the 32-byte parts (hd 80; unread at hd 64)
template <int D, bool ROW_TILE>
__global__ void __launch_bounds__(Hop<D>::kThreads, 1)
    hopper_global_kernel(const __grid_constant__ CUtensorMap tq,
                         const __grid_constant__ CUtensorMap tk,
                         const __grid_constant__ CUtensorMap tv,
                         const __grid_constant__ CUtensorMap tqn,
                         const __grid_constant__ CUtensorMap tkn,
                         const __grid_constant__ CUtensorMap tvn,
                         const AttnArgs a) {
  using C = Hop<D>;
  using namespace sm90;
  extern __shared__ __align__(1024) unsigned char hop_smem[];
  // the 128-byte swizzle repeats every 1024 bytes: tiles start on that
  const uint32_t raw = smem_u32(hop_smem);
  const uint32_t pad = (1024u - (raw & 1023u)) & 1023u;
  const HopLayout<D> L = {
      raw + pad,
      reinterpret_cast<float*>(hop_smem + pad + C::kQBytes +
                               C::kStageBytes * C::kStages + kHopBarBytes +
                               kHopOnesBytes)};
  const int tid = threadIdx.x;
  const int bh = blockIdx.x / a.n_qblocks;
  const int outer = bh / a.heads, head = bh % a.heads;
  const int q0 = (blockIdx.x % a.n_qblocks) * C::kBlockQ;
  const int n_tiles = (a.n_k + kHopBlockK - 1) / kHopBlockK;

  if (tid == 0) {
    for (int s = 0; s < C::kStages; ++s) {
      mbar_init(L.k_full(s), 1);
      mbar_init(L.v_full(s), 1);
      mbar_init(L.k_empty(s), C::kConsumers / 32);
      mbar_init(L.v_empty(s), C::kConsumers / 32);
    }
    mbar_init(L.q_bar(), 1);
    fence_barrier_init();
  }
  __syncthreads();

  if (tid >= C::kConsumers) {
    // the producer: Q once, then K and V tiles as the consumers free their
    // slots
    setmaxnreg_dec<24>();
    if (tid == C::kConsumers) {
      auto load = [&](uint32_t wide, uint32_t narrow, const CUtensorMap* m,
                      const CUtensorMap* mn, uint32_t bar, int row) {
        tma_load_4d(wide, m, bar, 0, row, head, outer);
        if constexpr (C::kNarrow > 0)
          tma_load_4d(narrow, mn, bar, 0, row, head, outer);
      };
      mbar_arrive_expect_tx(L.q_bar(), C::kQBytes);
      load(L.q, L.q_narrow(), &tq, &tqn, L.q_bar(), q0);
      for (int it = 0; it < n_tiles; ++it) {
        const int s = it % C::kStages;
        const uint32_t parity = ((it / C::kStages) & 1) ^ 1;
        mbar_wait(L.k_empty(s), parity);
        mbar_arrive_expect_tx(L.k_full(s), C::kTileBytes);
        load(L.k_tile(s), L.k_narrow(s), &tk, &tkn, L.k_full(s),
             it * kHopBlockK);
        mbar_wait(L.v_empty(s), parity);
        mbar_arrive_expect_tx(L.v_full(s), C::kTileBytes);
        load(L.v_tile(s), L.v_narrow(s), &tv, &tvn, L.v_full(s),
             it * kHopBlockK);
      }
    }
  } else {
    setmaxnreg_inc<C::kRegs>();
    consume<D, ROW_TILE>(a, L, outer, head, q0, n_tiles);
  }
}

// ---------------------------------------------------------------------------
// host side
// ---------------------------------------------------------------------------
// The shapes this routine takes (batch = outer x heads): bf16, head dim 64
// or 80, and bias rows that fit in shared memory.
inline bool hopper_global_takes(const AttnArgs& a, int batch, int head_dim,
                                int dtype) {
  if (bad_shape(a, batch, dtype, true) || dtype != 1) return false;
  const int gh = a.n_k / a.gw;
  if (head_dim == 64) return hopper_smem_bytes<64>(gh, a.gw) <= kHopMaxSmem;
  if (head_dim == 80) return hopper_smem_bytes<80>(gh, a.gw) <= kHopMaxSmem;
  return false;
}

// Returns a cudaError_t as int: cudaErrorInvalidValue for operands TMA
// cannot read (the Python wrapper checks them first), cudaErrorNotSupported
// without the tensor-map encoder of libcuda.
template <int D>
inline int launch_hopper_global(AttnArgs a, int outer, void* stream) {
  using C = Hop<D>;
  const EncodeTiledFn enc = encode_tiled();
  if (enc == nullptr) return (int)cudaErrorNotSupported;
  // the 128-byte parts; at hd 80 the 32-byte parts too (at hd 64 the
  // kernel is given the first maps again and reads none)
  CUtensorMap m[6];
  const void* ptr[3] = {a.q, a.k, a.v};
  const long long* st[3] = {a.q_s, a.k_s, a.v_s};
  const int rows[3] = {a.n_q, a.n_k, a.n_k};
  const int box[3] = {C::kBlockQ, kHopBlockK, kHopBlockK};
  for (int i = 0; i < 3; ++i) {
    if (!tile_map(enc, &m[i], ptr[i], st[i], outer, a.heads, rows[i],
                  box[i]))
      return (int)cudaErrorInvalidValue;
    m[3 + i] = m[i];
    if (C::kNarrow > 0 &&
        !tile_map(enc, &m[3 + i], ptr[i], st[i], outer, a.heads, rows[i],
                  box[i], kHopWide, C::kNarrow, CU_TENSOR_MAP_SWIZZLE_32B))
      return (int)cudaErrorInvalidValue;
  }
  a.n_qblocks = (a.n_q + C::kBlockQ - 1) / C::kBlockQ;
  const size_t smem = hopper_smem_bytes<D>(a.n_k / a.gw, a.gw);
  auto kernel = a.gw == kHopBlockK / 2 ? hopper_global_kernel<D, true>
                                       : hopper_global_kernel<D, false>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<outer * a.heads * a.n_qblocks, C::kThreads, smem,
           static_cast<cudaStream_t>(stream)>>>(m[0], m[1], m[2], m[3], m[4],
                                                m[5], a);
  return (int)cudaGetLastError();
}

}  // namespace lameness
