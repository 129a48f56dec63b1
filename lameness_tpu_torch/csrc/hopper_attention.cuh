// The Hopper global attention routine: softmax(scale·q·kᵀ + rh[t, j / GW] +
// rw[t, j % GW]) · v in bf16 with wgmma and TMA (sm_90a).  K3, K4, K5 and
// K6 launch it through global_entry (global_attention.cuh), which chooses
// it by shape.  The tensors are addressed as (outer, head, token) with a
// stride each: K3-K5 have one head per outer index, K6 reads head-last
// (B, N, nH, hd) slices of the qkv output and its (B, N, nH, ·) tables in
// place, so the TMA maps are 4-D, {hd, tokens, heads, outer}.
//
// A block owns 192 query rows of one (outer, head) and walks the keys in
// tiles of 128 with an online softmax:
//   * warps 0-11 are three consumer warpgroups of 64 rows each; warps 12-15
//     the producer warpgroup, one lane of which issues every copy.  The
//     producer gives up registers (setmaxnreg: 24 a thread) so that the
//     consumers get 160 and keep S, O and P in registers;
//   * Q (192 x 64) comes in once by TMA; K and V tiles (128 x 64 each, rows
//     of 128 bytes under the 128-byte swizzle) through a ring of kHopStages
//     stages, each with a "full" mbarrier (TMA bytes) and an "empty" one (384
//     consumer arrivals);
//   * S = Q·Kᵀ: 4 wgmma m64n128k16, both operands in shared memory, K-major;
//   * the bias in the exp2 domain from the block's f32 bias rows staged in
//     shared memory, as K3 adds it: on the 64-column grid a key tile is two
//     grid rows, so rh is two values per row and tile and rw one per column
//     (each read once for two scores); otherwise rh and rw are gathered per
//     score; keys past N -> -inf;
//   * the online softmax in registers (the row max over the 4 lanes of a
//     row by shuffles, both rows of a lane at each step), P packed to bf16
//     in registers;
//   * O += P·V: 8 wgmma m64n64k16 with A = P from registers and B = the V
//     tile, MN-major (the descriptor's transpose bit); the row sums on the
//     tensor cores too, as P times a block of ones (8 wgmma m64n8k16), which
//     takes 64 additions per tile off each thread.  PV of tile i - 1 is
//     issued with S of tile i, and runs on the tensor cores while the
//     warpgroup computes the softmax of tile i;
//   * the denominator applied at the end; bf16 stores straight from the
//     accumulators;
//   * the three warpgroups issue their products in turn (ping-pong on named
//     barriers), so that one's exponentials run while another's products
//     do.
// Blocks of one head are adjacent in the grid, so its K/V (1 MB) stays in L2.
// Head-last K/V tiles are 128 rows of 128 bytes at the token stride (4608
// bytes in the engine's fused qkv output): the same bytes, in more rows.
// What bounds it, at the engine's shapes (264 heads of 4096 x 64; measured
// on the H100 by scripts/k5_breakdown.py, which builds copies of this
// kernel with parts left out, PERF.md): the whole
// 3.13 ms; without the products 2.79, without the softmax 1.72, the K/V
// stream and the bias staging alone 0.84.  So the softmax bounds it: its
// exponentials alone need 1.2 ms (16 per clock per SM), and its FP32 work
// shares the warps' issue slots with them.  The design spends FP32
// instructions sparingly (the row sums on the tensor cores, the max in four
// chains) and hides the products behind the softmax.
#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

#include "attention.cuh"
#include "hopper.cuh"

namespace lameness {

constexpr int kHopBlockQ = 192;     // query rows per block: 3 x 64
constexpr int kHopBlockK = 128;     // keys per K/V tile
constexpr int kHopD = 64;           // head dim: one 128-byte swizzled row
constexpr int kHopStages = 3;
constexpr int kHopConsumers = 384;  // three warpgroups
constexpr int kHopThreads = kHopConsumers + 128;  // + the producer warpgroup
constexpr int kHopTileBytes = kHopBlockK * kHopD * 2;   // K or V: 16 KB
constexpr int kHopQBytes = kHopBlockQ * kHopD * 2;      // Q: 24 KB
constexpr int kHopBarBytes = 64;    // 2·kHopStages + 1 mbarriers, padded
constexpr int kHopOnesBytes = 1024; // bf16 ones: B of the row sums
constexpr size_t kHopMaxSmem = 232448;   // a block's limit on the H100

// Shared memory: 1 KB of alignment slack; Q; kHopStages x (K, V); the
// mbarriers; the ones; the f32 bias rows sRH[192][GH + 1] and
// sRW[192][GW + 1].
inline size_t hopper_smem_bytes(int gh, int gw) {
  return 1024 + kHopQBytes + (size_t)kHopTileBytes * 2 * kHopStages +
         kHopBarBytes + kHopOnesBytes +
         sizeof(float) * kHopBlockQ * (size_t)(gh + 1 + gw + 1);
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

// Rows q0 .. q0 + kHopBlockQ - 1 of a bf16 (GH, GW, width) table (token
// t at (t / GW)·row + (t % GW)·col) into dst[r·pitch + c] as f32·log2e,
// zeros past n_q; run by the consumers.  Where width, the strides and the
// address allow, in 16-byte loads, a thread's four loads issued before its
// stores (a block stages 48 KB of tables before its first tile: one
// dependent load per element made that a large share of the kernel).
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
    for (int i = tid; i < kHopBlockQ * width; i += kHopConsumers) {
      const int r = i / width, c = i - r * width, tok = q0 + r;
      dst[r * pitch + c] =
          tok < n_q ? __bfloat162float(row(tok)[c]) * kLog2e : 0.f;
    }
    return;
  }
  constexpr int U = 4;
  const int chunks = width / 8, total = kHopBlockQ * chunks;
  for (int base = tid; base < total; base += U * kHopConsumers) {
    uint4 v[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int i = base + u * kHopConsumers;
      const int r = i / chunks, tok = q0 + r;
      v[u] = make_uint4(0, 0, 0, 0);
      if (i < total && tok < n_q)
        v[u] = __ldg(reinterpret_cast<const uint4*>(row(tok) +
                                                    (i - r * chunks) * 8));
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int i = base + u * kHopConsumers;
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
// and the ones (shared-window addresses), and the bias rows.
struct HopLayout {
  uint32_t q;       // 1024-byte aligned
  float* rh;        // sRH[192][GH + 1], then sRW[192][GW + 1]
  __device__ uint32_t k_tile(int s) const {
    return q + kHopQBytes + kHopTileBytes * 2 * s;
  }
  __device__ uint32_t v_tile(int s) const {
    return q + kHopQBytes + kHopTileBytes * (2 * s + 1);
  }
  __device__ uint32_t bar(int i) const {
    return q + kHopQBytes + kHopTileBytes * 2 * kHopStages + 8 * i;
  }
  __device__ uint32_t full(int s) const { return bar(s); }
  __device__ uint32_t empty(int s) const { return bar(kHopStages + s); }
  __device__ uint32_t q_bar() const { return bar(2 * kHopStages); }
  __device__ uint32_t ones() const { return bar(0) + kHopBarBytes; }
};

// The consumer warpgroups of hopper_global_kernel (tid < kHopConsumers).
template <bool ROW_TILE>
__device__ __forceinline__ void consume(const AttnArgs& a, const HopLayout& L,
                                        int outer, int head, int q0,
                                        int n_tiles) {
  using T = __nv_bfloat16;
  using namespace sm90;
  constexpr int NT = kHopBlockK / 8;   // n-tiles of a score row: 16
  constexpr int ND = kHopD / 8;        // n-tiles of an output row: 8
  const int gh = a.n_k / a.gw;
  const int rhp = gh + 1, rwp = a.gw + 1;   // odd pitches: fewer conflicts
  float* sRH = L.rh;
  float* sRW = sRH + kHopBlockQ * rhp;
  const int tid = threadIdx.x;

  // the block's bias rows, f32, in the exp2 domain
  stage_rows(sRH, rhp,
             static_cast<const T*>(a.rh) + offset(a.rh_s, outer, head),
             a.rh_row, a.rh_s[2], a.gw, gh, q0, a.n_q);
  stage_rows(sRW, rwp,
             static_cast<const T*>(a.rw) + offset(a.rw_s, outer, head),
             a.rw_row, a.rw_s[2], a.gw, a.gw, q0, a.n_q);
  // the ones (B of the row sums: any layout of ones reads as ones)
  uint32_t* ones = reinterpret_cast<uint32_t*>(sRH) - kHopOnesBytes / 4;
  for (int i = tid; i < kHopOnesBytes / 4; i += kHopConsumers)
    ones[i] = 0x3F803F80u;   // two bf16 1.0
  fence_proxy_async();       // generic stores, read by wgmma
  named_barrier_sync(1, kHopConsumers);

  const int wg = tid / 128, warp = (tid % 128) / 32, lane = tid % 32;
  const int g = lane / 4, t4 = lane % 4;
  const int row0 = wg * 64 + warp * 16 + g;   // this lane's rows: row0, +8
  const float scale2 = a.scale * kLog2e;
  const float inv_gw = 1.f / (float)a.gw;

  // ROW_TILE: this lane's rw values, column 8n + 2·t4 + j of rows row0 and
  // row0 + 8
  const float* rw_lo = sRW + row0 * rwp + 2 * t4;
  const float* rw_hi = rw_lo + 8 * rwp;

  float s[4 * NT];        // scores, then weights: the m64n128 accumulator
  float o[4 * ND];        // output: the m64n64 accumulator
  uint32_t p[NT / 2][4];  // the weights in bf16: A of PV's 8 k-steps
#pragma unroll
  for (int i = 0; i < 4 * NT; ++i) s[i] = 0.f;
#pragma unroll
  for (int i = 0; i < 4 * ND; ++i) o[i] = 0.f;
  float m_run[2] = {-INFINITY, -INFINITY};
  // row sums of the bf16 weights, taken by the tensor cores as P times a
  // block of ones (m64n8: every column of row r holds its sum)
  float l_acc[4] = {0.f, 0.f, 0.f, 0.f};
  const uint64_t desc_ones = desc_plain(L.ones(), 128, 256);
  float alpha[2];

  mbar_wait(L.q_bar(), 0);
  const uint64_t desc_q = desc_sw128(L.q + wg * 64 * 128);

  // S = Q Kᵀ of one stage, over the head dim: 4 k-steps of 16 (+2 each)
  auto issue_qk = [&](int stage) {
    const uint64_t desc_k = desc_sw128(L.k_tile(stage));
#pragma unroll
    for (int kk = 0; kk < kHopD / 16; ++kk)
      wgmma_m64n128k16_ss(s, desc_q + 2 * kk, desc_k + 2 * kk, kk > 0);
    wgmma_commit();
  };
  // O += P V of one stage: the V tile advances 16 rows (+128) per k-step
  auto issue_pv = [&](int stage) {
    const uint64_t desc_v = desc_sw128(L.v_tile(stage));
#pragma unroll
    for (int c = 0; c < NT / 2; ++c)
      wgmma_m64n64k16_rs(o, p[c], desc_v + 128 * c);
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
      for (int n = 0; n < ND; ++n)
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const float lo = rw_lo[8 * n + j], hi = rw_hi[8 * n + j];
#pragma unroll
          for (int half = 0; half < 2; ++half) {
            const int i = 4 * (n + ND * half) + j;
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
  auto fence_p = [&]() {
#pragma unroll
    for (int c = 0; c < NT / 2; ++c) fence_operands(p[c]);
  };

  // Tile 0 alone; then each step issues S of tile it and PV of tile it - 1
  // together, so that the tensor cores run PV while the softmax of tile it
  // runs on the same warpgroup.
  // Ping-pong: the warpgroups issue their products in turn (named barriers
  // 2, 3, 4: a warpgroup waits for its own, then lets the next one go), so
  // that one's exponentials run while another's products do.  The last
  // warpgroup primes the first one's barrier; each barrier then has at most
  // one arrival pending, and the last turn of the last warpgroup lets no
  // one go.
  constexpr int WGS = kHopConsumers / 128;
  auto my_turn = [&]() { named_barrier_sync(2 + wg, 256); };
  auto next_turn = [&]() { named_barrier_arrive(2 + (wg + 1) % WGS, 256); };
  if (wg == WGS - 1) next_turn();
  mbar_wait(L.full(0), 0);
  my_turn();
  wgmma_fence();
  issue_qk(0);
  next_turn();
  wgmma_wait<0>();
  fence_operands(s);
  softmax(0);
  rescale_and_pack();
  for (int it = 1; it < n_tiles; ++it) {
    const int stage = it % kHopStages;
    const int prev = (it - 1) % kHopStages;
    mbar_wait(L.full(stage), (it / kHopStages) & 1);
    fence_operands(o);
    fence_operands(l_acc);
    fence_p();
    my_turn();
    wgmma_fence();
    issue_qk(stage);
    issue_pv(prev);
    next_turn();
    wgmma_wait<1>();   // S is in; PV may still run
    fence_operands(s);
    softmax(it);
    wgmma_wait<0>();
    fence_operands(o);
    fence_operands(l_acc);
    fence_p();
    mbar_arrive(L.empty(prev));   // K and V of tile it - 1 are read
    rescale_and_pack();
  }
  fence_operands(o);
  fence_operands(l_acc);
  fence_p();
  my_turn();
  wgmma_fence();
  issue_pv((n_tiles - 1) % kHopStages);
  if (wg != WGS - 1) next_turn();
  wgmma_wait<0>();
  fence_operands(o);
  fence_operands(l_acc);

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
  }
}

template <bool ROW_TILE>
__global__ void __launch_bounds__(kHopThreads, 1)
    hopper_global_kernel(const __grid_constant__ CUtensorMap tq,
                         const __grid_constant__ CUtensorMap tk,
                         const __grid_constant__ CUtensorMap tv,
                         const AttnArgs a) {
  using namespace sm90;
  extern __shared__ __align__(1024) unsigned char hop_smem[];
  // the 128-byte swizzle repeats every 1024 bytes: tiles start on that
  const uint32_t raw = smem_u32(hop_smem);
  const uint32_t pad = (1024u - (raw & 1023u)) & 1023u;
  const HopLayout L = {
      raw + pad, reinterpret_cast<float*>(
                     hop_smem + pad + kHopQBytes +
                     kHopTileBytes * 2 * kHopStages + kHopBarBytes +
                     kHopOnesBytes)};
  const int tid = threadIdx.x;
  const int bh = blockIdx.x / a.n_qblocks;
  const int outer = bh / a.heads, head = bh % a.heads;
  const int q0 = (blockIdx.x % a.n_qblocks) * kHopBlockQ;
  const int n_tiles = (a.n_k + kHopBlockK - 1) / kHopBlockK;

  if (tid == 0) {
    for (int s = 0; s < kHopStages; ++s) {
      mbar_init(L.full(s), 1);
      mbar_init(L.empty(s), kHopConsumers);
    }
    mbar_init(L.q_bar(), 1);
    fence_barrier_init();
  }
  __syncthreads();

  if (tid >= kHopConsumers) {
    // the producer: Q once, then K/V tiles as the consumers free stages
    setmaxnreg_dec<24>();
    if (tid == kHopConsumers) {
      mbar_arrive_expect_tx(L.q_bar(), kHopQBytes);
      tma_load_4d(L.q, &tq, L.q_bar(), 0, q0, head, outer);
      for (int it = 0; it < n_tiles; ++it) {
        const int s = it % kHopStages;
        mbar_wait(L.empty(s), ((it / kHopStages) & 1) ^ 1);
        mbar_arrive_expect_tx(L.full(s), 2 * kHopTileBytes);
        tma_load_4d(L.k_tile(s), &tk, L.full(s), 0, it * kHopBlockK, head,
                    outer);
        tma_load_4d(L.v_tile(s), &tv, L.full(s), 0, it * kHopBlockK, head,
                    outer);
      }
    }
  } else {
    setmaxnreg_inc<160>();
    consume<ROW_TILE>(a, L, outer, head, q0, n_tiles);
  }
}

// ---------------------------------------------------------------------------
// host side
// ---------------------------------------------------------------------------
// The shapes this routine takes (batch = outer x heads): bf16, head dim 64,
// and bias rows that fit in shared memory.
inline bool hopper_global_takes(const AttnArgs& a, int batch, int head_dim,
                                int dtype) {
  return !bad_shape(a, batch, dtype, true) && dtype == 1 &&
         head_dim == kHopD &&
         hopper_smem_bytes(a.n_k / a.gw, a.gw) <= kHopMaxSmem;
}

// Returns a cudaError_t as int: cudaErrorInvalidValue for operands TMA
// cannot read (the Python wrapper checks them first), cudaErrorNotSupported
// without the tensor-map encoder of libcuda.
inline int launch_hopper_global(AttnArgs a, int outer, void* stream) {
  const EncodeTiledFn enc = encode_tiled();
  if (enc == nullptr) return (int)cudaErrorNotSupported;
  CUtensorMap tq, tk, tv;
  if (!tile_map(enc, &tq, a.q, a.q_s, outer, a.heads, a.n_q, kHopBlockQ) ||
      !tile_map(enc, &tk, a.k, a.k_s, outer, a.heads, a.n_k, kHopBlockK) ||
      !tile_map(enc, &tv, a.v, a.v_s, outer, a.heads, a.n_k, kHopBlockK))
    return (int)cudaErrorInvalidValue;
  a.n_qblocks = (a.n_q + kHopBlockQ - 1) / kHopBlockQ;
  const size_t smem = hopper_smem_bytes(a.n_k / a.gw, a.gw);
  auto kernel = a.gw == kHopBlockK / 2 ? hopper_global_kernel<true>
                                       : hopper_global_kernel<false>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<outer * a.heads * a.n_qblocks, kHopThreads, smem,
           static_cast<cudaStream_t>(stream)>>>(tq, tk, tv, a);
  return (int)cudaGetLastError();
}

}  // namespace lameness
