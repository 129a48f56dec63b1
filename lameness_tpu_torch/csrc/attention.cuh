// One online-softmax attention routine, shared by the port's nine kernels
// (each of which has a routine of its own for its main shapes in bf16: K1
// dino_attention.cuh and K3-K6 hopper_attention.cuh at head dim 64, K2, K7,
// K8 and K9 window_attention.cuh at head dims 64 and 80; their other shapes
// come here, K3-K6 at ViT-H's head dim 80 among them):
//   K1 attention.cu               softmax(q k^T scale) v               (DINO)
//   K2 sam_window_attention.cu    + decomposed rel-pos bias, 14x14 windows,
//                                 head-last views of the qkv output
//   K9 sam_window_attention_v5.cu the same function and layout
//   K7 sam_window_attention_v1.cu the same function, head-major windows
//   K8 sam_window_attention_v2.cu the same function and layout
//   K3 sam_global_attention.cu    + decomposed rel-pos bias, 64x64 grid
//   K4 sam_global_attention_v1.cu the same function and layout
//   K5 sam_global_attention_v2.cu the same function and layout
//   K6 sam_global_attention_v3.cu the same function, head-last
// Each .cu keeps its own C entry point; this header holds the device code and
// the host-side dispatch over dtype and the head dim D, the width of both
// QK^T's contraction and PV's output.
//
// Bias: BIAS adds rh[t, j / gw] + rw[t, j % gw] to every score, read from
// the q-projected tables and never materialised (K2-K9).  K1 takes none.
//
// Common to both dtypes:
//   * a block owns 64 query rows of one (batch, head) and walks the keys in
//     tiles with an online softmax, so no (N, N) score or bias tensor ever
//     reaches device memory; all accumulation is f32.  The softmax
//     denominator is applied after PV (the plain versions of K2-K8 divide
//     before PV, as their TPU kernels do; inside the bf16 tolerance);
//   * keys past n_k are masked to -inf here, so callers pad nothing;
//   * tensors are addressed through strides (batch index b splits into
//     b / heads and b % heads), so head-last views of a fused qkv output are
//     read in place; only the feature axis must be contiguous.  The bias
//     tables' token t lies at (t / gw)·row + (t % gw)·s[2] (rh_row,
//     rw_row), so the global entries read the (BH, GH, GW, ·) tables where
//     the rel-pos einsum leaves them, grid-row-major or not;
//   * the grid is 1-D with the q block fastest, so the blocks of one head
//     run together and share its K/V through L2.
//
// bfloat16 (the engine's working dtype on the card): attention_mma_kernel.
//   4 warps x 16 query rows; 64-key K/V tiles double-buffered in shared
//   memory by cp.async; QK^T and PV on the tensor cores (mma.sync m16n8k16,
//   bf16 in, f32 accumulate), P kept in registers as the A operand of PV;
//   the bias tables of the block's rows staged once in shared memory (on
//   the 64x64 grid the rw part then lives in registers: ROW_TILE); the
//   softmax in the exp2 domain, row max and sum across the 4 lanes of a
//   row by shuffles; K and V fragments by ldmatrix.  No wgmma or TMA (the
//   Hopper routines of K1 and K3-K6 have them), so the CPU emulation runs
//   it.
// float32 (exact reference path): attention_f32_kernel, plain FMA loops with
//   a 4x2 (scores) and 4x(D/16) (output) register tile per thread, one
//   thread per row for the softmax, no tensor cores.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

#include "mma.cuh"

namespace lameness {

constexpr float kLog2e = 1.4426950408889634f;

struct AttnArgs {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  const void* rh;  // (.., n_q, gh) projected row table, or null
  const void* rw;  // (.., n_q, gw) projected column table, or null
  int n_q;
  int n_k;
  int heads;     // batch index b -> (b / heads, b % heads)
  int gw;        // key j -> bias row j / gw, bias column j % gw
  int n_qblocks;  // blocks per (batch, head): ceil(n_q / 64)
  float scale;
  // element strides {outer, head, token}; the feature axis has stride 1
  long long q_s[3], k_s[3], v_s[3], o_s[3], rh_s[3], rw_s[3];
  // the tables' grid-row strides: token t's row of rh at
  // (t / gw)·rh_row + (t % gw)·rh_s[2] (gw·rh_s[2] where tokens are evenly
  // spaced, as sam_args sets it), rw alike
  long long rh_row, rw_row;
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

__device__ __forceinline__ long long offset(const long long* s, int outer,
                                            int head) {
  return (long long)outer * s[0] + (long long)head * s[1];
}

// the offset of token tok's row in a bias table of grid width gw, at grid
// row stride `row` and grid column stride `col`
__host__ __device__ __forceinline__ long long table_row(long long row,
                                                        long long col, int gw,
                                                        int tok) {
  return (long long)(tok / gw) * row + (long long)(tok % gw) * col;
}

// ---------------------------------------------------------------------------
// float32: FMA loops
// ---------------------------------------------------------------------------
constexpr int kThreads = 256;
constexpr int kBlockQ = 64;
constexpr int kBlockK = 32;

template <int D>
constexpr size_t f32_smem_bytes() {
  // sQ[kBlockQ][D+1], sK[kBlockK][D+1], sV[kBlockK][D],
  // sP[kBlockQ][kBlockK+1], sRow[kBlockQ]
  return sizeof(float) *
         ((size_t)kBlockQ * (D + 1) + (size_t)kBlockK * (D + 1) +
          (size_t)kBlockK * D + (size_t)kBlockQ * (kBlockK + 1) + kBlockQ);
}

template <int D, bool BIAS>
__global__ void __launch_bounds__(kThreads)
    attention_f32_kernel(const AttnArgs a) {
  static_assert(D % 16 == 0, "the head dim must be a multiple of 16");
  constexpr int QP = D + 1;        // padded rows: conflict-free column reads
  constexpr int PP = kBlockK + 1;
  constexpr int DJ = D / 16;       // output columns per thread
  extern __shared__ float smem[];
  float* sQ = smem;
  float* sK = sQ + kBlockQ * QP;
  float* sV = sK + kBlockK * QP;
  float* sP = sV + kBlockK * D;
  float* sRow = sP + kBlockQ * PP;

  const int tid = threadIdx.x;
  const int ty = tid / 16;         // rows ty*4 .. ty*4+3
  const int tx = tid % 16;         // score cols tx, tx+16; out cols tx+16j
  const int bh = blockIdx.x / a.n_qblocks;
  const int outer = bh / a.heads;
  const int head = bh % a.heads;
  const int q0 = (blockIdx.x % a.n_qblocks) * kBlockQ;

  const float* q = static_cast<const float*>(a.q) + offset(a.q_s, outer, head);
  const float* k = static_cast<const float*>(a.k) + offset(a.k_s, outer, head);
  const float* v = static_cast<const float*>(a.v) + offset(a.v_s, outer, head);
  float* o = static_cast<float*>(a.o) + offset(a.o_s, outer, head);
  const float* rh = nullptr;
  const float* rw = nullptr;
  if (BIAS) {
    rh = static_cast<const float*>(a.rh) + offset(a.rh_s, outer, head);
    rw = static_cast<const float*>(a.rw) + offset(a.rw_s, outer, head);
  }

  for (int i = tid; i < kBlockQ * D; i += kThreads) {
    const int r = i / D, d = i % D, t = q0 + r;
    sQ[r * QP + d] = t < a.n_q ? q[t * a.q_s[2] + d] : 0.f;
  }

  float acc[4][DJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < DJ; ++j) acc[i][j] = 0.f;
  // running max and sum of the row this thread owns in the softmax pass
  float m_run = -INFINITY, l_run = 0.f;

  for (int k0 = 0; k0 < a.n_k; k0 += kBlockK) {
    for (int i = tid; i < kBlockK * D; i += kThreads) {
      const int c = i / D, d = i % D, t = k0 + c;
      sK[c * QP + d] = t < a.n_k ? k[t * a.k_s[2] + d] : 0.f;
    }
    for (int i = tid; i < kBlockK * D; i += kThreads) {
      const int c = i / D, d = i % D, t = k0 + c;
      sV[c * D + d] = t < a.n_k ? v[t * a.v_s[2] + d] : 0.f;
    }
    __syncthreads();

    // scores: rows ty*4+i, key columns tx and tx+16
    float s[4][2];
#pragma unroll
    for (int i = 0; i < 4; ++i) s[i][0] = s[i][1] = 0.f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      const float k_a = sK[tx * QP + d];
      const float k_b = sK[(tx + 16) * QP + d];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float qv = sQ[(ty * 4 + i) * QP + d];
        s[i][0] = fmaf(qv, k_a, s[i][0]);
        s[i][1] = fmaf(qv, k_b, s[i][1]);
      }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty * 4 + i, t = q0 + r;
      const float* rh_t =
          BIAS ? rh + table_row(a.rh_row, a.rh_s[2], a.gw, t) : nullptr;
      const float* rw_t =
          BIAS ? rw + table_row(a.rw_row, a.rw_s[2], a.gw, t) : nullptr;
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int c = tx + 16 * j, key = k0 + c;
        float val = -INFINITY;
        if (key < a.n_k) {
          val = s[i][j] * a.scale;
          if (BIAS && t < a.n_q)
            val += rh_t[key / a.gw] + rw_t[key % a.gw];
        }
        sP[r * PP + c] = val;
      }
    }
    __syncthreads();

    // online softmax, one thread per row; the first tile always holds a
    // valid key, so m_new is finite and exp(-inf - m_new) == 0 masks
    if (tid < kBlockQ) {
      float* p = sP + tid * PP;
      float mx = m_run;
      for (int c = 0; c < kBlockK; ++c) mx = fmaxf(mx, p[c]);
      const float alpha = expf(m_run - mx);
      float sum = 0.f;
      for (int c = 0; c < kBlockK; ++c) {
        const float e = expf(p[c] - mx);
        p[c] = e;
        sum += e;
      }
      l_run = l_run * alpha + sum;
      m_run = mx;
      sRow[tid] = alpha;
    }
    __syncthreads();

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float alpha = sRow[ty * 4 + i];
#pragma unroll
      for (int j = 0; j < DJ; ++j) acc[i][j] *= alpha;
    }
#pragma unroll 4
    for (int c = 0; c < kBlockK; ++c) {
      float vv[DJ];
#pragma unroll
      for (int j = 0; j < DJ; ++j) vv[j] = sV[c * D + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float p = sP[(ty * 4 + i) * PP + c];
#pragma unroll
        for (int j = 0; j < DJ; ++j) acc[i][j] = fmaf(p, vv[j], acc[i][j]);
      }
    }
    __syncthreads();
  }

  if (tid < kBlockQ) sRow[tid] = l_run;
  __syncthreads();
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty * 4 + i, t = q0 + r;
    if (t >= a.n_q) continue;
    const float inv = 1.f / sRow[r];
#pragma unroll
    for (int j = 0; j < DJ; ++j)
      o[t * a.o_s[2] + tx + 16 * j] = acc[i][j] * inv;
  }
}

// ---------------------------------------------------------------------------
// bfloat16: tensor cores
// ---------------------------------------------------------------------------
constexpr int kMmaThreads = 128;   // 4 warps
constexpr int kMmaBlockQ = 64;     // 16 query rows per warp
constexpr int kMmaBlockK = 64;     // keys per tile: 8 n-tiles of QK^T

// bf16 row pitch of the Q/K/V tiles: 16 bytes of padding make the fragment
// loads of 8 rows x 4 lanes hit 32 distinct banks (for every width used)
template <int D>
__host__ __device__ constexpr int mma_pitch() {
  return D + 8;
}

// sQ, then two stages of (sK, sV), then the f32 bias rows (runtime size)
template <int D>
constexpr size_t mma_tile_bytes() {
  return sizeof(__nv_bfloat16) * (size_t)mma_pitch<D>() *
         (kMmaBlockQ + 4 * kMmaBlockK);
}

inline size_t mma_bias_bytes(int gh, int gw) {
  return sizeof(float) * (size_t)kMmaBlockQ * (gh + 1 + gw + 1);
}

// Rows q0 .. q0 + kMmaBlockQ - 1 of a bias table into dst[r·pitch + c] as
// f32·log2e, zeros past n_q.  Token t's row lies at t·col_s where the tokens
// are evenly spaced (row_s == gw·col_s: window and head-last tables), else at
// table_row(row_s, col_s, gw, t) (the global entries' tables as the einsum
// leaves them).  Both loops give the same values; the first keeps the
// division per element out, which cost K6 7% on the card (PERF.md).
template <typename T>
__device__ __forceinline__ void stage_bias(float* dst, int pitch,
                                           const T* src, long long row_s,
                                           long long col_s, int gw,
                                           int width, int q0, int n_q) {
  if (row_s == (long long)gw * col_s) {
    for (int i = threadIdx.x; i < kMmaBlockQ * width; i += kMmaThreads) {
      const int r = i / width, c = i % width, tok = q0 + r;
      dst[r * pitch + c] =
          tok < n_q ? to_f32(src[tok * col_s + c]) * kLog2e : 0.f;
    }
    return;
  }
  for (int i = threadIdx.x; i < kMmaBlockQ * width; i += kMmaThreads) {
    const int r = i / width, c = i % width, tok = q0 + r;
    dst[r * pitch + c] =
        tok < n_q ? to_f32(src[table_row(row_s, col_s, gw, tok) + c]) * kLog2e
                  : 0.f;
  }
}

// ROW_TILE: gw == kMmaBlockK (the 64x64 grid of the 1024^2 canvas): a key
// tile is one grid row, so kh is the tile index and kw the column in the
// tile; each lane's rw values are the same in every tile and stay in
// registers.  Otherwise rh and rw are gathered per score from shared memory.
template <int D, bool BIAS, bool ROW_TILE>
__global__ void __launch_bounds__(kMmaThreads)
    attention_mma_kernel(const AttnArgs a) {
  static_assert(D % 16 == 0, "the head dim must be a multiple of 16");
  static_assert(BIAS || !ROW_TILE, "the row tile needs the bias");
  using T = __nv_bfloat16;
  constexpr int LD = mma_pitch<D>();   // row pitch of sQ, sK and sV
  constexpr int CH = D / 8;        // 16-byte chunks per q/k/v row
  constexpr int KD = D / 16;       // k-steps of QK^T
  constexpr int ND = D / 8;        // n-tiles of the output
  constexpr int NT = kMmaBlockK / 8;   // n-tiles of the scores
  constexpr int STAGE = kMmaBlockK * 2 * LD;   // one (sK, sV) stage
  extern __shared__ __align__(16) unsigned char mma_smem[];
  T* sQ = reinterpret_cast<T*>(mma_smem);
  T* sKV = sQ + kMmaBlockQ * LD;    // stage s: K at s·STAGE, V after it
  float* sRH = reinterpret_cast<float*>(sKV + 2 * STAGE);
  const int gh = BIAS ? a.n_k / a.gw : 0;
  const int rhp = gh + 1, rwp = a.gw + 1;   // odd pitches: fewer conflicts
  float* sRW = sRH + kMmaBlockQ * rhp;

  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t4 = lane % 4;   // fragment row, column pair
  const int bh = blockIdx.x / a.n_qblocks;
  const int outer = bh / a.heads;
  const int head = bh % a.heads;
  const int q0 = (blockIdx.x % a.n_qblocks) * kMmaBlockQ;

  const T* q = static_cast<const T*>(a.q) + offset(a.q_s, outer, head);
  const T* k = static_cast<const T*>(a.k) + offset(a.k_s, outer, head);
  const T* v = static_cast<const T*>(a.v) + offset(a.v_s, outer, head);
  T* o = static_cast<T*>(a.o) + offset(a.o_s, outer, head);

  // Q and the first K/V tile: one cp.async group.  Chunks past the rows
  // are zero-filled and read nothing.
  for (int i = tid; i < kMmaBlockQ * CH; i += kMmaThreads) {
    const int r = i / CH, c = (i % CH) * 8, tok = q0 + r;
    const bool ok = tok < a.n_q;
    cp_async_16(sQ + r * LD + c, q + (ok ? tok * a.q_s[2] + c : 0), ok);
  }
  auto load_kv = [&](int stage, int k0) {
    T* sK = sKV + stage * STAGE;
    T* sV = sK + kMmaBlockK * LD;
    // one pass issues a K chunk and the V chunk beside it
    for (int i = tid; i < kMmaBlockK * CH; i += kMmaThreads) {
      const int r = i / CH, c = (i % CH) * 8, tok = k0 + r;
      const bool ok = tok < a.n_k;
      const long long tk = ok ? tok : 0;
      cp_async_16(sK + r * LD + c, k + tk * a.k_s[2] + c, ok);
      cp_async_16(sV + r * LD + c, v + tk * a.v_s[2] + c, ok);
    }
  };
  load_kv(0, 0);
  cp_async_commit();

  // the block's bias rows, f32, in the exp2 domain
  if (BIAS) {
    stage_bias(sRH, rhp, static_cast<const T*>(a.rh) +
                             offset(a.rh_s, outer, head),
               a.rh_row, a.rh_s[2], a.gw, gh, q0, a.n_q);
    stage_bias(sRW, rwp, static_cast<const T*>(a.rw) +
                             offset(a.rw_s, outer, head),
               a.rw_row, a.rw_s[2], a.gw, a.gw, q0, a.n_q);
  }

  const int row0 = warp * 16 + g;          // this lane's rows: row0, row0 + 8
  const float scale2 = a.scale * kLog2e;
  const float inv_gw = 1.f / (float)a.gw;
  uint32_t qf[KD][4];
  float rw_reg[2][NT][2];   // ROW_TILE: rw of this lane's rows and keys
  float acc[ND][4];
#pragma unroll
  for (int j = 0; j < ND; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
  float m_run[2] = {-INFINITY, -INFINITY};
  float l_run[2] = {0.f, 0.f};   // this lane's part of the row sums

  const int n_tiles = (a.n_k + kMmaBlockK - 1) / kMmaBlockK;
  for (int it = 0; it < n_tiles; ++it) {
    const int stage = it & 1;
    if (it + 1 < n_tiles) {
      load_kv(stage ^ 1, (it + 1) * kMmaBlockK);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    if (it == 0) {
#pragma unroll
      for (int kk = 0; kk < KD; ++kk) {
        const T* p = sQ + row0 * LD + kk * 16 + 2 * t4;
        qf[kk][0] = *reinterpret_cast<const uint32_t*>(p);
        qf[kk][1] = *reinterpret_cast<const uint32_t*>(p + 8 * LD);
        qf[kk][2] = *reinterpret_cast<const uint32_t*>(p + 8);
        qf[kk][3] = *reinterpret_cast<const uint32_t*>(p + 8 * LD + 8);
      }
      if (ROW_TILE) {
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
          for (int n = 0; n < NT; ++n)
#pragma unroll
            for (int j = 0; j < 2; ++j)
              rw_reg[h][n][j] = sRW[(row0 + 8 * h) * rwp + n * 8 + 2 * t4 + j];
      }
    }
    const T* sK = sKV + stage * STAGE;
    const T* sV = sK + kMmaBlockK * LD;

    // scores S = Q K^T: 16 rows x 64 keys per warp; one ldmatrix gives the
    // K fragments of n-tiles n, n+1 at one k-step
    float s[NT][4];
#pragma unroll
    for (int n = 0; n < NT; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
#pragma unroll
    for (int n = 0; n < NT; n += 2) {
      const T* krow = sK + (n * 8 + (lane / 16) * 8 + lane % 8) * LD +
                      ((lane / 8) % 2) * 8;
#pragma unroll
      for (int kk = 0; kk < KD; ++kk) {
        uint32_t b[4];
        ldmatrix_x4(b, krow + kk * 16);
        mma_bf16_16816(s[n], qf[kk], b[0], b[1]);
        mma_bf16_16816(s[n + 1], qf[kk], b[2], b[3]);
      }
    }

    // scale, bias and mask, in the exp2 domain
    const int k0 = it * kMmaBlockK;
    float rh_tile[2] = {0.f, 0.f};
    if (ROW_TILE) {
      rh_tile[0] = sRH[row0 * rhp + it];
      rh_tile[1] = sRH[(row0 + 8) * rhp + it];
    }
#pragma unroll
    for (int n = 0; n < NT; ++n) {
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int key = k0 + n * 8 + 2 * t4 + j;
        if (key >= a.n_k) {
          s[n][j] = s[n][2 + j] = -INFINITY;
          continue;
        }
        float b_lo = 0.f, b_hi = 0.f;
        if (ROW_TILE) {
          b_lo = rh_tile[0] + rw_reg[0][n][j];
          b_hi = rh_tile[1] + rw_reg[1][n][j];
        } else if (BIAS) {
          // exact for key < 2^22: (key + 0.5) / gw is >= 0.5 / gw from an
          // integer
          const int kh = (int)(((float)key + 0.5f) * inv_gw);
          const int kw = key - kh * a.gw;
          b_lo = sRH[row0 * rhp + kh] + sRW[row0 * rwp + kw];
          b_hi = sRH[(row0 + 8) * rhp + kh] + sRW[(row0 + 8) * rwp + kw];
        }
        s[n][j] = fmaf(s[n][j], scale2, b_lo);
        s[n][2 + j] = fmaf(s[n][2 + j], scale2, b_hi);
      }
    }

    // online softmax; h = 0 is row0, h = 1 is row0 + 8.  Every tile holds a
    // valid key, so the new max is finite and exp2(-inf - max) == 0 masks.
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float mx = m_run[h];
#pragma unroll
      for (int n = 0; n < NT; ++n)
        mx = fmaxf(mx, fmaxf(s[n][2 * h], s[n][2 * h + 1]));
      mx = fmaxf(mx, shfl_xor(mx, 1));
      mx = fmaxf(mx, shfl_xor(mx, 2));
      const float alpha = exp2f(m_run[h] - mx);
      m_run[h] = mx;
      float sum = 0.f;
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        s[n][2 * h] = exp2f(s[n][2 * h] - mx);
        s[n][2 * h + 1] = exp2f(s[n][2 * h + 1] - mx);
        sum += s[n][2 * h] + s[n][2 * h + 1];
      }
      l_run[h] = l_run[h] * alpha + sum;
#pragma unroll
      for (int j = 0; j < ND; ++j) {
        acc[j][2 * h] *= alpha;
        acc[j][2 * h + 1] *= alpha;
      }
    }

    // O += P V: the score fragments of n-tiles 2c, 2c+1 are the A fragment
    // of k-step c
#pragma unroll
    for (int c = 0; c < NT / 2; ++c) {
      const uint32_t pa[4] = {pack_bf16x2(s[2 * c][0], s[2 * c][1]),
                              pack_bf16x2(s[2 * c][2], s[2 * c][3]),
                              pack_bf16x2(s[2 * c + 1][0], s[2 * c + 1][1]),
                              pack_bf16x2(s[2 * c + 1][2], s[2 * c + 1][3])};
      // one transposed ldmatrix gives the V fragments of n-tiles j, j+1
      const T* vrow = sV + (c * 16 + ((lane / 8) % 2) * 8 + lane % 8) * LD +
                      (lane / 16) * 8;
#pragma unroll
      for (int j = 0; j < ND; j += 2) {
        uint32_t b[4];
        ldmatrix_x4_trans(b, vrow + j * 8);
        mma_bf16_16816(acc[j], pa, b[0], b[1]);
        mma_bf16_16816(acc[j + 1], pa, b[2], b[3]);
      }
    }
    __syncthreads();   // this stage is refilled by the next iteration
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float l = l_run[h];
    l += shfl_xor(l, 1);
    l += shfl_xor(l, 2);
    const float inv = 1.f / l;
    const int tok = q0 + row0 + 8 * h;
    if (tok >= a.n_q) continue;
    T* orow = o + tok * a.o_s[2] + 2 * t4;
#pragma unroll
    for (int j = 0; j < ND; ++j)
      *reinterpret_cast<uint32_t*>(orow + j * 8) =
          pack_bf16x2(acc[j][2 * h] * inv, acc[j][2 * h + 1] * inv);
  }
}

// ---------------------------------------------------------------------------
// host-side dispatch
// ---------------------------------------------------------------------------
template <typename K>
cudaError_t launch_kernel(K kernel, const AttnArgs& a, int blocks,
                          int threads, size_t smem, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  void* params[] = {const_cast<AttnArgs*>(&a)};
  err = cudaLaunchKernel(kernel, dim3(blocks), dim3(threads), params, smem,
                         stream);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

template <int D, bool BIAS>
cudaError_t launch_d(AttnArgs a, int batch, int dtype, cudaStream_t stream) {
  if (dtype == 0) {
    a.n_qblocks = (a.n_q + kBlockQ - 1) / kBlockQ;
    return launch_kernel(attention_f32_kernel<D, BIAS>, a,
                         batch * a.n_qblocks, kThreads, f32_smem_bytes<D>(),
                         stream);
  }
  a.n_qblocks = (a.n_q + kMmaBlockQ - 1) / kMmaBlockQ;
  const int blocks = batch * a.n_qblocks;
  if constexpr (!BIAS) {
    return launch_kernel(attention_mma_kernel<D, false, false>, a, blocks,
                         kMmaThreads, mma_tile_bytes<D>(), stream);
  } else {
    const size_t smem =
        mma_tile_bytes<D>() + mma_bias_bytes(a.n_k / a.gw, a.gw);
    if (a.gw == kMmaBlockK)
      return launch_kernel(attention_mma_kernel<D, true, true>, a, blocks,
                           kMmaThreads, smem, stream);
    return launch_kernel(attention_mma_kernel<D, true, false>, a, blocks,
                         kMmaThreads, smem, stream);
  }
}

inline bool bad_shape(const AttnArgs& a, int batch, int dtype, bool bias) {
  return batch <= 0 || a.n_q <= 0 || a.n_k <= 0 ||
         (dtype != 0 && dtype != 1) ||
         (bias && (a.gw <= 0 || a.n_k % a.gw != 0));
}

// K1-K9 at head dim head_dim; BIAS adds rh and rw.  dtype: 0 = float32,
// 1 = bfloat16.  Returns a cudaError_t as int; an unsupported head
// dim or dtype is cudaErrorInvalidValue (the Python wrappers reject those
// before calling).  The bf16 kernel reads 16-byte chunks: the wrappers also
// check that pointers and strides allow that.
template <bool BIAS>
int launch(AttnArgs a, int batch, int head_dim, int dtype, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bad_shape(a, batch, dtype, BIAS)) return (int)cudaErrorInvalidValue;
  switch (head_dim) {
    case 16: return (int)launch_d<16, BIAS>(a, batch, dtype, st);
    case 32: return (int)launch_d<32, BIAS>(a, batch, dtype, st);
    case 64: return (int)launch_d<64, BIAS>(a, batch, dtype, st);
    case 80: return (int)launch_d<80, BIAS>(a, batch, dtype, st);
    case 128: return (int)launch_d<128, BIAS>(a, batch, dtype, st);
  }
  return (int)cudaErrorInvalidValue;
}

inline void copy_strides(long long* dst, const long long* src) {
  dst[0] = src[0];
  dst[1] = src[1];
  dst[2] = src[2];
}

// The arguments of the SAM entries (K2-K9): tensors q, k, v, rh, rw, o with
// their {outer, head, token} strides in that order in `strides` (18
// values).  The tables' tokens are
// evenly spaced; global_entry (global_attention.cuh) resets the grid-row
// strides for tables at {head, grid row, grid column}.
inline AttnArgs sam_args(const void* q, const void* k, const void* v,
                         const void* rh, const void* rw, void* o, int tokens,
                         int heads, int gw, float scale,
                         const long long* strides) {
  AttnArgs a = {};
  a.q = q;
  a.k = k;
  a.v = v;
  a.o = o;
  a.rh = rh;
  a.rw = rw;
  a.n_q = tokens;
  a.n_k = tokens;
  a.heads = heads;
  a.gw = gw;
  a.scale = scale;
  copy_strides(a.q_s, strides + 0);
  copy_strides(a.k_s, strides + 3);
  copy_strides(a.v_s, strides + 6);
  copy_strides(a.rh_s, strides + 9);
  copy_strides(a.rw_s, strides + 12);
  copy_strides(a.o_s, strides + 15);
  a.rh_row = (long long)gw * a.rh_s[2];
  a.rw_row = (long long)gw * a.rw_s[2];
  return a;
}

}  // namespace lameness
