// The window routine of K2 and K9 (sam_window_attention.cu, _v5.cu,
// head-last views) and K7 and K8 (sam_window_attention_v1.cu, _v2.cu,
// head-major views): SAM ViTDet windowed attention, per (window, head)
//   softmax(scale·q·kᵀ + rh[t, j / GW] + rw[t, j % GW]) · v,
// in bf16 at head dims 64 (ViT-B, ViT-L) and 80 (ViT-H), for windows of at
// most 256 tokens (SAM's 14 x 14 windows: 196).  It computes what the TPU
// kernels _window_kernel_v3 (K2), _window_kernel_v5 (K9), _window_kernel
// (K7) and _window_kernel_v2 (K8) of lameness_tpu/ops/sam_attention.py
// compute; pad tokens of the edge windows take part unmasked, as in ViTDet,
// and keys past N (the padding to 16) are masked to -inf.
//
// What bounds it: per (window, head) at N = 196, q, k, v and the output are
// 196 x hd bf16 each and the tables 196 x 28: ~111 KB (hd 64) or ~136 KB
// (hd 80) against 9.8 or 12.3 MFLOP of products, ~90 FLOP/byte, so it is
// bound by bytes (0.22 ms for ViT-B's 550 x 12 window-heads, 0.36 ms for
// ViT-H's 550 x 16, at 3.35 TB/s).  The design:
//   * one block of 4 warps per (window, head), the window's K and V
//     resident: K and V of N tokens (padded to 16·KT rows) and Q's rows with
//     the window-head's bias columns come into shared memory, every copy
//     issued as cp.async (16-byte chunks for q, k, v; 4-byte words for the
//     tables, whose head-last rows are 28 bytes at a 336-byte token stride),
//     so no load waits on another.  Two blocks per SM: at hd 64 Q is
//     resident too (113 KB at N = 196); at hd 80 that would take 136 KB, one
//     block, so each warp holds only the 16 Q rows of its m-tile and fetches
//     its next m-tile's while it runs the softmax and PV (102 KB);
//   * the bias on the tensor cores, built in shared memory: QKᵀ contracts
//     over hd + 32 columns, [q | rh | rw | 0] against [k | c·spreadᵀ |
//     c·modᵀ | 0], where spreadᵀ[j, c] = (c == j / GW) and modᵀ[j, c] =
//     (c == j % GW) are constants of the window, written into K's columns
//     hd..hd+31 by the block itself (nothing from HBM), and the softmax
//     applies scale.  The bias must enter unscaled, and exactly (the tables
//     are in q's dtype, cast by the wrapper):
//       - hd 64: c = 1/scale = 8, a power of two, so a bf16 value; rh·8 and
//         rw·8 are exact in the f32 accumulator, and times scale give rh +
//         rw;
//       - hd 80: 1/scale = √80 rounds in bf16 to 8.9375 (0.07% off every
//         bias term), so c = 1: the two bias k-steps run first, the f32
//         accumulator (rh + rw) is multiplied once by 1/scale, and the
//         five q·k k-steps add to it.  That adds one f32 rounding.  JAX's own arithmetic (q·scale rounded to bf16, ones,
//         no scale in the softmax) would match the TPU kernel but not the
//         port's plain version, which scales the f32 product;
//   * one-pass softmax: each warp takes 16 query rows against all 16·KT keys
//     at once (the scores in registers), row max, exp2, row sum, no rescale;
//     P packed to bf16 in registers as the A operand of PV; the denominator
//     applied after PV, as every kernel of the port does;
//   * mma.sync m16n8k16 with ldmatrix fragments (mma.cuh), so that the CPU
//     emulation (csrc/emulate/) runs it; Q and K rows at a pitch of hd + 40
//     (104 or 120: 13 or 15 16-byte chunks, odd: ldmatrix conflict-free).
//     V at hd 64: rows unpadded, 16-byte chunk c of row r at c ^ (r % 8); at
//     hd 80 a row has 10 chunks, past what that swizzle keeps in the row, so
//     rows at a pitch of 88 (11 chunks, odd).
// Measured on the H100 (PERF.md, scripts/window_breakdown.py), hd 64: K2
// 0.59 ms, K7 0.49 at ViT-B's shapes; the loads and staging alone take 0.31 /
// 0.25, the products add 0.2 and the softmax 0.07, so the loads are not
// hidden and the products (their ldmatrix traffic and mma.sync issue) are
// the larger half.  A persistent variant, one block of 8 warps per SM with
// a ring of two window-heads, was slower (0.63 / 0.55 ms): the warps of a
// block wait for each other at every window-head.  hd 80, at ViT-H's 550 x
// 16 window-heads: K2 0.81 ms, K7 0.77 (the per-score bias routine of
// attention.cuh took 1.60 on the same inputs; SDPA 1.17 / 1.11); the loads
// and staging alone take 0.45 / 0.42 (2.7 TB/s), the products add 0.33 and
// the softmax 0.12: again the loads and the products add up.
// The entries choose this routine by shape in C (window_entry); float32,
// other head dims and larger windows keep attention.cuh's routine.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "attention.cuh"
#include "mma.cuh"

namespace lameness {

constexpr int kWinThreads = 128;          // 4 warps
constexpr int kWinWarps = kWinThreads / 32;
constexpr int kWinAux = 32;               // bias columns: GH + GW <= 32

// The layout at head dim D (64 or 80).
template <int D>
struct WinLayout {
  static constexpr int QK = D + kWinAux;  // the QKᵀ contraction: 96, 112
  static constexpr int LD = QK + 8;       // Q and K row pitch, bf16
  // hd 64: sQ holds the window, V's chunks are swizzled in unpadded rows,
  // and K's constant columns hold 1/scale; hd 80: sQ holds each warp's 16
  // rows, V's rows are padded, K's constant columns hold 1
  static constexpr bool kHd64 = D == 64;
  static constexpr int VLD = kHd64 ? D : D + 8;   // V row pitch
};

// sQ [Q rows][LD] (the window, or 16 a warp), sK [16·KT][LD], sV
// [16·KT][VLD]
template <int D, int KT>
constexpr size_t window_smem_bytes() {
  using L = WinLayout<D>;
  const size_t rows = 16 * KT, q_rows = L::kHd64 ? rows : 16 * kWinWarps;
  return sizeof(__nv_bfloat16) * ((q_rows + rows) * L::LD + rows * L::VLD);
}

// The row max, exp2 and row sum of one warp's 16 rows against all keys, in
// place: s holds the raw contraction (scale not applied); on return it holds
// exp2(scale·log2e·(s - max)) and l the two rows' sums (rows g and g + 8 of
// the m16n8 fragments).  Keys past n become 0.
template <int NT>
__device__ __forceinline__ void window_softmax(float (&s)[NT][4], int n,
                                               float c2, float (&l)[2]) {
  const int t4 = threadIdx.x % 4;
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
    if (nt * 8 + 8 <= n) continue;
#pragma unroll
    for (int j = 0; j < 2; ++j)
      if (nt * 8 + 2 * t4 + j >= n) s[nt][j] = s[nt][2 + j] = -INFINITY;
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float mx = -INFINITY;
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
      mx = fmaxf(mx, fmaxf(s[nt][2 * h], s[nt][2 * h + 1]));
    mx = fmaxf(mx, shfl_xor(mx, 1));
    mx = fmaxf(mx, shfl_xor(mx, 2));
    const float mc = mx * c2;   // key 0 is valid: mx is finite
    float sum = 0.f;
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      s[nt][2 * h] = exp2f(fmaf(s[nt][2 * h], c2, -mc));
      s[nt][2 * h + 1] = exp2f(fmaf(s[nt][2 * h + 1], c2, -mc));
      sum += s[nt][2 * h] + s[nt][2 * h + 1];
    }
    sum += shfl_xor(sum, 1);
    l[h] = sum + shfl_xor(sum, 2);
  }
}

// rh and rw into columns D.. of `rows` Q rows from token t0 on, at pitch
// LD (rh[t, 0..GH), then rw[t, 0..GW), zeros to column D + 31; rows past
// n zeros), by threads `first`, first + step, ...: 4-byte words where
// every row starts on one (`words`), else element by element
template <int D>
__device__ __forceinline__ void stage_tables(
    __nv_bfloat16* dst, const __nv_bfloat16* rh, const __nv_bfloat16* rw,
    const AttnArgs& a, int t0, int rows, int first, int step, int gh,
    bool words) {
  using T = __nv_bfloat16;
  constexpr int LD = WinLayout<D>::LD;
  const int n = a.n_k, gw = a.gw;
  if (words) {
    for (int i = first; i < rows * kWinAux / 2; i += step) {
      const int r = i / (kWinAux / 2), c = (i % (kWinAux / 2)) * 2;
      const int t = t0 + r;
      const T* src = rh;
      bool ok = false;
      if (t < n && c < gh) {
        src = rh + t * a.rh_s[2] + c;
        ok = true;
      } else if (t < n && c < gh + gw) {
        src = rw + t * a.rw_s[2] + (c - gh);
        ok = true;
      }
      cp_async_4(dst + r * LD + D + c, src, ok);
    }
  } else {
    const T zero = __float2bfloat16(0.f);
    for (int i = first; i < rows * kWinAux; i += step) {
      const int r = i / kWinAux, c = i % kWinAux;
      const int t = t0 + r;
      T val = zero;
      if (t < n && c < gh)
        val = rh[t * a.rh_s[2] + c];
      else if (t < n && c < gh + gw)
        val = rw[t * a.rw_s[2] + (c - gh)];
      dst[r * LD + D + c] = val;
    }
  }
}

// One k-step of S = [q | rh | rw] · [k | c·spreadᵀ | c·modᵀ]ᵀ for 16 rows
// against all keys: one ldmatrix gives the A fragment, another the B
// fragments of n-tiles 2p, 2p + 1
template <int KT, int LD>
__device__ __forceinline__ void window_qk_step(float (&s)[2 * KT][4],
                                               const __nv_bfloat16* qrow,
                                               const __nv_bfloat16* krow,
                                               int kk) {
  uint32_t qa[4];
  ldmatrix_x4(qa, qrow + kk * 16);
#pragma unroll
  for (int p = 0; p < KT; ++p) {
    uint32_t b[4];
    ldmatrix_x4(b, krow + p * 16 * LD + kk * 16);
    mma_bf16_16816(s[2 * p], qa, b[0], b[1]);
    mma_bf16_16816(s[2 * p + 1], qa, b[2], b[3]);
  }
}

// D: the head dim (64 or 80); KT: 16-key tiles of the padded window
// (16·KT >= n).
template <int D, int KT>
__global__ void __launch_bounds__(kWinThreads, 2)
    window_attention_kernel(const AttnArgs a) {
  using T = __nv_bfloat16;
  using L = WinLayout<D>;
  constexpr int LD = L::LD;
  constexpr int VLD = L::VLD;
  constexpr int R = 16 * KT;          // rows and keys, padded
  constexpr int KD = L::QK / 16;      // k-steps of QKᵀ: 6, 7
  constexpr int KQ = D / 16;          // of them over q·k: 4, 5
  constexpr int CH = D / 8;           // 16-byte chunks of a q, k, v row
  constexpr int NT = 2 * KT;          // n-tiles of the scores
  constexpr int ND = D / 8;           // n-tiles of the output
  extern __shared__ __align__(16) unsigned char mma_smem[];
  T* sQ = reinterpret_cast<T*>(mma_smem);
  T* sK = sQ + (L::kHd64 ? R : 16 * kWinWarps) * LD;
  T* sV = sK + R * LD;

  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t4 = lane % 4;
  const int n = a.n_k, gw = a.gw, gh = n / gw;
  const int m_tiles = (n + 15) / 16;
  const int outer = blockIdx.x / a.heads, head = blockIdx.x % a.heads;
  const T* q = static_cast<const T*>(a.q) + offset(a.q_s, outer, head);
  const T* k = static_cast<const T*>(a.k) + offset(a.k_s, outer, head);
  const T* v = static_cast<const T*>(a.v) + offset(a.v_s, outer, head);
  const T* rh = static_cast<const T*>(a.rh) + offset(a.rh_s, outer, head);
  const T* rw = static_cast<const T*>(a.rw) + offset(a.rw_s, outer, head);
  T* o = static_cast<T*>(a.o) + offset(a.o_s, outer, head);
  const bool words =
      ((reinterpret_cast<uintptr_t>(rh) | reinterpret_cast<uintptr_t>(rw)) &
       3) == 0 &&
      ((a.rh_s[2] | a.rw_s[2] | gh | gw) & 1) == 0;

  // hd 80: this warp's Q rows, and the copies of m-tile mt's q rows and
  // table columns into them by the warp's lanes (rows past n zero-filled)
  T* sQw = sQ + warp * 16 * LD;
  auto load_q = [&](int mt) {
    for (int i = lane; i < 16 * CH; i += 32) {
      const int r = i / CH, c = (i % CH) * 8;
      const bool ok = mt * 16 + r < n;
      const long long t = ok ? mt * 16 + r : 0;
      cp_async_16(sQw + r * LD + c, q + t * a.q_s[2] + c, ok);
    }
    stage_tables<D>(sQw, rh, rw, a, mt * 16, 16, lane, 32, gh, words);
  };

  if constexpr (L::kHd64) {
    // q, k, v: 16-byte chunks; rows past n zero-filled (reading nothing)
    for (int i = tid; i < R * 8; i += kWinThreads) {
      const int r = i / 8, c = (i % 8) * 8;
      const bool ok = r < n;
      const long long t = ok ? r : 0;
      cp_async_16(sQ + r * LD + c, q + t * a.q_s[2] + c, ok);
      cp_async_16(sK + r * LD + c, k + t * a.k_s[2] + c, ok);
      cp_async_16(sV + r * D + (c ^ ((r % 8) * 8)), v + t * a.v_s[2] + c,
                  ok);
    }
    stage_tables<D>(sQ, rh, rw, a, 0, R, tid, kWinThreads, gh, words);
  } else {
    // k and v: 16-byte chunks; each warp's first m-tile of q
    for (int i = tid; i < R * CH; i += kWinThreads) {
      const int r = i / CH, c = (i % CH) * 8;
      const bool ok = r < n;
      const long long t = ok ? r : 0;
      cp_async_16(sK + r * LD + c, k + t * a.k_s[2] + c, ok);
      cp_async_16(sV + r * VLD + c, v + t * a.v_s[2] + c, ok);
    }
    if (warp < m_tiles) load_q(warp);
  }
  cp_async_commit();
  // k's columns D..D + 31: `one` at column j / GW and at GH + j % GW of key
  // j (keys past n: zeros), 8 columns a store
  const float inv_scale = 1.f / a.scale;
  const float one = L::kHd64 ? inv_scale : 1.f;
  for (int i = tid; i < R * kWinAux / 8; i += kWinThreads) {
    const int r = i / (kWinAux / 8), c0 = (i % (kWinAux / 8)) * 8;
    const int kh = r / gw, kw = gh + r % gw;
    uint32_t* dst = reinterpret_cast<uint32_t*>(sK + r * LD + D + c0);
#pragma unroll
    for (int e = 0; e < 8; e += 2) {
      const int c = c0 + e;
      const bool lo = r < n && (c == kh || c == kw);
      const bool hi = r < n && (c + 1 == kh || c + 1 == kw);
      dst[e / 2] = pack_bf16x2(lo ? one : 0.f, hi ? one : 0.f);
    }
  }
  cp_async_wait<0>();
  __syncthreads();

  const float c2 = a.scale * kLog2e;
  for (int mt = warp; mt < m_tiles; mt += kWinWarps) {
    // S = [q | rh | rw] · [k | c·spreadᵀ | c·modᵀ]ᵀ: 16 rows x all keys
    float s[NT][4];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
    const T* qrow = (L::kHd64 ? sQ + mt * 16 * LD : sQw) +
                    (lane % 16) * LD + (lane / 16) * 8;
    const T* krow = sK + ((lane / 16) * 8 + lane % 8) * LD +
                    ((lane / 8) % 2) * 8;
    if constexpr (L::kHd64) {
#pragma unroll
      for (int kk = 0; kk < KD; ++kk) window_qk_step<KT, LD>(s, qrow, krow, kk);
    } else {
      // the bias k-steps (rh + rw against ones), times 1/scale, then q·k
#pragma unroll
      for (int kk = KQ; kk < KD; ++kk) window_qk_step<KT, LD>(s, qrow, krow, kk);
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[nt][j] *= inv_scale;
#pragma unroll
      for (int kk = 0; kk < KQ; ++kk) window_qk_step<KT, LD>(s, qrow, krow, kk);
      // every lane has read the warp's Q rows: fetch its next m-tile's
      __syncwarp();
      if (mt + kWinWarps < m_tiles) load_q(mt + kWinWarps);
      cp_async_commit();
    }

    float l[2];
    window_softmax(s, n, c2, l);

    // O = P V: the score fragments of n-tiles 2c, 2c + 1 are the A fragment
    // of k-step c; one transposed ldmatrix gives the V fragments of output
    // n-tiles j, j + 1 (at hd 64 the key's row % 8 is lane % 8)
    float acc[ND][4];
#pragma unroll
    for (int j = 0; j < ND; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
#pragma unroll
    for (int c = 0; c < KT; ++c) {
      const uint32_t pa[4] = {pack_bf16x2(s[2 * c][0], s[2 * c][1]),
                              pack_bf16x2(s[2 * c][2], s[2 * c][3]),
                              pack_bf16x2(s[2 * c + 1][0], s[2 * c + 1][1]),
                              pack_bf16x2(s[2 * c + 1][2], s[2 * c + 1][3])};
      const T* vrow = sV + (c * 16 + ((lane / 8) % 2) * 8 + lane % 8) * VLD;
#pragma unroll
      for (int j = 0; j < ND; j += 2) {
        uint32_t b[4];
        if constexpr (L::kHd64)
          ldmatrix_x4_trans(b, vrow + ((j + lane / 16) ^ (lane % 8)) * 8);
        else
          ldmatrix_x4_trans(b, vrow + (j + lane / 16) * 8);
        mma_bf16_16816(acc[j], pa, b[0], b[1]);
        mma_bf16_16816(acc[j + 1], pa, b[2], b[3]);
      }
    }

#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int tok = mt * 16 + g + 8 * h;
      if (tok >= n) continue;
      const float inv = 1.f / l[h];
      T* orow = o + tok * a.o_s[2] + 2 * t4;
#pragma unroll
      for (int j = 0; j < ND; ++j)
        *reinterpret_cast<uint32_t*>(orow + j * 8) =
            pack_bf16x2(acc[j][2 * h] * inv, acc[j][2 * h + 1] * inv);
    }
    if constexpr (!L::kHd64) {
      cp_async_wait<0>();   // the next m-tile's Q rows
      __syncwarp();
    }
  }
}

// The window routine takes bf16 at head dims 64 and 80, windows of at most
// 256 tokens whose GH + GW bias columns fit in 32.
inline bool window_takes(const AttnArgs& a, int batch, int head_dim,
                         int dtype) {
  return !bad_shape(a, batch, dtype, true) && dtype == 1 &&
         (head_dim == 64 || head_dim == 80) && a.n_q == a.n_k &&
         a.n_k <= 256 && a.n_k / a.gw + a.gw <= kWinAux;
}

template <int D, int KT>
cudaError_t launch_window_kt(const AttnArgs& a, int batch, cudaStream_t st) {
  // the most shared memory the SM offers (2 blocks of 113 KB at hd 64, of
  // 102 KB at hd 80, at N = 196); 100 is cudaSharedmemCarveoutMaxShared
  const cudaError_t err = cudaFuncSetAttribute(
      window_attention_kernel<D, KT>,
      cudaFuncAttributePreferredSharedMemoryCarveout, 100);
  if (err != cudaSuccess) return err;
  return launch_kernel(window_attention_kernel<D, KT>, a, batch, kWinThreads,
                       window_smem_bytes<D, KT>(), st);
}

template <int D>
cudaError_t launch_window_d(const AttnArgs& a, int batch, cudaStream_t st) {
  if (a.n_k <= 64) return launch_window_kt<D, 4>(a, batch, st);
  if (a.n_k <= 128) return launch_window_kt<D, 8>(a, batch, st);
  if (a.n_k <= 208) return launch_window_kt<D, 13>(a, batch, st);
  return launch_window_kt<D, 16>(a, batch, st);
}

// One block per (window, head): batch = windows x heads.  Returns a
// cudaError_t as int.
inline int launch_window(const AttnArgs& a, int batch, int head_dim,
                         void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (head_dim == 80) return (int)launch_window_d<80>(a, batch, st);
  return (int)launch_window_d<64>(a, batch, st);
}

// The one place that chooses the route of the window kernels (K2, K7, K8,
// K9) by shape: this routine where window_takes answers yes, else the
// per-score bias routine of attention.cuh.  batch = windows x heads; dtype
// 0 = float32, 1 = bfloat16.  Returns a cudaError_t as int (a failed launch
// raises in the Python wrapper; nothing falls back).
inline int window_entry(const AttnArgs& a, int batch, int head_dim,
                        int dtype, void* stream) {
  if (window_takes(a, batch, head_dim, dtype))
    return launch_window(a, batch, head_dim, stream);
  return launch<true>(a, batch, head_dim, dtype, stream);
}

}  // namespace lameness
