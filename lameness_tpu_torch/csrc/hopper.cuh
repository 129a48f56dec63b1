// Hopper (sm_90a) primitives of the wgmma/TMA attention routines
// (hopper_attention.cuh: K3-K6; dino_attention.cuh: K1): mbarriers, TMA
// tile loads, shared-memory matrix descriptors, the warpgroup fences and
// the products they issue; on the host, the 4-D TMA maps both build.  The
// PTX ISA's names throughout ("Asynchronous Warpgroup Level Matrix
// Multiply-Accumulate", "Tensor Copy", "mbarrier").  Device code only for
// sm_90a; the CPU emulation of the other kernels does not include it.
#pragma once

#include <cuda.h>   // CUtensorMap (a type only: libcuda is not linked)
#include <cuda_runtime.h>
#include <stdint.h>

namespace lameness {
namespace sm90 {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ---------------------------------------------------------------------------
// mbarrier: arrivals and, for TMA, bytes
// ---------------------------------------------------------------------------
__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

// makes the initialised barriers visible to the async proxy (TMA)
__device__ __forceinline__ void fence_barrier_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// one arrival that also expects `bytes` of TMA transactions this phase
__device__ __forceinline__ void mbar_arrive_expect_tx(uint32_t bar,
                                                      uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile(
      "{\n.reg .b64 state;\n"
      "mbarrier.arrive.shared::cta.b64 state, [%0];\n}\n" ::"r"(bar)
      : "memory");
}

// wait until the phase of parity `parity` has completed (a barrier starts in
// phase 0; parity 1 of a fresh barrier counts as completed)
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

// move registers between warpgroups: every thread of the warpgroup runs it,
// and the kernel's paths must not meet again afterwards
template <int R>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(R));
}
template <int R>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(R));
}

// arrive at a named barrier without waiting for it
__device__ __forceinline__ void named_barrier_arrive(int id, int count) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}

// a named barrier over `count` threads (id 0 is __syncthreads')
__device__ __forceinline__ void named_barrier_sync(int id, int count) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}

// 2^x with one MUFU.EX2, subnormal results flushed to zero (exp2f without
// fast-math adds range fix-ups around it); exp2_ftz(-inf) == 0
__device__ __forceinline__ float exp2_ftz(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// ---------------------------------------------------------------------------
// TMA: one box of a 4-D tensor map into shared memory (coordinates c0
// fastest); the copy's bytes complete a transaction count on `bar`.
// Elements past the tensor's extent are filled with zeros and counted all
// the same.
// ---------------------------------------------------------------------------
__device__ __forceinline__ void tma_load_4d(uint32_t dst,
                                            const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1,
                                            int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.tile"
      ".mbarrier::complete_tx::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n"
      :
      : "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0),
        "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// A box from shared memory (laid out as tma_load_4d leaves it) into a 4-D
// tensor map; elements past the tensor's extent are not written.  The copy
// is a bulk group of the issuing thread: bulk_commit, then bulk_wait_read
// before the shared memory is written again or the block ends.
__device__ __forceinline__ void tma_store_4d(const CUtensorMap* map,
                                             uint32_t src, int c0, int c1,
                                             int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.global.shared::cta.bulk_group"
      " [%0, {%2, %3, %4, %5}], [%1];\n"
      :
      : "l"(reinterpret_cast<uint64_t>(map)), "r"(src), "r"(c0), "r"(c1),
        "r"(c2), "r"(c3)
      : "memory");
}
__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}

__device__ __forceinline__ void st_shared_u32(uint32_t addr, uint32_t v) {
  asm volatile("st.shared.u32 [%0], %1;\n" ::"r"(addr), "r"(v) : "memory");
}

// ---------------------------------------------------------------------------
// wgmma
// ---------------------------------------------------------------------------
// Shared-memory matrix descriptor of a tile stored as rows of 128 bytes with
// the 128-byte swizzle (what TMA writes with CU_TENSOR_MAP_SWIZZLE_128B),
// the tile 1024-byte aligned: start address, leading and stride byte
// offsets in 16-byte units, layout type 1 (128B swizzle) in bits 62-63.
// For a K-major operand the stride offset steps 8 rows (1024 bytes) and the
// leading offset is unused; for an MN-major one 64 elements wide (one
// swizzled row) the k-direction step of 8 rows is 1024 bytes as well, so
// both offsets are set to 1024 bytes and either reading of the two fields
// finds it.  A k-step of 16 bf16 inside a K-major row advances the start
// address by 32 bytes (+2); 16 rows of an MN-major tile by 2048 (+128).
__device__ __forceinline__ uint64_t desc_sw128(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(1024 >> 4) << 16) |
         ((uint64_t)(1024 >> 4) << 32) | ((uint64_t)1 << 62);
}

// The same for a tile stored as rows of 32 bytes (16 bf16) with the 32-byte
// swizzle (CU_TENSOR_MAP_SWIZZLE_32B, layout type 3), the tile 256-byte
// aligned: a row is one k-step of a K-major operand, or 16 columns of an
// MN-major one, and 8 rows step 256 bytes in either reading (16 rows of an
// MN-major tile: +32).
__device__ __forceinline__ uint64_t desc_sw32(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(256 >> 4) << 16) |
         ((uint64_t)(256 >> 4) << 32) | ((uint64_t)3 << 62);
}

// Descriptor of a tile without swizzle (core matrices of 8 rows x 16
// bytes), leading and stride byte offsets as given
__device__ __forceinline__ uint64_t desc_plain(uint32_t addr, uint32_t lbo,
                                               uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32);
}

// make generic-proxy stores to shared memory visible to wgmma and TMA
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// order the warpgroup's register and shared-memory accesses before the
// next wgmma (required after registers it reads were written)
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// wait until at most N committed groups are in flight
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// keep the compiler from moving accesses of r across the asynchronous
// product (the hardware writes the accumulators until wgmma_wait)
template <int N>
__device__ __forceinline__ void fence_operands(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int N>
__device__ __forceinline__ void fence_operands(uint32_t (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

// Accumulator layout of m64nN (f32): thread t of the warpgroup, warp
// w = t / 32, lane l: d[4n + i] is row 16w + l/4 + 8·(i/2), column
// 8n + 2·(l%4) + i%2 -- per warp the C fragment of mma.sync m16n8k16.

// d (+)= A·B, a 64x128 tile over k = 16: A (64 x 16) and B (128 x 16) from
// shared memory, both K-major.  accumulate == 0 ignores the old d (the
// first k-step of a tile).
__device__ __forceinline__ void wgmma_m64n128k16_ss(float (&d)[64],
                                                    uint64_t desc_a,
                                                    uint64_t desc_b,
                                                    int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(desc_a), "l"(desc_b), "r"(accumulate));
}

// d (+)= A·B, a 64x16 tile over k = 16: A (64 x 16) and B (16 x 16) from
// shared memory, both K-major, as in wgmma_m64n128k16_ss (the last 16 keys
// of K1's 272)
__device__ __forceinline__ void wgmma_m64n16k16_ss(float (&d)[8],
                                                   uint64_t desc_a,
                                                   uint64_t desc_b,
                                                   int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, %8, %9, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "l"(desc_a), "l"(desc_b), "r"(accumulate));
}

// d += A·B, a 64x64 tile over k = 16: A from registers (per warp the A
// fragment of mma.sync m16n8k16 for its 16 rows: a[0..3]), B (16 x 64) from
// shared memory, MN-major (imm-trans-b = 1).
__device__ __forceinline__ void wgmma_m64n64k16_rs(float (&d)[32],
                                                   const uint32_t (&a)[4],
                                                   uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

// d += A·B, a 64x16 tile over k = 16: A from registers as in
// wgmma_m64n64k16_rs, B (16 x 16) from shared memory, MN-major
__device__ __forceinline__ void wgmma_m64n16k16_rs(float (&d)[8],
                                                   const uint32_t (&a)[4],
                                                   uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, {%8, %9, %10, %11}, %12, p, 1, 1, "
      "1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

// d += A·B, a 64x8 tile over k = 16: A from registers as in
// wgmma_m64n64k16_rs, B (16 x 8) from shared memory, K-major
__device__ __forceinline__ void wgmma_m64n8k16_rs(float (&d)[4],
                                                  const uint32_t (&a)[4],
                                                  uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %9, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n8k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, %8, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

}  // namespace sm90

// ---------------------------------------------------------------------------
// host side: TMA maps of the bf16 routines (hopper_attention.cuh,
// dino_attention.cuh)
// ---------------------------------------------------------------------------
constexpr int kTileWidth = 64;   // bf16 columns of a 128-byte swizzled row

// cuTensorMapEncodeTiled, looked up through the runtime's entry-point
// query (the libraries link no -lcuda)
typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType,
                                  cuuint32_t, void*, const cuuint64_t*,
                                  const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave,
                                  CUtensorMapSwizzle, CUtensorMapL2promotion,
                                  CUtensorMapFloatOOBfill);

inline EncodeTiledFn encode_tiled() {
  static EncodeTiledFn fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiledFn>(p);
  }
  return fn;
}

// Columns col0 .. col0 + width - 1 of an (outer, heads, rows, ·) bf16
// tensor at element strides s = {outer, head, row} as a 4-D map {width,
// rows, heads, outer} with boxes of box_rows rows x width columns of one
// (outer, head) under `swizzle` (a row of the box is 128 bytes under the
// 128-byte swizzle, 32 under the 32-byte one); rows past `rows` read as
// zeros.  With one head the heads axis is never stepped and takes the outer
// stride (its own slot may be 0).  False unless the first column's address
// and the strides are multiples of 16 bytes (what TMA takes).
inline bool tile_map(EncodeTiledFn enc, CUtensorMap* map, const void* ptr,
                     const long long* s, int outer, int heads, int rows,
                     int box_rows, int col0 = 0, int width = kTileWidth,
                     CUtensorMapSwizzle swizzle = CU_TENSOR_MAP_SWIZZLE_128B) {
  const long long el = 2;   // bf16
  const long long head_s = heads == 1 ? s[0] : s[1];
  const char* first = static_cast<const char*>(ptr) + col0 * el;
  if (reinterpret_cast<uintptr_t>(first) % 16 || (s[0] * el) % 16 ||
      (head_s * el) % 16 || (s[2] * el) % 16)
    return false;
  const cuuint64_t dims[4] = {(cuuint64_t)width, (cuuint64_t)rows,
                              (cuuint64_t)heads, (cuuint64_t)outer};
  const cuuint64_t strides[3] = {(cuuint64_t)(s[2] * el),
                                 (cuuint64_t)(head_s * el),
                                 (cuuint64_t)(s[0] * el)};
  const cuuint32_t box[4] = {(cuuint32_t)width, (cuuint32_t)box_rows, 1, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  return enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
             const_cast<char*>(first), dims, strides, box, unit,
             CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
             CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

}  // namespace lameness
