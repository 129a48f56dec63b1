// Host emulation of the CUDA runtime features the port's kernels use, for
// scripts/emulate_cuda_kernels.py: a block runs as blockDim.x std::threads,
// __syncthreads() is a barrier of the block and each warp has a barrier of
// its own for the warp-level primitives (mma.cuh in this directory).
// Blocks run one after another; dynamic shared memory is one static array.
#pragma once
#include <barrier>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <memory>
#include <thread>
#include <type_traits>
#include <vector>

#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __shared__
#define __align__(n) __attribute__((aligned(n)))
#define __launch_bounds__(...)

struct dim3 {
  unsigned x, y, z;
  dim3(unsigned a = 1, unsigned b = 1, unsigned c = 1) : x(a), y(b), z(c) {}
};
typedef void* cudaStream_t;
enum cudaError_t { cudaSuccess = 0, cudaErrorInvalidValue = 1 };
enum cudaFuncAttribute {
  cudaFuncAttributeMaxDynamicSharedMemorySize = 8,
  cudaFuncAttributePreferredSharedMemoryCarveout = 9
};

inline thread_local dim3 threadIdx, blockIdx;
inline std::barrier<>* emu_block_barrier = nullptr;
inline std::vector<std::unique_ptr<std::barrier<>>> emu_warp_barriers;
// per warp and lane: registers handed to the other lanes of the warp
inline uint32_t emu_lane_regs[32][32][8];
inline const void* emu_lane_ptrs[32][32];
inline float emu_lane_floats[32][32];

inline void __syncthreads() { emu_block_barrier->arrive_and_wait(); }
inline void emu_warp_sync() {
  emu_warp_barriers[threadIdx.x / 32]->arrive_and_wait();
}
inline void __syncwarp(unsigned = 0xffffffffu) { emu_warp_sync(); }

template <class F>
cudaError_t cudaFuncSetAttribute(F, cudaFuncAttribute, int) {
  return cudaSuccess;
}
inline cudaError_t cudaGetLastError() { return cudaSuccess; }

constexpr size_t kEmuSharedBytes = 232448;   // an H100 block's maximum

template <class A>
cudaError_t cudaLaunchKernel(void (*func)(A), dim3 grid, dim3 block,
                             void** args, size_t smem, cudaStream_t) {
  using V = std::remove_cv_t<std::remove_reference_t<A>>;
  const V arg = *static_cast<V*>(args[0]);
  if (smem > kEmuSharedBytes || block.x % 32 || block.x > 1024)
    return cudaErrorInvalidValue;
  for (unsigned gy = 0; gy < grid.y; ++gy)
    for (unsigned gx = 0; gx < grid.x; ++gx) {
      std::barrier<> bar(block.x);
      emu_block_barrier = &bar;
      emu_warp_barriers.clear();
      for (unsigned w = 0; w < block.x / 32; ++w)
        emu_warp_barriers.emplace_back(new std::barrier<>(32));
      std::vector<std::thread> threads;
      for (unsigned t = 0; t < block.x; ++t)
        threads.emplace_back([&, t] {
          threadIdx = dim3(t);
          blockIdx = dim3(gx, gy);
          func(arg);
        });
      for (auto& th : threads) th.join();
    }
  return cudaSuccess;
}
