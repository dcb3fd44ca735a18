// CPU stand-in for the subset of the CUDA runtime that the port's kernels use,
// so tests can run the kernels' index, tiling and masking logic on a machine
// without a GPU (tests/test_torch_cuda_emulation.py). Every CUDA thread is a
// std::thread, __syncthreads is a barrier, blocks run one after another,
// __shared__ memory is static storage and dynamic shared memory one buffer.
// It says nothing about speed, occupancy or the real hardware's limits.
#pragma once
#include <barrier>
#include <cmath>
#include <cstdint>
#include <functional>
#include <thread>
#include <vector>
#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __launch_bounds__(x)
#define __restrict__
#define __shared__ static
#define __align__(n) __attribute__((aligned(n)))
struct dim3 { unsigned x, y, z; dim3(unsigned a = 1, unsigned b = 1, unsigned c = 1) : x(a), y(b), z(c) {} };
typedef void* cudaStream_t;
enum cudaError_t { cudaSuccess = 0, cudaErrorInvalidValue = 1 };
enum cudaFuncAttribute { cudaFuncAttributeMaxDynamicSharedMemorySize = 8 };
template <class F> cudaError_t cudaFuncSetAttribute(F, cudaFuncAttribute, int) { return cudaSuccess; }
alignas(128) inline unsigned char g_dyn_smem[256 * 1024];
inline cudaError_t cudaGetLastError() { return cudaSuccess; }
struct Idx { unsigned x, y, z; };
inline thread_local Idx threadIdx, blockIdx, gridDim;
inline std::barrier<>* g_bar = nullptr;
inline float g_xchg[1024];
inline void __syncthreads() { g_bar->arrive_and_wait(); }
inline float __shfl_xor_sync(unsigned, float v, int m) {
  g_bar->arrive_and_wait();
  g_xchg[threadIdx.x] = v;
  g_bar->arrive_and_wait();
  float r = g_xchg[threadIdx.x ^ m];
  g_bar->arrive_and_wait();
  return r;
}
template <typename K, typename... A>
void emu_launch(dim3 grid, unsigned nthreads, int, cudaStream_t, K kernel, A... args) {
  for (unsigned by = 0; by < grid.y; ++by)
    for (unsigned bx = 0; bx < grid.x; ++bx) {
      std::barrier<> bar(nthreads);
      g_bar = &bar;
      std::vector<std::thread> ts;
      for (unsigned t = 0; t < nthreads; ++t)
        ts.emplace_back([=] {
          threadIdx = {t, 0, 0};
          blockIdx = {bx, by, 0};
          gridDim = {grid.x, grid.y, grid.z};
          kernel(args...);
        });
      for (auto& th : ts) th.join();
    }
}
