// CPU stand-in for the subset of the CUDA runtime that the port's kernels use,
// so tests can run the kernels' index, tiling and masking logic on a machine
// without a GPU (tests/test_torch_cuda_emulation.py). Every CUDA thread is a
// std::thread, __syncthreads is a barrier over the block, a warp's shuffle a
// barrier over its 32 threads, a named barrier one over the threads that name
// it; blocks run one after another, __shared__ memory is static storage and
// dynamic shared memory one 1024-byte aligned buffer. It says nothing about
// speed, occupancy or the real hardware's limits.
#pragma once
#include <algorithm>
#include <barrier>
#include <cmath>
#include <condition_variable>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <functional>
#include <memory>
#include <mutex>
#include <thread>
#include <vector>
#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __launch_bounds__(...)
#define __restrict__
#define __grid_constant__
#define __shared__ static
#define __align__(n) __attribute__((aligned(n)))
using std::max;
using std::min;
struct dim3 { unsigned x, y, z; dim3(unsigned a = 1, unsigned b = 1, unsigned c = 1) : x(a), y(b), z(c) {} };
struct uint4 { unsigned x, y, z, w; };
struct float2 { float x, y; };
inline float2 make_float2(float x, float y) { return {x, y}; }
inline float __uint_as_float(unsigned u) { float f; std::memcpy(&f, &u, 4); return f; }
template <class T> inline T __ldg(const T* p) { return *p; }
typedef void* cudaStream_t;
enum cudaError_t { cudaSuccess = 0, cudaErrorInvalidValue = 1 };
enum cudaFuncAttribute { cudaFuncAttributeMaxDynamicSharedMemorySize = 8 };
template <class F> cudaError_t cudaFuncSetAttribute(F, cudaFuncAttribute, int) { return cudaSuccess; }
alignas(1024) inline unsigned char g_dyn_smem[256 * 1024];
inline cudaError_t cudaGetLastError() { return cudaSuccess; }
[[noreturn]] inline void __trap() { std::abort(); }
// two SMs: a persistent grid then has at most two blocks, each walking tiles
enum cudaDeviceAttr { cudaDevAttrMultiProcessorCount = 16 };
inline cudaError_t cudaGetDevice(int* d) { *d = 0; return cudaSuccess; }
inline cudaError_t cudaDeviceGetAttribute(int* v, cudaDeviceAttr, int) { *v = 2; return cudaSuccess; }
template <class F> cudaError_t cudaOccupancyMaxActiveBlocksPerMultiprocessor(int* n, F, int, size_t) { *n = 1; return cudaSuccess; }
struct Idx { unsigned x, y, z; };
inline thread_local Idx threadIdx, blockIdx, gridDim;
inline std::barrier<>* g_bar = nullptr;
inline std::vector<std::unique_ptr<std::barrier<>>> g_warp_bars;
inline std::vector<std::unique_ptr<std::barrier<>>> g_warpgroup_bars;  // 128 threads each
inline void emu_warpgroup_sync() { g_warpgroup_bars[threadIdx.x / 128]->arrive_and_wait(); }
inline float g_xchg[1024];
inline void __syncthreads() { g_bar->arrive_and_wait(); }
inline float __shfl_xor_sync(unsigned, float v, int m) {
  std::barrier<>& warp = *g_warp_bars[threadIdx.x / 32];
  warp.arrive_and_wait();
  g_xchg[threadIdx.x] = v;
  warp.arrive_and_wait();
  float r = g_xchg[threadIdx.x ^ m];
  warp.arrive_and_wait();
  return r;
}
inline int g_xchg_int[1024];
inline int __shfl_sync(unsigned, int v, int src) {
  std::barrier<>& warp = *g_warp_bars[threadIdx.x / 32];
  warp.arrive_and_wait();
  g_xchg_int[threadIdx.x] = v;
  warp.arrive_and_wait();
  int r = g_xchg_int[threadIdx.x / 32 * 32 + src];
  warp.arrive_and_wait();
  return r;
}
// bar.sync id, count: a barrier of `count` threads (generation counted)
struct EmuNamedBarrier {
  std::mutex m;
  std::condition_variable cv;
  int arrived = 0;
  unsigned generation = 0;
};
inline EmuNamedBarrier g_named_bars[16];
inline void emu_named_bar_sync(int id, int count) {
  EmuNamedBarrier& b = g_named_bars[id];
  std::unique_lock<std::mutex> lock(b.m);
  const unsigned gen = b.generation;
  if (++b.arrived == count) {
    b.arrived = 0;
    ++b.generation;
    b.cv.notify_all();
  } else {
    b.cv.wait(lock, [&] { return b.generation != gen; });
  }
}
template <typename K, typename... A>
void emu_launch(dim3 grid, unsigned nthreads, int, cudaStream_t, K kernel, A... args) {
  for (unsigned by = 0; by < grid.y; ++by)
    for (unsigned bx = 0; bx < grid.x; ++bx) {
      std::barrier<> bar(nthreads);
      g_bar = &bar;
      g_warp_bars.clear();
      for (unsigned w = 0; w < (nthreads + 31) / 32; ++w)
        g_warp_bars.push_back(std::make_unique<std::barrier<>>(32));
      g_warpgroup_bars.clear();
      for (unsigned w = 0; w < (nthreads + 127) / 128; ++w)
        g_warpgroup_bars.push_back(
            std::make_unique<std::barrier<>>((std::ptrdiff_t)std::min(128u, nthreads - 128 * w)));
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
