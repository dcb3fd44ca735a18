// K4: the streaming add, out = a + b [+ c [+ d]] on contiguous bf16.
//
// Replaces scripts/perf_probe9.py::make.<locals>.kernel (launched by its
// pl.pallas_call): a 3-read/1-write elementwise pass over [401408, 256]
// bf16 -- the layer1 activation at batch 128 -- that measures the streaming
// rate the device memory gives a hand-written kernel.
//
// What bounds it on the H100: bytes. It does one add per element read, far
// below the card's ~295 operations per byte, so its least time is
// (nin + 1) * numel * 2 bytes over the memory rate. The design only has to
// keep enough loads in flight: every thread moves 16 bytes (8 bf16) per
// input and step, neighbouring threads on neighbouring addresses, and one
// resident wave of blocks (8 per SM) walks the array in a grid-stride
// loop. Elements past the last whole 16-byte group (or every element, when
// an operand is not 16-byte aligned) go through a scalar tail loop.
//
// Rounding: each add is done in f32 and rounded to bf16 before the next,
// so the result equals PyTorch's ((a + b) + c) in bf16 bit for bit.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#ifndef STREAM_ADD_MAX_BLOCKS
#define STREAM_ADD_MAX_BLOCKS (132 * 8)  // one resident wave of 256-thread blocks
#endif

namespace {

constexpr int kThreads = 256;
constexpr int kVec = 8;  // bf16 per 16-byte access

struct __align__(16) Pack {
  __nv_bfloat16 h[kVec];
};

struct Inputs {
  const __nv_bfloat16* p[4];
};

__device__ __forceinline__ __nv_bfloat16 add_bf16(__nv_bfloat16 acc, __nv_bfloat16 v) {
  return __float2bfloat16(__bfloat162float(acc) + __bfloat162float(v));
}

template <int NIN>
__global__ void __launch_bounds__(kThreads)
    stream_add_kernel(Inputs in, __nv_bfloat16* __restrict__ out, long long n,
                      long long nvec) {
  const long long stride = (long long)gridDim.x * kThreads;
  const long long first = (long long)blockIdx.x * kThreads + threadIdx.x;
  for (long long v = first; v < nvec; v += stride) {
    Pack acc = reinterpret_cast<const Pack*>(in.p[0])[v];
#pragma unroll
    for (int k = 1; k < NIN; ++k) {
      const Pack x = reinterpret_cast<const Pack*>(in.p[k])[v];
#pragma unroll
      for (int j = 0; j < kVec; ++j) acc.h[j] = add_bf16(acc.h[j], x.h[j]);
    }
    reinterpret_cast<Pack*>(out)[v] = acc;
  }
  for (long long i = nvec * kVec + first; i < n; i += stride) {
    __nv_bfloat16 acc = in.p[0][i];
#pragma unroll
    for (int k = 1; k < NIN; ++k) acc = add_bf16(acc, in.p[k][i]);
    out[i] = acc;
  }
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

}  // namespace

// out = sum of the nin (2..4) bf16 arrays a, b, c, d of n elements (unused
// inputs may be null). Returns cudaGetLastError() after the launch.
extern "C" int stream_add(int nin, const void* a, const void* b, const void* c, const void* d,
                          void* out, long long n, void* stream) {
  if (nin < 2 || nin > 4 || n <= 0) return (int)cudaErrorInvalidValue;
  const Inputs in{{static_cast<const __nv_bfloat16*>(a), static_cast<const __nv_bfloat16*>(b),
                   static_cast<const __nv_bfloat16*>(c), static_cast<const __nv_bfloat16*>(d)}};
  bool vec = aligned16(out);
  for (int k = 0; k < nin; ++k) vec = vec && aligned16(in.p[k]);
  const long long nvec = vec ? n / kVec : 0;
  const long long work = nvec > n - nvec * kVec ? nvec : n - nvec * kVec;
  long long blocks = (work + kThreads - 1) / kThreads;
  if (blocks > STREAM_ADD_MAX_BLOCKS) blocks = STREAM_ADD_MAX_BLOCKS;
  const dim3 grid((unsigned)blocks);
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  __nv_bfloat16* o = static_cast<__nv_bfloat16*>(out);
  if (nin == 2) {
    stream_add_kernel<2><<<grid, kThreads, 0, s>>>(in, o, n, nvec);
  } else if (nin == 3) {
    stream_add_kernel<3><<<grid, kThreads, 0, s>>>(in, o, n, nvec);
  } else {
    stream_add_kernel<4><<<grid, kThreads, 0, s>>>(in, o, n, nvec);
  }
  return (int)cudaGetLastError();
}
