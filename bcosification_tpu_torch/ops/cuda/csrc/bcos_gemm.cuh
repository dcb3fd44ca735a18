// The plain fp32 B-cos GEMM tile loop of K1's fp32 route. (K1's bf16 route
// runs on the TMA + wgmma engine of bcos_engine.cuh; K2 and K3 take fp32 on
// the 3xTF32 route of bcos_tf32.cuh.) K1 runs fp32 in text localisation and
// in the fp32 GPU-vs-CPU checks of whole nets; this loop is the next fp32
// route to move to the tensor cores (ROADMAP B): it runs on the CUDA cores
// at ~10 TFLOP/s, bound by its synchronous loads and shared-memory reads,
// against 67 TFLOP/s fp32 and 495 tf32.
//
// The GEMM's operands are both contiguous along the contraction axis: x
// [M, K] row-major and wt [N, K] row-major (a 1x1 conv's OIHW weight viewed
// as [Cout, Cin]). A block of 256 threads owns a 64x64 tile of u = x @
// wt^T, walks K in steps of 32 through shared memory, and sums each row's
// sum of squares in f32 from the same x tiles it feeds the product with, so
// the patch norm costs no extra read of x.
//
// The tile product is plain FMA on the CUDA cores, a 4x4 micro-tile per
// thread; the accumulator goes to a float tile in shared memory, from which
// the fused epilogue reads.
#pragma once

#include <cuda_runtime.h>

namespace bcos {

constexpr int kThreads = 256;
constexpr int BM = 64;        // rows of x (pixels) per block
constexpr int BN = 64;        // output channels per block / per u chunk
constexpr int BK = 32;        // contraction step
constexpr int LDK = BK + 8;   // smem leading dim of the K-major tiles
constexpr int LDC = BN + 4;   // smem leading dim of the float accumulator tile

// dst[r][c] = src[(row0 + r) * ld + k0 + c] for a [64 x 32] tile, zero outside
// [rows) x [K). Consecutive threads read consecutive k: coalesced.
__device__ __forceinline__ void load_k_tile(float* dst, const float* __restrict__ src, int rows,
                                            int row0, int ld, int k0, int K) {
#pragma unroll
  for (int i = 0; i < (BM * BK) / kThreads; ++i) {
    const int idx = threadIdx.x + i * kThreads;
    const int r = idx / BK;
    const int c = idx % BK;
    const int gr = row0 + r;
    const int gk = k0 + c;
    float v = 0.f;
    if (gr < rows && gk < K) v = src[(long long)gr * ld + gk];
    dst[r * LDK + c] = v;
  }
}

// Partial row sum of squares of an x tile: thread t covers row t/4, columns
// (t%4)*8 .. +8. Summed over the K loop, then reduced by row_ssq_reduce.
__device__ __forceinline__ float tile_ssq(const float* As) {
  const int r = threadIdx.x / 4;
  const int c0 = (threadIdx.x % 4) * 8;
  float s = 0.f;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const float v = As[r * LDK + c0 + j];
    s += v * v;
  }
  return s;
}

// The four partials of a row sit in four neighbouring lanes of one warp.
__device__ __forceinline__ void row_ssq_reduce(float part, float* ssq_s) {
  part += __shfl_xor_sync(0xffffffffu, part, 1);
  part += __shfl_xor_sync(0xffffffffu, part, 2);
  if ((threadIdx.x % 4) == 0) ssq_s[threadIdx.x / 4] = part;
}

// A 64x64 f32 accumulator spread over the block.
struct BlockMma {
  float c[4][4];

  __device__ __forceinline__ void zero() {
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) c[i][j] = 0.f;
  }
  // C += A[64 x K] * B[64 x K]^T, both [row][k] in smem with leading dim ld.
  __device__ __forceinline__ void nt(const float* A, const float* B, int ld, int K) {
    const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
    for (int k = 0; k < K; ++k) {
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = A[(ty * 4 + i) * ld + k];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = B[(tx + 16 * j) * ld + k];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) c[i][j] = fmaf(a[i], b[j], c[i][j]);
    }
  }
  __device__ __forceinline__ void store(float* C, int ldc) const {
    const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) C[(ty * 4 + i) * ldc + tx + 16 * j] = c[i][j];
  }
};

// u tile [64 x 64] = x[row0:+64, :] @ wt[col0:+64, :]^T, left in acc; the
// rows' sums of squares of x go to ssq_s when want_ssq. As and Bs are two
// [64 x LDK] tiles of shared memory. Ends with a __syncthreads, after which
// As and Bs may be reused.
__device__ __forceinline__ void gemm_nt_tile(BlockMma& acc, float* As, float* Bs, float* ssq_s,
                                             bool want_ssq, const float* __restrict__ x,
                                             const float* __restrict__ wt, int M, int K, int N,
                                             int row0, int col0) {
  acc.zero();
  float part = 0.f;
  for (int k0 = 0; k0 < K; k0 += BK) {
    load_k_tile(As, x, M, row0, K, k0, K);
    load_k_tile(Bs, wt, N, col0, K, k0, K);
    __syncthreads();
    if (want_ssq) part += tile_ssq(As);
    acc.nt(As, Bs, LDK, BK);
    __syncthreads();
  }
  if (want_ssq) row_ssq_reduce(part, ssq_s);
}

}  // namespace bcos
