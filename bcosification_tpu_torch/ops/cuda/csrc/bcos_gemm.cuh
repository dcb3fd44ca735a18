// Shared block machinery of the plain B-cos GEMM tile loop: K3 in both
// dtypes and the fp32 paths of K1 and K2. (The bf16 K1 and K2 run on the
// TMA + wgmma engine of bcos_engine.cuh.)
//
// Every kernel here is a GEMM whose operands are both contiguous along the
// contraction axis: x [M, K] row-major and wt [N, K] row-major (a 1x1 conv's
// OIHW weight viewed as [Cout, Cin]). A block of 256 threads owns a 64x64
// tile of u = x @ wt^T, walks K in steps of 32 through shared memory, and
// sums each row's sum of squares in f32 from the same x tiles it feeds the
// product with, so the patch norm costs no extra read of x.
//
// The tile product is the only part that differs by type:
// - bf16 (K3): WMMA 16x16x16 bf16 -> f32 on the tensor cores (mma.sync
//   underneath); each of the 8 warps owns two 16x16 accumulator fragments.
//   Loads go element by element through registers, with no pipelining: K3
//   is one launch per call and waits for the engine (ROADMAP).
// - fp32: plain FMA on the CUDA cores, a 4x4 micro-tile per thread. It exists
//   so the kernels can be held tightly against their plain versions; the
//   model runs in bf16.
// Both write their accumulator to a float tile in shared memory, from which
// the fused epilogues read.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

namespace bcos {

constexpr int kThreads = 256;
constexpr int BM = 64;        // rows of x (pixels) per block
constexpr int BN = 64;        // output channels per block / per u chunk
constexpr int BK = 32;        // contraction step
constexpr int LDK = BK + 8;   // smem leading dim of the K-major tiles (16-byte rows for WMMA)
constexpr int LDC = BN + 4;   // smem leading dim of the float accumulator tile
constexpr int LDG = BN + 8;   // smem leading dim of the [64 x 64] operand tiles of fp32 K2

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

// dst[r][c] = src[(row0 + r) * ld + k0 + c] for a [64 x 32] tile, zero outside
// [rows) x [K). Consecutive threads read consecutive k: coalesced.
template <typename T>
__device__ __forceinline__ void load_k_tile(T* dst, const T* __restrict__ src, int rows,
                                            int row0, int ld, int k0, int K) {
#pragma unroll
  for (int i = 0; i < (BM * BK) / kThreads; ++i) {
    const int idx = threadIdx.x + i * kThreads;
    const int r = idx / BK;
    const int c = idx % BK;
    const int gr = row0 + r;
    const int gk = k0 + c;
    T v = from_f<T>(0.f);
    if (gr < rows && gk < K) v = src[(long long)gr * ld + gk];
    dst[r * LDK + c] = v;
  }
}

// dst[r][c] = src[(row0 + r) * ld + col0 + c] for a [64 x 64] tile, zero
// outside [rows) x [cols).
template <typename T>
__device__ __forceinline__ void load_64x64(T* dst, const T* __restrict__ src, int rows,
                                           int row0, int cols, int col0, int ld) {
#pragma unroll
  for (int i = 0; i < (64 * 64) / kThreads; ++i) {
    const int idx = threadIdx.x + i * kThreads;
    const int r = idx / 64;
    const int c = idx % 64;
    const int gr = row0 + r;
    const int gc = col0 + c;
    T v = from_f<T>(0.f);
    if (gr < rows && gc < cols) v = src[(long long)gr * ld + gc];
    dst[r * LDG + c] = v;
  }
}

// Partial row sum of squares of an x tile: thread t covers row t/4, columns
// (t%4)*8 .. +8. Summed over the K loop, then reduced by row_ssq_reduce.
template <typename T>
__device__ __forceinline__ float tile_ssq(const T* As) {
  const int r = threadIdx.x / 4;
  const int c0 = (threadIdx.x % 4) * 8;
  float s = 0.f;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const float v = to_f(As[r * LDK + c0 + j]);
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
template <typename T> struct BlockMma;

template <> struct BlockMma<float> {
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
  // C += A[64 x K] * B[K x 64]; A [row][k] with lda, B [k][col] with ldb.
  __device__ __forceinline__ void nn(const float* A, int lda, const float* B, int ldb, int K) {
    const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
    for (int k = 0; k < K; ++k) {
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = A[(ty * 4 + i) * lda + k];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = B[k * ldb + tx + 16 * j];
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

template <> struct BlockMma<__nv_bfloat16> {
  using bf16 = __nv_bfloat16;
  // warp w owns rows (w/2)*16 and the column fragments (w%2)*2 + {0, 1}
  nvcuda::wmma::fragment<nvcuda::wmma::accumulator, 16, 16, 16, float> c[2];

  __device__ __forceinline__ int frag_row() const { return (threadIdx.x / 32) / 2; }
  __device__ __forceinline__ int frag_col(int j) const { return ((threadIdx.x / 32) % 2) * 2 + j; }

  __device__ __forceinline__ void zero() {
    nvcuda::wmma::fill_fragment(c[0], 0.f);
    nvcuda::wmma::fill_fragment(c[1], 0.f);
  }
  __device__ __forceinline__ void nt(const bf16* A, const bf16* B, int ld, int K) {
    using namespace nvcuda;
    for (int k = 0; k < K; k += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
      wmma::load_matrix_sync(a, A + frag_row() * 16 * ld + k, ld);
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        // B is [n][k]: as a K x N operand that is column-major
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> b;
        wmma::load_matrix_sync(b, B + frag_col(j) * 16 * ld + k, ld);
        wmma::mma_sync(c[j], a, b, c[j]);
      }
    }
  }
  __device__ __forceinline__ void nn(const bf16* A, int lda, const bf16* B, int ldb, int K) {
    using namespace nvcuda;
    for (int k = 0; k < K; k += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
      wmma::load_matrix_sync(a, A + frag_row() * 16 * lda + k, lda);
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> b;
        wmma::load_matrix_sync(b, B + k * ldb + frag_col(j) * 16, ldb);
        wmma::mma_sync(c[j], a, b, c[j]);
      }
    }
  }
  __device__ __forceinline__ void store(float* C, int ldc) const {
#pragma unroll
    for (int j = 0; j < 2; ++j)
      nvcuda::wmma::store_matrix_sync(C + frag_row() * 16 * ldc + frag_col(j) * 16, c[j], ldc,
                                      nvcuda::wmma::mem_row_major);
  }
};

// u tile [64 x 64] = x[row0:+64, :] @ wt[col0:+64, :]^T, left in acc; the
// rows' sums of squares of x go to ssq_s when want_ssq. As and Bs are two
// [64 x LDK] tiles of shared memory. Ends with a __syncthreads, after which
// As and Bs may be reused.
template <typename T>
__device__ __forceinline__ void gemm_nt_tile(BlockMma<T>& acc, T* As, T* Bs, float* ssq_s,
                                             bool want_ssq, const T* __restrict__ x,
                                             const T* __restrict__ wt, int M, int K, int N,
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
