// The GEMM engine of K1, K2 and K3 on Hopper, built on hopper.cuh: their
// bf16 routes here, and the ring under the fp32 route of K2 and K3
// (bcos_tf32.cuh, 3xTF32, whose stages hold four f32 B boxes: Smem::b_boxes).
//
// A block owns R = 64 or 128 rows (pixels) and has R / 64 consumer
// warpgroups, each of which owns 64 of the rows, and one producer warp, one
// thread of which issues every TMA load. Operand tiles flow through a
// ring of shared-memory stages guarded by two mbarriers each: `full` (the
// producer's arrival with the stage's byte count, completed by TMA) and
// `empty` (one arrival per consumer thread once its wgmmas have read the
// stage). A stage holds a B tile of two 64 x 64 boxes (16 KB) and, where the
// A operand streams, an A tile of R / 64 boxes. The consumers run chains of
// m64n128k16 wgmmas with f32 accumulators in registers, keep one stage's
// wgmmas in flight while the next stage's are issued, and run their
// epilogues straight from the accumulator registers. An output tile (bf16,
// or f32 for K3) goes through a staging buffer in shared memory (the TMA box
// layout) and leaves by TMA stores, so device memory sees whole 128-byte
// lines.
//
// Two kinds of chain, each 128 output columns wide (kChunk):
// - u-chain (K-major B): u[R x 128] = x[R x K] wt[n0 : n0 + 128, :]^T over
//   ceil(K / 64) stages of {x boxes, wt boxes (k, n0) and (k, n0 + 64)};
// - dx-chain (MN-major B): dx[R x 128] = g[R x N] wt[:, k0 : k0 + 128] over
//   ceil(N / 64) stages of {wt boxes (k0, n) and (k0 + 64, n)}, with g's
//   tiles from the ring or resident in shared memory.
// The producer walks the same sequence of stages as the consumers. The grid
// is persistent: as many blocks as the SMs hold at once, each walking output
// tiles blockIdx.x, + gridDim.x, ..., so the producer loads the next tile's
// stages while the consumers run the last one's epilogue. Blocks of 64 rows
// are small enough (160 threads, <= 113 KB) for two to share an SM, so one
// block's epilogue overlaps the other's products. On the H100 the
// epilogues, not the products, bound the trunk's shapes (PERF.md, PR 3), so
// what an epilogue reads per column or per element is loaded under the
// mainloop: per-column vectors into registers, [M, Cout] operands by TMA
// into a staging buffer (op_bar).
#pragma once

#include "hopper.cuh"

namespace engine {

using bf16 = __nv_bfloat16;
using hopper::kBoxBytes;

constexpr int kChunk = 128;                // output columns of one wgmma chain
constexpr int kMaxStages = 6;
constexpr int kSmemLimit = 232448;         // dynamic shared memory of one block (227 KB)
constexpr int kSmemHalf = 115712;          // of each of two blocks on one SM (228 KB, 1 KB each reserved)
constexpr int kMaxThreads = 384;           // launch bound: keeps the compiler at <= 168 registers

// A block of `rows` rows: one consumer warpgroup per 64 rows, then one
// producer warp.
__host__ __device__ constexpr int block_threads(int rows) { return 2 * rows + 32; }

// Shared memory of one block from a 1024-byte aligned base: the stages
// [B tile | A tile of rows * 128 bytes], `outs` output staging buffers (a
// 64 x 128 tile of out_elem-byte elements per consumer warpgroup each:
// out_elem boxes), `extra` bytes (K2's resident g), the rows' sums of
// squares (f32, two buffers: tile i uses buffer i % 2), the barriers.
struct Smem {
  int rows, stages, extra, outs;
  int out_elem = 2;  // bytes per element of the staged outputs: 2 (bf16) or 4 (f32)
  int b_boxes = 2;   // boxes of a stage's B tile: 2, or 4 for the fp32 route's hi and lo
  __host__ __device__ constexpr int b_bytes() const { return b_boxes * kBoxBytes; }
  __host__ __device__ constexpr int stage_bytes() const { return b_bytes() + rows * 128; }
  __host__ __device__ constexpr int out_offset(int buffer = 0) const {
    return stages * stage_bytes() + buffer * rows * kChunk * out_elem;
  }
  __host__ __device__ constexpr int extra_offset() const { return out_offset(outs); }
  __host__ __device__ constexpr int ssq_offset() const { return extra_offset() + extra; }
  __host__ __device__ constexpr int bar_offset() const { return ssq_offset() + 2 * rows * 4; }
  // the ring's full and empty barriers, then one per consumer warpgroup
  // for its own TMA loads (op_bar)
  __host__ __device__ constexpr int bytes() const {
    return bar_offset() + (2 * kMaxStages + 2) * 8;
  }
};

// The most stages (at most kMaxStages) of layout L that fit in `budget`
// bytes; 0 below 2.
constexpr int fit_stages(Smem L, int budget = kSmemLimit) {
  for (L.stages = kMaxStages; L.stages >= 2; --L.stages)
    if (L.bytes() <= budget) return L.stages;
  return 0;
}

// Blocks of a persistent grid over `tiles` output tiles: as many as the SMs
// hold at once (`kernel` with `threads` threads and `smem` bytes), at most
// one per tile.
template <class Kernel>
inline int persistent_blocks(Kernel kernel, int threads, int smem, int tiles) {
  int device = 0, sms = 0, per_sm = 0;
  cudaGetDevice(&device);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, smem);
  const int blocks = (sms > 0 ? sms : 1) * (per_sm > 0 ? per_sm : 1);
  return tiles < blocks ? tiles : blocks;
}

struct Ring {
  unsigned char* base;
  uint64_t* full;
  uint64_t* empty;
  int stages, stage_bytes, b_bytes, stage;
  uint32_t phase;
  __device__ __forceinline__ unsigned char* b(int s) const { return base + s * stage_bytes; }
  __device__ __forceinline__ unsigned char* a(int s) const { return b(s) + b_bytes; }
  __device__ __forceinline__ void advance() {
    if (++stage == stages) {
      stage = 0;
      phase ^= 1;
    }
  }
};

// The warpgroup of this thread, as a value the compiler knows to be the same
// across the warp: a role branch on threadIdx.x itself counts as divergent,
// and ptxas then serialises every wgmma after it (warning C7518).
__device__ __forceinline__ int warpgroup() { return __shfl_sync(0xffffffffu, threadIdx.x / 128, 0); }

// The block's dynamic shared memory, declared __align__(1024) (the 128-byte
// swizzle needs 1024-byte aligned boxes); a base off that grid traps.
__device__ __forceinline__ unsigned char* aligned_base(unsigned char* smem) {
  if (hopper::smem_addr(smem) % 1024 != 0) __trap();
  return smem;
}

// Initialises the ring's barriers (thread 0) and synchronises the block.
__device__ __forceinline__ Ring make_ring(unsigned char* base, const Smem& L) {
  uint64_t* bars = reinterpret_cast<uint64_t*>(base + L.bar_offset());
  Ring ring{base, bars, bars + kMaxStages, L.stages, L.stage_bytes(), L.b_bytes(), 0, 0};
  if (threadIdx.x == 0) {
    for (int s = 0; s < L.stages; ++s) {
      hopper::mbar_init(&ring.full[s], 1);
      hopper::mbar_init(&ring.empty[s], L.rows * 2);  // 128 threads per 64 rows
    }
    for (int w = 0; w < L.rows / 64; ++w) hopper::mbar_init(bars + 2 * kMaxStages + w, 1);
    hopper::fence_barrier_init();
  }
  __syncthreads();
  return ring;
}

// Producer (one thread): the next stage holds the B boxes at (bc0, br0) and
// (bc1, br1) of tb, then a_boxes A boxes of ta at (ac, ar + 64 i).
__device__ __forceinline__ void load_stage(Ring& ring, const CUtensorMap* tb, int bc0, int br0,
                                           int bc1, int br1, const CUtensorMap* ta, int ac,
                                           int ar, int a_boxes) {
  hopper::mbar_wait(&ring.empty[ring.stage], ring.phase ^ 1);
  uint64_t* full = &ring.full[ring.stage];
  hopper::mbar_arrive_expect_tx(full, (2 + a_boxes) * kBoxBytes);
  unsigned char* b = ring.b(ring.stage);
  hopper::tma_load_2d(b, tb, full, bc0, br0);
  hopper::tma_load_2d(b + kBoxBytes, tb, full, bc1, br1);
  for (int i = 0; i < a_boxes; ++i)
    hopper::tma_load_2d(ring.a(ring.stage) + i * kBoxBytes, ta, full, ac, ar + 64 * i);
  ring.advance();
}

// Sum of squares of half a row of a swizzled 64-column A box: thread t of a
// warpgroup takes row t / 2, 16-byte chunks 4 (t % 2) .. + 3. The swizzle
// only permutes the chunks within a row, so the two halves cover the row.
__device__ __forceinline__ float half_row_ssq(const unsigned char* box) {
  const int t = threadIdx.x % 128;
  const uint4* p = reinterpret_cast<const uint4*>(box + (t / 2) * 128 + (t % 2) * 64);
  float s = 0.f;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const uint4 v = p[i];
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float2 f = __bfloat1622float2(h[j]);
      s += f.x * f.x + f.y * f.y;
    }
  }
  return s;
}

// The two halves of each row meet in ssq_s[64 wg + row]; the warpgroup
// then synchronises on its named barrier, after which every thread may read
// its rows' sums. (With two buffers taken in turn, a thread cannot overwrite
// a buffer another thread of its warpgroup still reads: it would first pass
// the next tile's barrier, which waits for that thread.)
__device__ __forceinline__ void publish_row_ssq(float part, float* ssq_s) {
  const int t = threadIdx.x % 128, wg = threadIdx.x / 128;
  part += __shfl_xor_sync(0xffffffffu, part, 1);
  if (t % 2 == 0) ssq_s[64 * wg + t / 2] = part;
  hopper::named_bar_sync(1 + wg, 128);
}

// Consumer warpgroup: acc = one chain over `ktiles` stages of the ring. The
// A tile is the stage's (a_fixed null) or a_fixed + kt * a_step (resident
// g); this warpgroup reads its own 64 rows of it. With ssq, the x tiles'
// half-row sums of squares are added to *ssq.
template <int TransB>
__device__ __forceinline__ void mma_chain(float (&acc)[64], Ring& ring, int ktiles,
                                          const unsigned char* a_fixed, int a_step, float* ssq) {
  const int wg = threadIdx.x / 128;
  int prev = -1;
  for (int kt = 0; kt < ktiles; ++kt) {
    hopper::mbar_wait(&ring.full[ring.stage], ring.phase);
    const unsigned char* a =
        (a_fixed != nullptr ? a_fixed + kt * a_step : ring.a(ring.stage)) + wg * kBoxBytes;
    const unsigned char* b = ring.b(ring.stage);
    if (ssq != nullptr) *ssq += half_row_ssq(a);
    hopper::wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < 4; ++ks) {
      const uint64_t da = hopper::desc_sw128(a + 32 * ks, 16, 1024);
      const uint64_t db = TransB ? hopper::desc_sw128(b + 2048 * ks, kBoxBytes, 1024)
                                 : hopper::desc_sw128(b + 32 * ks, 16, 1024);
      hopper::wgmma_m64n128k16<TransB>(acc, da, db, (kt | ks) != 0);
    }
    hopper::wgmma_commit();
    hopper::wgmma_wait<1>();  // the previous stage's wgmmas are done with it
    if (prev >= 0) hopper::mbar_arrive(&ring.empty[prev]);
    prev = ring.stage;
    ring.advance();
  }
  hopper::wgmma_wait<0>();
#pragma unroll
  for (int i = 0; i < 64; ++i) hopper::fence_operand(acc[i]);
  if (prev >= 0) hopper::mbar_arrive(&ring.empty[prev]);
}

// Byte offset of element (r, c) in a 128-byte-swizzled box or slab of
// elem-byte elements (1024-byte aligned), c < 128 / elem: the 16-byte chunk
// c * elem / 16 of row r moves to chunk (c * elem / 16) ^ (r % 8). Two
// neighbouring columns (c even) stay together.
__device__ __forceinline__ int swizzled(int r, int c, int elem = 2) {
  return r * 128 + ((((c * elem) / 16) ^ (r % 8)) * 16) + (c * elem) % 16;
}

// (v0, v1) in bf16 at row r, columns c, c + 1 of a warpgroup's staged
// 64 x 128 output tile (two boxes).
__device__ __forceinline__ void stage_pair(unsigned char* staging, int r, int c, float v0,
                                           float v1) {
  *reinterpret_cast<__nv_bfloat162*>(staging + (c / 64) * kBoxBytes + swizzled(r, c % 64)) =
      __floats2bfloat162_rn(v0, v1);
}

// (v0, v1) in f32 at row r, columns c, c + 1 of a warpgroup's staged
// 64 x 128 f32 output tile (four boxes of 32 columns).
__device__ __forceinline__ void stage_pair_f32(unsigned char* staging, int r, int c, float v0,
                                               float v1) {
  *reinterpret_cast<float2*>(staging + (c / 32) * kBoxBytes + swizzled(r, c % 32, 4)) =
      make_float2(v0, v1);
}

// The barrier of this warpgroup's own TMA loads (see make_ring).
__device__ __forceinline__ uint64_t* op_bar(unsigned char* base, const Smem& L) {
  return reinterpret_cast<uint64_t*>(base + L.bar_offset()) + 2 * kMaxStages + threadIdx.x / 128;
}

// The pair (r, c), (r, c + 1) of a warpgroup's staged 64 x 128 tile as one
// 32-bit word (column c in the low half): the inverse of stage_pair, for
// operands that TMA loaded into a staging buffer.
__device__ __forceinline__ uint32_t staged_pair(const unsigned char* staging, int r, int c) {
  return *reinterpret_cast<const uint32_t*>(staging + (c / 64) * kBoxBytes + swizzled(r, c % 64));
}

// This warpgroup's staging buffer, from the block's output region of
// elem-byte elements.
__device__ __forceinline__ unsigned char* staging_of(unsigned char* out_region, int elem = 2) {
  return out_region + (threadIdx.x / 128) * elem * kBoxBytes;
}

// Before a warpgroup stages a tile: at most kPending of its TMA stores still
// read staging buffers (with two buffers taken in turn, 1: the store of the
// other buffer). The elected thread waits; the caller's next warpgroup
// barrier passes that on.
template <int kPending = 0>
__device__ __forceinline__ void staging_wait() {
  if (threadIdx.x % 128 == 0) hopper::bulk_wait_read<kPending>();
}

// After every thread of the warpgroup staged its pairs: the tile of
// elem-byte elements leaves for (col + i * 128 / elem, row) of the map, box
// i of the buffer, for the boxes that start before `cols`; TMA clips rows
// and columns beyond the matrix.
__device__ __forceinline__ void store_staged(const CUtensorMap* map, unsigned char* staging,
                                             int col, int row, int cols, int elem = 2) {
  hopper::fence_proxy_async();
  hopper::named_bar_sync(1 + threadIdx.x / 128, 128);
  if (threadIdx.x % 128 == 0) {
    for (int i = 0; i < elem; ++i)
      if (col + i * (128 / elem) < cols)
        hopper::tma_store_2d(map, staging + i * kBoxBytes, col + i * (128 / elem), row);
    hopper::bulk_commit();
  }
}

// f(i, row, col) for the 32 pairs of neighbouring columns of an
// accumulator that this thread holds (pair i is registers 2 i, 2 i + 1); row
// in [0, 64) of its warpgroup, col (even) in [0, 128).
template <class F>
__device__ __forceinline__ void for_each_slot(F&& f) {
  const int t = threadIdx.x % 128;
  const int r0 = 16 * (t / 32) + (t % 32) / 4, c0 = 2 * (t % 4);
#pragma unroll
  for (int j = 0; j < 16; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h) f(2 * j + h, r0 + 8 * h, 8 * j + c0);
}

// f(row, col, v0, v1) over the accumulator's pairs (see for_each_slot)
template <class F>
__device__ __forceinline__ void for_each_pair(const float (&acc)[64], F&& f) {
  for_each_slot([&](int i, int r, int c) { f(r, c, acc[2 * i], acc[2 * i + 1]); });
}

// n = sqrt(ssq + eps), or sqrt(ssq) + eps, of the two rows this thread holds
// in the accumulator (pair slot i is on row i % 2), from the warpgroup's
// published sums of squares.
__device__ __forceinline__ void row_norms(const float* ssq_s, float eps, int eps_outside,
                                          float (&n)[2]) {
  const int t = threadIdx.x % 128;
  const int r0 = 64 * (threadIdx.x / 128) + 16 * (t / 32) + (t % 32) / 4;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const float ssq = ssq_s[r0 + 8 * h];
    n[h] = eps_outside ? sqrtf(ssq) + eps : sqrtf(ssq + eps);
  }
}

// Elements (row, col) and (row, col + 1) of a bf16 [rows, cols] matrix as
// one 32-bit word (col in the low half), zero beyond the matrix; `pairs`
// says that the two may be read as one aligned word. Read-only loads
// (__ldg), so the compiler may hoist them past the epilogue's stores.
__device__ __forceinline__ uint32_t load_pair(const bf16* m, int rows, int cols, int row, int col,
                                              int pairs) {
  if (row >= rows) return 0;
  const uint16_t* q = reinterpret_cast<const uint16_t*>(m) + (long long)row * cols + col;
  if (pairs && col + 1 < cols) return __ldg(reinterpret_cast<const unsigned int*>(q));
  return (col < cols ? __ldg(q) : 0u) | (col + 1 < cols ? (uint32_t)__ldg(q + 1) << 16 : 0u);
}
__device__ __forceinline__ float lo_bf16(uint32_t w) { return __uint_as_float(w << 16); }
__device__ __forceinline__ float hi_bf16(uint32_t w) { return __uint_as_float(w & 0xffff0000u); }

// out[row, col .. col + 1] = (v0, v1) in bf16, masked to [.., cols); out has
// a row stride of ld elements.
__device__ __forceinline__ void store_pair(bf16* out, int ld, int row, int col, int cols, float v0,
                                           float v1) {
  const long long off = (long long)row * ld + col;
  if (col + 1 < cols && (off & 1) == 0) {
    *reinterpret_cast<__nv_bfloat162*>(out + off) = __floats2bfloat162_rn(v0, v1);
  } else {
    if (col < cols) out[off] = __float2bfloat16(v0);
    if (col + 1 < cols) out[off + 1] = __float2bfloat16(v1);
  }
}

// The same for an f32 matrix.
__device__ __forceinline__ void store_pair(float* out, int ld, int row, int col, int cols, float v0,
                                           float v1) {
  const long long off = (long long)row * ld + col;
  if (col + 1 < cols && (off & 1) == 0) {
    *reinterpret_cast<float2*>(out + off) = make_float2(v0, v1);
  } else {
    if (col < cols) out[off] = v0;
    if (col + 1 < cols) out[off + 1] = v1;
  }
}

}  // namespace engine
