// The fp32 route of K2 and K3 on Hopper: 3xTF32 wgmma on the TMA ring of
// bcos_engine.cuh.
//
// fp32 is not a test-only route: the CLIP benchmark harness feeds fp32
// images, so every harness encode runs K3 in fp32, and text localisation
// runs K2 in fp32. Both are held to 1e-5 of max |ref| against their plain
// versions (f32 products, TF32 off) and to the CPU through whole nets, so
// one tf32 pass (~3e-4) is not enough. An f32 product a b is taken as
//
//   hi(a) hi(b) + hi(a) lo(b) + lo(a) hi(b),  hi = tf32(a) (cvt.rna),
//                                              lo = tf32(a - hi)
//
// three tf32 wgmmas per k8 step into the same f32 accumulators, the small
// terms first. The dropped lo(a) lo(b) is ~2^-22 of the product, so the sum
// keeps about fp32's accuracy (~1e-6 of max |u| at K = 64..2048) for three
// times the tensor cores' work: 495 TFLOP/s of tf32 are ~165 of fp32,
// against 67 outside the tensor cores. What bounds the route on the H100:
// 3 x 2 M N K operations at 495 TFLOP/s at the harness's shapes (one
// encode: 1.72 ms by operations against 1.29 ms by bytes).
//
// tf32 wgmma reads both operands K-major (no transpose) and B only from
// shared memory, where the tensor cores read the top 19 bits of each f32.
// So the weight B (small: [N, K]) is split once per call by split_weight
// into hi and lo (and, for K2's second product, their transposes) in
// scratch that the wrapper allocates; the activation A is split in
// registers: each consumer thread reads its A fragment from the stage's
// swizzled f32 box, forms hi and lo, and sums its two rows' squares from
// the same registers (the row norm costs no extra read of x).
//
// Layout (gemm_3xtf32): persistent 128-row blocks (two consumer warpgroups
// share each B tile) and one producer warp, one block per SM, walk 128 x
// 128 output tiles numbered N fastest. A stage of the ring holds each
// warpgroup's A box (64 rows x 32 f32) and the hi and lo B tiles (128 rows
// x 32 deep each): 48 KB, so 3 stages fit beside the 64 KB f32 staging
// buffer from which the output leaves by TMA stores. A warpgroup waits for
// its stage's 12 wgmmas before it releases the stage and writes the next
// stage's A registers; the other warpgroup's wgmmas fill that gap. Each
// stage's products are summed on the tensor cores from zero and added to
// the chain's sum on the CUDA cores (see mma_chain). A block of 9 warps
// puts 3 on one of the SM's four register files, so a thread gets at most
// 168 registers: the 64 + 64 sums and the 32 split A registers spill 20-40
// bytes. Three epilogues share the mainloop: K3's y = u |u| / n, K2's g =
// ct mult [a > 0] |u| / n, and K2's dx = g w as it stands.
//
// Split-K: where the 128 x 128 tiles fill less than half the SMs (one
// 224^2 image: M = 49 to 196, chains of up to 64 stages on 4 to 16 blocks)
// the wrapper asks for K splits (bcos_conv1x1.tf32_splits): each block
// sums a slice of the chain into a partial buffer, and splitk_reduce adds
// the slices in order and runs the epilogue. It halved K2's card time per
// text localisation (2.62 -> 1.29 ms on an H100; PERF.md).
#pragma once

#include "bcos_engine.cuh"

namespace tf32 {

using namespace engine;

enum Epilogue { kBcos = 0, kGrad = 1, kStore = 2 };

constexpr int kRows = 128;
constexpr int kDepth = 32;  // the contraction of one stage: a box row of 32 f32
constexpr int kStages = fit_stages(Smem{kRows, 0, 0, 1, 4, 4});
static_assert(kStages >= 2, "the fp32 ring does not fit beside its staging buffer");

// hi = tf32(wt) and lo = tf32(wt - hi) of wt [N, K] (row stride K) into whi
// and wlo (the same layout) and, where thi is not null, their transposes
// into thi and tlo [K, N] (row stride ldt); 32 x 32 tiles, 256 threads.
static __global__ void __launch_bounds__(256)
    split_weight(const float* __restrict__ wt, float* __restrict__ whi, float* __restrict__ wlo,
                 float* __restrict__ thi, float* __restrict__ tlo, int N, int K, int ldt) {
  __shared__ float hi_s[32][33], lo_s[32][33];
  const int k0 = blockIdx.x * 32, n0 = blockIdx.y * 32;
  const int tx = threadIdx.x % 32, ty = threadIdx.x / 32;
  for (int j = ty; j < 32; j += 8) {
    const int n = n0 + j, k = k0 + tx;
    if (n < N && k < K) {
      const long long off = (long long)n * K + k;
      const float v = wt[off];
      const float h = __uint_as_float(hopper::tf32_rna(v));
      const float l = __uint_as_float(hopper::tf32_rna(v - h));
      whi[off] = h;
      wlo[off] = l;
      hi_s[j][tx] = h;
      lo_s[j][tx] = l;
    }
  }
  if (thi == nullptr) return;  // the same for the whole block
  __syncthreads();
  for (int j = ty; j < 32; j += 8) {
    const int k = k0 + j, n = n0 + tx;
    if (n < N && k < K) {
      thi[(long long)k * ldt + n] = hi_s[tx][j];
      tlo[(long long)k * ldt + n] = lo_s[tx][j];
    }
  }
}

inline int launch_split(const float* wt, float* whi, float* wlo, float* thi, float* tlo, int N,
                        int K, int ldt, cudaStream_t s) {
  const dim3 grid((K + 31) / 32, (N + 31) / 32);
  split_weight<<<grid, 256, 0, s>>>(wt, whi, wlo, thi, tlo, N, K, ldt);
  return (int)cudaGetLastError();
}

struct Args {
  float* out;        // [M, N] with row stride ld: y, g or dx
  const float* ct;   // kGrad: the cotangent [M, N]
  const float* act;  // kGrad with relu: the layer's output [M, N]
  const float* mult; // kGrad: [N], or null (1)
  int M, K, N, ld;
  float eps;
  int eps_outside, relu;
  int tma_out;  // out leaves by TMA stores (ld a multiple of 4), else from the registers
  int pairs;    // ct and act may be read two columns at a time
  // split-K (splits > 1): split s of a tile sums stages [s c, s c + c) of
  // the contraction (c = ceil(stages / splits)) into part [splits, mp, ldp]
  // and its rows' squares into part_ssq [splits, mp] (mp = M rounded up to
  // the tile, ldp = N rounded up to 4); splitk_reduce finishes the epilogue
  int splits = 1, mp = 0, ldp = 0;
  float* part = nullptr;
  float* part_ssq = nullptr;
};

// The epilogue of one element from its u and its row's norm n (kGrad also
// takes the element's ct, a and mult).
template <int kEpi>
__device__ __forceinline__ float finish(const Args& p, float u, float n, float ct, float a,
                                        float mult) {
  if (kEpi == kBcos) return u * (fabsf(u) / n);
  if (kEpi == kGrad) return (p.relu && !(a > 0.f)) ? 0.f : ct * mult * (fabsf(u) / n);
  return u;
}

// Producer (one thread): the next stage holds the hi and lo B boxes at
// (k, n0) and (k, n0 + 64), then the A boxes at (k, row0 + 64 i).
__device__ __forceinline__ void load_stage(Ring& ring, const CUtensorMap* bhi,
                                           const CUtensorMap* blo, int k, int n0,
                                           const CUtensorMap* ta, int row0) {
  hopper::mbar_wait(&ring.empty[ring.stage], ring.phase ^ 1);
  uint64_t* full = &ring.full[ring.stage];
  hopper::mbar_arrive_expect_tx(full, (4 + kRows / 64) * kBoxBytes);
  unsigned char* b = ring.b(ring.stage);
  for (int h = 0; h < 2; ++h) {
    hopper::tma_load_2d(b + h * kBoxBytes, bhi, full, k, n0 + 64 * h);
    hopper::tma_load_2d(b + (2 + h) * kBoxBytes, blo, full, k, n0 + 64 * h);
  }
  for (int i = 0; i < kRows / 64; ++i)
    hopper::tma_load_2d(ring.a(ring.stage) + i * kBoxBytes, ta, full, k, row0 + 64 * i);
  ring.advance();
}

// Consumer warpgroup: acc = A[its 64 rows, K] B[n0 : n0 + 128, K]^T over
// `ktiles` stages, 3xTF32. Thread t holds A's rows r0 and r0 + 8 (r0 = 16 (t
// / 32) + (t % 32) / 4: the accumulator's rows); with kSsq their squares are
// added to ssq[0] and ssq[1]. The tensor cores add into their f32
// accumulators rounding toward zero, a bias of about half an ulp per
// addition that grows with the chain (5.3e-6 of max |y| at K = 256, 1.8e-5
// of max |dx| at K2's Cout = 2048; PERF.md): each stage's 12 wgmmas
// therefore start from zero in `part`, which is then added to acc with the
// CUDA cores' round-to-nearest. A chain of no stages leaves acc zero.
template <bool kSsq>
__device__ __forceinline__ void mma_chain(float (&acc)[64], Ring& ring, int ktiles,
                                          float (&ssq)[2]) {
  const int t = threadIdx.x % 128;
  const int r0 = 16 * (t / 32) + (t % 32) / 4, q = t % 4;
  float part[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.f;
  for (int kt = 0; kt < ktiles; ++kt) {
    hopper::mbar_wait(&ring.full[ring.stage], ring.phase);
    const unsigned char* a = ring.a(ring.stage) + (threadIdx.x / 128) * kBoxBytes;
    const unsigned char* b = ring.b(ring.stage);
    uint32_t hi[4][4], lo[4][4];  // [k8 step][fragment register]
#pragma unroll
    for (int s = 0; s < 4; ++s)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float v = *reinterpret_cast<const float*>(
            a + swizzled(r0 + 8 * (i % 2), 8 * s + q + 4 * (i / 2), 4));
        if (kSsq) ssq[i % 2] += v * v;
        hi[s][i] = hopper::tf32_rna(v);
        lo[s][i] = hopper::tf32_rna(v - __uint_as_float(hi[s][i]));
      }
    hopper::wgmma_fence();
#pragma unroll
    for (int s = 0; s < 4; ++s) {
      const uint64_t dhi = hopper::desc_sw128(b + 32 * s, 16, 1024);
      const uint64_t dlo = hopper::desc_sw128(b + 2 * kBoxBytes + 32 * s, 16, 1024);
      hopper::wgmma_m64n128k8_tf32(part, lo[s], dhi, s != 0);
      hopper::wgmma_m64n128k8_tf32(part, hi[s], dlo, 1);
      hopper::wgmma_m64n128k8_tf32(part, hi[s], dhi, 1);
    }
    hopper::wgmma_commit();
    hopper::wgmma_wait<0>();
    hopper::mbar_arrive(&ring.empty[ring.stage]);
    ring.advance();
#pragma unroll
    for (int i = 0; i < 64; ++i) {
      hopper::fence_operand(part[i]);
      acc[i] += part[i];
    }
  }
}

// Elements (row, col) and (row, col + 1) of an f32 [rows, cols] matrix, zero
// beyond it; `pairs`: the two may be read as one aligned float2.
__device__ __forceinline__ float2 load_pair_f32(const float* m, int rows, int cols, int row,
                                                int col, int pairs) {
  if (row >= rows) return make_float2(0.f, 0.f);
  const float* q = m + (long long)row * cols + col;
  if (pairs && col + 1 < cols) return __ldg(reinterpret_cast<const float2*>(q));
  return make_float2(col < cols ? __ldg(q) : 0.f, col + 1 < cols ? __ldg(q + 1) : 0.f);
}

// tm_a: A [M, K]; tm_bhi, tm_blo: B's hi and lo [N, K]; tm_out: out [M, N]
// where p.tma_out. The contraction runs over p.K, the output over p.N.
template <int kEpi>
__global__ void __launch_bounds__(block_threads(kRows), 1)
    gemm_3xtf32(const __grid_constant__ CUtensorMap tm_a, const __grid_constant__ CUtensorMap tm_bhi,
                const __grid_constant__ CUtensorMap tm_blo,
                const __grid_constant__ CUtensorMap tm_out, Args p) {
  extern __shared__ __align__(1024) unsigned char smem[];
  constexpr Smem L{kRows, kStages, 0, 1, 4, 4};
  unsigned char* base = aligned_base(smem);
  Ring ring = make_ring(base, L);
  const int ktiles = (p.K + kDepth - 1) / kDepth;
  const int kchunk = (ktiles + p.splits - 1) / p.splits;
  const int n_tiles = (p.N + kChunk - 1) / kChunk;
  const int items = n_tiles * ((p.M + kRows - 1) / kRows) * p.splits;  // N fastest, then K
  struct Item { int n0, row0, split, kt0, kt1; };
  auto item = [&](int w) {
    const int tile = w / p.splits, split = w % p.splits;
    const int kt0 = split * kchunk;
    return Item{(tile % n_tiles) * kChunk, (tile / n_tiles) * kRows, split, kt0,
                min(ktiles, kt0 + kchunk)};
  };

  if (warpgroup() == kRows / 64) {  // the producer warp
    if (threadIdx.x == 2 * kRows)
      for (int w = blockIdx.x; w < items; w += gridDim.x) {
        const Item it = item(w);
        for (int kt = it.kt0; kt < it.kt1; ++kt)
          load_stage(ring, &tm_bhi, &tm_blo, kDepth * kt, it.n0, &tm_a, it.row0);
      }
    return;
  }

  const int wg = threadIdx.x / 128, t = threadIdx.x % 128;
  const bool split = p.splits > 1;  // raw partial sums out, splitk_reduce finishes
  unsigned char* staging = staging_of(base + L.out_offset(), 4);
  float acc[64];
  for (int w = blockIdx.x; w < items; w += gridDim.x) {
    const Item it = item(w);
    const int row0 = it.row0;
    float ssq[2] = {0.f, 0.f}, norm[2] = {1.f, 1.f};
    mma_chain<kEpi != kStore>(acc, ring, max(it.kt1 - it.kt0, 0), ssq);
    if (kEpi != kStore) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {  // the four threads of a row hold its 32-column slices
        ssq[h] += __shfl_xor_sync(0xffffffffu, ssq[h], 1);
        ssq[h] += __shfl_xor_sync(0xffffffffu, ssq[h], 2);
        norm[h] = p.eps_outside ? sqrtf(ssq[h]) + p.eps : sqrtf(ssq[h] + p.eps);
        if (split && t % 4 == 0)
          p.part_ssq[it.split * p.mp + row0 + 64 * wg + 16 * (t / 32) + (t % 32) / 4 + 8 * h] =
              ssq[h];
      }
    }
    // the last store from the buffer ran under the mainloop: the elected
    // thread waits for it, the warpgroup's barrier passes that on
    staging_wait();
    hopper::named_bar_sync(1 + wg, 128);
    for_each_slot([&](int i, int r, int c) {
      float v0 = acc[2 * i], v1 = acc[2 * i + 1];
      const int gr = row0 + 64 * wg + r, gc = it.n0 + c;
      if (!split && kEpi != kStore) {
        const float n = norm[i % 2];
        float2 ct{0.f, 0.f}, a{0.f, 0.f}, m{1.f, 1.f};
        if (kEpi == kGrad) {  // ct reads zeros beyond M and N, so g is 0 there
          ct = load_pair_f32(p.ct, p.M, p.N, gr, gc, p.pairs);
          if (p.relu) a = load_pair_f32(p.act, p.M, p.N, gr, gc, p.pairs);
          if (p.mult != nullptr)
            m = make_float2(__ldg(p.mult + min(gc, p.N - 1)), __ldg(p.mult + min(gc + 1, p.N - 1)));
        }
        v0 = finish<kEpi>(p, v0, n, ct.x, a.x, m.x);
        v1 = finish<kEpi>(p, v1, n, ct.y, a.y, m.y);
      }
      if (split || p.tma_out)
        stage_pair_f32(staging, r, c, v0, v1);
      else if (gr < p.M)
        store_pair(p.out, p.ld, gr, gc, p.N, v0, v1);
    });
    if (split || p.tma_out)
      store_staged(&tm_out, staging, it.n0, (split ? it.split * p.mp : 0) + row0 + 64 * wg, p.N,
                   4);
  }
  staging_wait();  // shared memory stays until the last store has read it
}

// Split-K's second pass: out[row, col] = the epilogue of the sum of the
// splits' partial u, with the row norm from the sum of their squares; one
// thread per element, the splits summed in order.
template <int kEpi>
__global__ void __launch_bounds__(256) splitk_reduce(Args p) {
  const long long total = (long long)p.M * p.N;
  for (long long e = blockIdx.x * 256LL + threadIdx.x; e < total; e += gridDim.x * 256LL) {
    const int row = (int)(e / p.N), col = (int)(e % p.N);
    float u = 0.f, ssq = 0.f;
    for (int sp = 0; sp < p.splits; ++sp) {
      u += p.part[((long long)sp * p.mp + row) * p.ldp + col];
      if (kEpi != kStore) ssq += p.part_ssq[sp * p.mp + row];
    }
    const float n = p.eps_outside ? sqrtf(ssq) + p.eps : sqrtf(ssq + p.eps);
    float ct = 0.f, a = 0.f, m = 1.f;
    if (kEpi == kGrad) {
      ct = p.ct[e];
      if (p.relu) a = p.act[e];
      if (p.mult != nullptr) m = p.mult[col];
    }
    p.out[(long long)row * p.ld + col] = finish<kEpi>(p, u, n, ct, a, m);
  }
}

// out = epilogue(A B^T) for A [p.M, p.K] (row stride lda) and B's hi and lo
// [p.N, p.K] (row stride ldb), all f32 and 16-byte aligned, lda and ldb
// multiples of 4; with p.splits > 1 through split-K, its partial sums in
// `part` (splits round_up(M, 128) (round_up(N, 4) + 1) floats, 16-byte
// aligned), then splitk_reduce. Returns a CUDA error code.
template <int kEpi>
inline int launch(const float* a, int lda, const float* bhi, const float* blo, int ldb, Args p,
                  float* part, cudaStream_t s) {
  CUtensorMap tm_a, tm_bhi, tm_blo, tm_out{};
  if (p.splits < 1 || (p.splits > 1 && part == nullptr)) return (int)cudaErrorInvalidValue;
  int err = hopper::encode_tile_map(&tm_a, a, p.M, p.K, lda, 4);
  if (err == 0) err = hopper::encode_tile_map(&tm_bhi, bhi, p.N, p.K, ldb, 4);
  if (err == 0) err = hopper::encode_tile_map(&tm_blo, blo, p.N, p.K, ldb, 4);
  if (err == 0 && p.splits > 1) {
    p.mp = (p.M + kRows - 1) / kRows * kRows;
    p.ldp = (p.N + 3) / 4 * 4;
    p.part = part;
    p.part_ssq = part + (long long)p.splits * p.mp * p.ldp;
    err = hopper::encode_tile_map(&tm_out, part, p.splits * p.mp, p.N, p.ldp, 4);
  } else if (err == 0 && p.tma_out) {
    err = hopper::encode_tile_map(&tm_out, p.out, p.M, p.N, p.ld, 4);
  }
  if (err != 0) return err;
  static const cudaError_t attr = cudaFuncSetAttribute(
      gemm_3xtf32<kEpi>, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemLimit);
  if (attr != cudaSuccess) return (int)attr;
  const int threads = block_threads(kRows);
  const int smem = Smem{kRows, kStages, 0, 1, 4, 4}.bytes();
  const int items = (p.N + kChunk - 1) / kChunk * ((p.M + kRows - 1) / kRows) * p.splits;
  // the blocks the SMs hold, asked once: the text localisation's calls are
  // short enough for the host's work per launch to show
  static const int resident = persistent_blocks(gemm_3xtf32<kEpi>, threads, smem, 1 << 30);
  const dim3 grid(items < resident ? items : resident);
  gemm_3xtf32<kEpi><<<grid, threads, smem, s>>>(tm_a, tm_bhi, tm_blo, tm_out, p);
  err = (int)cudaGetLastError();
  if (err != 0 || p.splits == 1) return err;
  const long long blocks = ((long long)p.M * p.N + 255) / 256;
  splitk_reduce<kEpi><<<(unsigned)(blocks < 1024 ? blocks : 1024), 256, 0, s>>>(p);
  return (int)cudaGetLastError();
}

}  // namespace tf32
