// K1: fused 1x1 B-cos conv (b=2) + folded uncentered-BN affine + optional ReLU.
//
// Replaces bcosification_tpu/ops/pallas/bcos_conv1x1.py::_fwd_kernel
// (launched by _pallas_fwd). For x [M, Cin] (pixels x channels), the 1x1
// weight wt [Cout, Cin], and per-channel mult/add (BN eval: gamma/std, beta):
//
//   u = x @ wt^T (f32 accumulation);  n = sqrt(sum_c x^2 + eps)
//   z = (|u| / n) * u * mult + add;   z = max(z, 0) if relu
//
// with ONE store of z in x's dtype. M and Cout may be ragged: loads beyond
// the matrices read zeros and every store is masked, so layer1's Cout = 64
// needs no padding.
//
// What bounds it on the H100: at the trunk's shapes the GEMM has an
// arithmetic intensity of roughly Cin*Cout/(Cin+Cout) FLOP per byte (32 to
// ~700), so the small-channel layers are bound by the bytes of x and z and
// the deep ones by the tensor cores. Both need the loads to overlap the
// products and the products to run at the tensor cores' rate.
//
// bf16 design (bcos_engine.cuh): persistent blocks of one consumer
// warpgroup and one producer warp, two per SM, walk 64 x 128 tiles of z.
// TMA streams the x and wt tiles of each 64-deep K step through a ring of
// 3 stages; the consumers run m64n128k16 wgmmas with f32 accumulators in
// registers, one stage in flight behind the next, and load the tile's mult
// and add under them. The row sums of squares
// come from the same x tiles in shared memory (no second read of x, no
// [M, 1] intermediate), and the epilogue runs on the accumulator registers,
// so u never reaches memory; z is staged in shared memory (two buffers in
// turn) and leaves by TMA stores (where Cout is a multiple of 8; else from
// the registers). Output
// tiles are numbered Cout fastest, so the blocks that share an x row tile
// run together and find it in L2; the producer loads the next tile while
// the consumers store this one, and the other block on the SM fills the
// gaps of this one's epilogue.
// TMA needs 16-byte row strides: bf16 Cin must be a multiple of 8 (the
// wrapper zero-pads x and wt otherwise).
//
// fp32 (text localisation, the fp32 GPU-vs-CPU checks) still runs the FMA
// tile loop of bcos_gemm.cuh (64 x 64 tiles) on the CUDA cores; it is the
// next fp32 route to move to the 3xTF32 route of bcos_tf32.cuh (PERF.md).
#include "bcos_engine.cuh"
#include "bcos_gemm.cuh"

namespace {

using namespace bcos;

__global__ void __launch_bounds__(kThreads)
    conv1x1_fwd_kernel(const float* __restrict__ x, const float* __restrict__ wt,
                       const float* __restrict__ mult, const float* __restrict__ add,
                       float* __restrict__ out, int M, int K, int N, float eps, int relu) {
  constexpr int kTileBytes = 2 * BM * LDK * (int)sizeof(float);
  constexpr int kAccBytes = BM * LDC * (int)sizeof(float);
  constexpr int kRegion = kTileBytes > kAccBytes ? kTileBytes : kAccBytes;
  __shared__ __align__(128) unsigned char smem[kRegion];
  __shared__ float ssq_s[BM];
  float* As = reinterpret_cast<float*>(smem);
  float* Bs = As + BM * LDK;
  float* Cs = reinterpret_cast<float*>(smem);  // reused once the K loop is done

  const int col0 = blockIdx.x * BN;
  const int row0 = blockIdx.y * BM;
  BlockMma acc;
  gemm_nt_tile(acc, As, Bs, ssq_s, true, x, wt, M, K, N, row0, col0);
  acc.store(Cs, LDC);
  __syncthreads();

  for (int idx = threadIdx.x; idx < BM * BN; idx += kThreads) {
    const int r = idx / BN, c = idx % BN;
    const int gr = row0 + r, gc = col0 + c;
    if (gr >= M || gc >= N) continue;
    const float u = Cs[r * LDC + c];
    const float n = sqrtf(ssq_s[r] + eps);
    float z = (fabsf(u) / n) * u * mult[gc];
    if (add != nullptr) z += add[gc];
    if (relu) z = fmaxf(z, 0.f);
    out[(long long)gr * N + gc] = z;
  }
}

struct FwdArgs {
  const float* mult;
  const float* add;
  __nv_bfloat16* out;
  int M, K, N, rows, stages;
  float eps;
  int relu, tma_out;  // tma_out: z leaves by TMA stores (Cout a multiple of 8)
};

__global__ void __launch_bounds__(engine::kMaxThreads, 1)
    conv1x1_fwd_wgmma(const __grid_constant__ CUtensorMap tm_x,
                      const __grid_constant__ CUtensorMap tm_w,
                      const __grid_constant__ CUtensorMap tm_out, FwdArgs p) {
  using namespace engine;
  extern __shared__ __align__(1024) unsigned char smem[];
  const int R = p.rows;
  const Smem L{R, p.stages, 0, 2};
  unsigned char* base = aligned_base(smem);
  Ring ring = make_ring(base, L);
  const int ktiles = (p.K + 63) / 64;
  const int n_tiles = (p.N + kChunk - 1) / kChunk;
  const int tiles = n_tiles * ((p.M + R - 1) / R);  // Cout fastest

  if (warpgroup() == R / 64) {  // the producer warp
    if (threadIdx.x == 2 * R)
      for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
        const int n0 = (tile % n_tiles) * kChunk, row0 = (tile / n_tiles) * R;
        for (int kt = 0; kt < ktiles; ++kt)
          load_stage(ring, &tm_w, 64 * kt, n0, 64 * kt, n0 + 64, &tm_x, 64 * kt, row0, R / 64);
      }
    return;
  }

  const int wg = threadIdx.x / 128;
  float acc[64];
  for (int tile = blockIdx.x, iter = 0; tile < tiles; tile += gridDim.x, ++iter) {
    const int n0 = (tile % n_tiles) * kChunk, row0 = (tile / n_tiles) * R;
    float* ssq_s = reinterpret_cast<float*>(base + L.ssq_offset()) + (iter & 1) * R;
    unsigned char* staging = staging_of(base + L.out_offset(iter & 1));
    float part = 0.f;
    staging_wait<1>();  // the store of the other buffer may still read it
    // this thread's 32 columns' mult and add, loaded under the mainloop
    // (columns beyond Cout are clamped: their values are never stored)
    float mult[32], add[32];
#pragma unroll
    for (int q = 0; q < 32; ++q) {
      const int col = min(n0 + 8 * (q / 2) + 2 * (int)(threadIdx.x % 4) + q % 2, p.N - 1);
      mult[q] = __ldg(p.mult + col);
      add[q] = p.add != nullptr ? __ldg(p.add + col) : 0.f;
    }
    mma_chain<0>(acc, ring, ktiles, nullptr, 0, &part);
    publish_row_ssq(part, ssq_s);
    float norm[2];
    row_norms(ssq_s, p.eps, 0, norm);
    for_each_slot([&](int i, int r, int c) {
      const int gr = row0 + 64 * wg + r, gc = n0 + c;
      float z[2] = {acc[2 * i], acc[2 * i + 1]};
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        z[e] = (fabsf(z[e]) / norm[i % 2]) * z[e] * mult[i / 2 * 2 + e] + add[i / 2 * 2 + e];
        if (p.relu) z[e] = fmaxf(z[e], 0.f);
      }
      if (p.tma_out)
        stage_pair(staging, r, c, z[0], z[1]);
      else if (gr < p.M)
        store_pair(p.out, p.N, gr, gc, p.N, z[0], z[1]);
    });
    if (p.tma_out) store_staged(&tm_out, staging, n0, row0 + 64 * wg, p.N);
  }
  staging_wait();  // shared memory stays until the last store has read it
}

int launch_bf16(const void* x, const void* wt, const void* mult, const void* add, void* out,
                int M, int K, int N, float eps, int relu, cudaStream_t s) {
  CUtensorMap tm_x, tm_w, tm_out{};
  const int tma_out = N % 8 == 0;  // else z is stored from the registers
  int err = hopper::encode_tile_map(&tm_x, x, M, K, K);
  if (err == 0) err = hopper::encode_tile_map(&tm_w, wt, N, K, K);
  if (err == 0 && tma_out) err = hopper::encode_tile_map(&tm_out, out, M, N, N);
  if (err != 0) return err;
  static const cudaError_t attr =
      cudaFuncSetAttribute(conv1x1_fwd_wgmma, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           engine::kSmemLimit);
  if (attr != cudaSuccess) return (int)attr;
  engine::Smem L{64, 0, 0, 2};  // two blocks per SM, two staging buffers
  L.stages = engine::fit_stages(L, engine::kSmemHalf);
  const FwdArgs p{static_cast<const float*>(mult), static_cast<const float*>(add),
                  static_cast<__nv_bfloat16*>(out), M, K, N, L.rows, L.stages, eps, relu, tma_out};
  const int threads = engine::block_threads(L.rows), smem = L.bytes();
  const int tiles = (N + engine::kChunk - 1) / engine::kChunk * ((M + L.rows - 1) / L.rows);
  const dim3 grid(engine::persistent_blocks(conv1x1_fwd_wgmma, threads, smem, tiles));
  conv1x1_fwd_wgmma<<<grid, threads, smem, s>>>(tm_x, tm_w, tm_out, p);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (Cin a multiple of 8, 16-byte aligned
// x and wt). Returns a CUDA error code (0 after a good launch).
extern "C" int bcos_conv1x1_fwd(int dtype, const void* x, const void* wt, const void* mult,
                                const void* add, void* out, int M, int K, int N, float eps,
                                int relu, void* stream) {
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  if (dtype == 1) return launch_bf16(x, wt, mult, add, out, M, K, N, eps, relu, s);
  if (dtype != 0) return (int)cudaErrorInvalidValue;
  const dim3 grid((N + bcos::BN - 1) / bcos::BN, (M + bcos::BM - 1) / bcos::BM);
  conv1x1_fwd_kernel<<<grid, bcos::kThreads, 0, s>>>(
      static_cast<const float*>(x), static_cast<const float*>(wt),
      static_cast<const float*>(mult), static_cast<const float*>(add), static_cast<float*>(out),
      M, K, N, eps, relu);
  return (int)cudaGetLastError();
}
