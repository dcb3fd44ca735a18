// K3: the B-cos matmul (b=2) with an f32 output.
//
// Replaces bcosification_tpu/ops/pallas/bcos_matmul.py::_fwd_kernel
// (launched by _pallas_forward). For x [M, K] and wt [N, K]:
//
//   u = x @ wt^T (f32 accumulation)
//   n = sqrt(ssq + eps)        (conv patch-norm semantics), or
//   n = sqrt(ssq) + eps        (eps_outside: linear semantics)
//   y = u * (|u| / n)          -> f32 [M, N]
//
// with ssq the row sum of squares of x in f32. On the main path it is the
// GAP-reorder classifier, M = batch*7*7, K = 2048, N = 1000; the ragged
// N = 1000 is masked, not padded.
//
// What bounds it on the H100: at the classifier's shape the GEMM does about
// 2*K*N/(2K + 4N) ~ 340 FLOP per byte moved, above the card's ~295 bf16
// ridge, so the tensor cores bound it. The TPU kernel's one idea stays: the
// row norm comes from the same x tiles that feed the product and the
// scaling runs on the accumulators, so neither u nor the norm reaches
// device memory.
//
// bf16 design, on the engine of bcos_engine.cuh (K1's, without mult, add
// and ReLU): persistent blocks of two consumer warpgroups (128 rows, which
// share each wt tile) and one producer warp, one per SM, walk 128 x 128
// tiles of y, numbered N fastest, so the 8 column tiles that share an x row
// tile run together and find it in L2. TMA streams the x and wt boxes of
// each 64-deep K step through a ring of stages (rows of wt beyond N read as
// zeros); each consumer warpgroup runs m64n128k16 wgmma chains with f32
// accumulators in registers and sums its rows' squares from the same
// swizzled x tiles. The epilogue scales the accumulator registers and
// stages y in f32 in shared memory (four 64 x 32 boxes per warpgroup, the
// 128-byte swizzle on 4-byte elements) for TMA stores that clip at M and N;
// the store runs under the next tile's mainloop. TMA needs 16-byte rows: y
// leaves by TMA where N is a multiple of 4, else from the registers as
// masked float2 pairs; bf16 K must be a multiple of 8 (the wrapper
// zero-pads x and wt otherwise). Of four shared-memory layouts timed side by side (PERF.md,
// PR 4), 128-row blocks with one f32 staging buffer (64 KB) and as many
// stages as fit beside it (5) were the fastest at the classifier's shape.
//
// fp32 keeps the FMA tile loop of bcos_gemm.cuh, so the kernel can be held
// tightly against its plain version; the model runs in bf16.
#include "bcos_engine.cuh"
#include "bcos_gemm.cuh"

namespace {

using namespace bcos;

__global__ void __launch_bounds__(kThreads)
    bcos_matmul_fwd_kernel(const float* __restrict__ x, const float* __restrict__ wt,
                           float* __restrict__ y, int M, int K, int N, float eps,
                           int eps_outside) {
  constexpr int kTileBytes = 2 * BM * LDK * (int)sizeof(float);
  constexpr int kAccBytes = BM * LDC * (int)sizeof(float);
  constexpr int kRegion = kTileBytes > kAccBytes ? kTileBytes : kAccBytes;
  __shared__ __align__(128) unsigned char smem[kRegion];
  __shared__ float ssq_s[BM];
  float* As = reinterpret_cast<float*>(smem);
  float* Bs = As + BM * LDK;
  float* Cs = reinterpret_cast<float*>(smem);

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
    const float n = eps_outside ? sqrtf(ssq_s[r]) + eps : sqrtf(ssq_s[r] + eps);
    y[(long long)gr * N + gc] = u * (fabsf(u) / n);
  }
}

// The layout: 128-row blocks (two consumer warpgroups share each wt tile),
// one per SM, with one f32 staging buffer and as many stages as fit beside it.
constexpr int kRows = 128;
constexpr int kStages = engine::fit_stages({kRows, 0, 0, 1, 4});
static_assert(kStages >= 2, "K3's ring does not fit beside its staging buffer");

struct MatmulArgs {
  float* y;
  int M, K, N;
  float eps;
  int eps_outside, tma_out;  // tma_out: y leaves by TMA stores (N a multiple of 4)
};

__global__ void __launch_bounds__(engine::kMaxThreads, 1)
    bcos_matmul_wgmma(const __grid_constant__ CUtensorMap tm_x,
                      const __grid_constant__ CUtensorMap tm_w,
                      const __grid_constant__ CUtensorMap tm_y, MatmulArgs p) {
  using namespace engine;
  extern __shared__ __align__(1024) unsigned char smem[];
  constexpr Smem L{kRows, kStages, 0, 1, 4};
  unsigned char* base = aligned_base(smem);
  Ring ring = make_ring(base, L);
  const int ktiles = (p.K + 63) / 64;
  const int n_tiles = (p.N + kChunk - 1) / kChunk;
  const int tiles = n_tiles * ((p.M + kRows - 1) / kRows);  // N fastest

  if (warpgroup() == kRows / 64) {  // the producer warp
    if (threadIdx.x == 2 * kRows)
      for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
        const int n0 = (tile % n_tiles) * kChunk, row0 = (tile / n_tiles) * kRows;
        for (int kt = 0; kt < ktiles; ++kt)
          load_stage(ring, &tm_w, 64 * kt, n0, 64 * kt, n0 + 64, &tm_x, 64 * kt, row0,
                     kRows / 64);
      }
    return;
  }

  const int wg = threadIdx.x / 128;
  unsigned char* staging = staging_of(base + L.out_offset(), 4);
  float acc[64];
  for (int tile = blockIdx.x, iter = 0; tile < tiles; tile += gridDim.x, ++iter) {
    const int n0 = (tile % n_tiles) * kChunk, row0 = (tile / n_tiles) * kRows;
    float* ssq_s = reinterpret_cast<float*>(base + L.ssq_offset()) + (iter & 1) * kRows;
    float part = 0.f;
    mma_chain<0>(acc, ring, ktiles, nullptr, 0, &part);
    // the last store from the buffer ran under the mainloop; the barrier of
    // publish_row_ssq passes the elected thread's wait on
    staging_wait();
    publish_row_ssq(part, ssq_s);
    float norm[2];
    row_norms(ssq_s, p.eps, p.eps_outside, norm);
    for_each_slot([&](int i, int r, int c) {
      const float u0 = acc[2 * i], u1 = acc[2 * i + 1];
      const float y0 = u0 * (fabsf(u0) / norm[i % 2]), y1 = u1 * (fabsf(u1) / norm[i % 2]);
      const int gr = row0 + 64 * wg + r;
      if (p.tma_out)
        stage_pair_f32(staging, r, c, y0, y1);
      else if (gr < p.M)
        store_pair(p.y, p.N, gr, n0 + c, p.N, y0, y1);
    });
    if (p.tma_out) store_staged(&tm_y, staging, n0, row0 + 64 * wg, p.N, 4);
  }
  staging_wait();  // shared memory stays until the last store has read it
}

int launch_bf16(const void* x, const void* wt, void* y, int M, int K, int N, float eps,
                int eps_outside, cudaStream_t s) {
  CUtensorMap tm_x, tm_w, tm_y{};
  const int tma_out = N % 4 == 0;  // else y is stored from the registers
  int err = hopper::encode_tile_map(&tm_x, x, M, K, K);
  if (err == 0) err = hopper::encode_tile_map(&tm_w, wt, N, K, K);
  if (err == 0 && tma_out) err = hopper::encode_tile_map(&tm_y, y, M, N, N, 4);
  if (err != 0) return err;
  static const cudaError_t attr =
      cudaFuncSetAttribute(bcos_matmul_wgmma, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           engine::kSmemLimit);
  if (attr != cudaSuccess) return (int)attr;
  const MatmulArgs p{static_cast<float*>(y), M, K, N, eps, eps_outside, tma_out};
  const int threads = engine::block_threads(kRows);
  const int smem = engine::Smem{kRows, kStages, 0, 1, 4}.bytes();
  const int tiles = (N + engine::kChunk - 1) / engine::kChunk * ((M + kRows - 1) / kRows);
  const dim3 grid(engine::persistent_blocks(bcos_matmul_wgmma, threads, smem, tiles));
  bcos_matmul_wgmma<<<grid, threads, smem, s>>>(tm_x, tm_w, tm_y, p);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (of x and wt; K a multiple of 8, 16-byte
// aligned x and wt; y is always f32). Returns a CUDA error code (0 after a
// good launch).
extern "C" int bcos_matmul_fwd(int dtype, const void* x, const void* wt, void* y, int M, int K,
                               int N, float eps, int eps_outside, void* stream) {
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  if (dtype == 1) return launch_bf16(x, wt, y, M, K, N, eps, eps_outside, s);
  if (dtype != 0) return (int)cudaErrorInvalidValue;
  const dim3 grid((N + bcos::BN - 1) / bcos::BN, (M + bcos::BM - 1) / bcos::BM);
  bcos_matmul_fwd_kernel<<<grid, bcos::kThreads, 0, s>>>(
      static_cast<const float*>(x), static_cast<const float*>(wt), static_cast<float*>(y), M, K,
      N, eps, eps_outside);
  return (int)cudaGetLastError();
}
