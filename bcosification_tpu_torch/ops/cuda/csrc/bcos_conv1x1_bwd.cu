// K2: explanation-mode backward of the fused 1x1 B-cos conv.
//
// Replaces bcosification_tpu/ops/pallas/bcos_conv1x1.py::_bwd_kernel
// (launched by _pallas_bwd_explain; the JAX package's live VJP
// _fused_tpu_bwd computes the same function with XLA matmuls). In
// explanation mode the dynamic scale |u|/n is detached, so the layer is
// linear in x and its input cotangent is
//
//   u  = x @ wt^T (recomputed, f32);   n = sqrt(ssq + eps), or sqrt(ssq) + eps
//   g  = ct * mult * [a > 0] * |u| / n   in f32, then rounded to x's dtype
//   dx = g @ wt                          (f32 accumulation, stored in x's dtype)
//
// The mask is applied only when relu is set (a is then the layer's output);
// mult may be null (the classifier, mult = 1). Cotangents for w, the norm
// and the affine are zero in explanation mode and are not computed.
//
// What bounds it on the H100: two GEMMs of 2*M*Cin*Cout FLOPs each, so the
// tensor cores at the deep layers and the bytes of x, ct, a and dx at the
// wide shallow ones. A design that tiled dx over (pixels, input channels)
// had to recompute u once per channel tile (121.8 ms per ResNet-50
// explanation call at batch 128 on an H100 at 700 W, PERF.md), so a block
// owns whole rows: u is computed once and g never reaches device memory.
//
// bf16 design, on the GEMM engine of bcos_engine.cuh (TMA ring, mbarriers,
// wgmma with f32 accumulators in registers; one consumer warpgroup per 64
// rows and one producer warp; a persistent grid):
// - Fused (Cout <= 1024, one launch): a block walks row blocks of R pixels:
//   R = 64 with two blocks per SM where g is small (Cout <= 256), R = 128
//   (two warpgroups sharing the wt tiles) up to Cout 512 where M gives two
//   row blocks per SM and the layout fits, else R = 64 alone on its SM.
//   Phase 1 walks Cout in 128-column u-chains (x and wt tiles streamed, K
//   major); the row sums of squares come from the first chain's x tiles in
//   shared memory. Under each chain's mainloop the chain's mult is loaded
//   into registers and its ct (and a) tiles by TMA into the idle staging
//   buffers; read in the accumulator layout from global memory instead,
//   they took ~3 ms of the 9.8 ms per call (PERF.md). The epilogue turns
//   the accumulator registers into g, rounds it to bf16 and writes it into
//   shared memory as 128-byte swizzled 64-column slabs, the K-major A layout
//   that phase 2's wgmma reads. A proxy fence and the warpgroup's barrier
//   come before that read. Phase 2 walks Cin in 128-column dx-chains:
//   dx = g wt[:, k0 : k0 + 128] with wt's tiles loaded MN-major (the wgmma
//   transpose bit); dx is staged in bf16 and leaves by TMA stores.
// - Split (Cout > 1024: g of 64 rows would not fit in 227 KB at Cout =
//   2048): launch 1 runs phase 1 over 64 x 128 tiles and writes g in bf16 to
//   a scratch [M, Cout] that the wrapper allocates; launch 2 runs the same
//   engine as a plain GEMM, dx = g wt, with g's tiles streamed by TMA. The
//   extra traffic is g written once and read once.
// Where Cout is not a multiple of 8 (no TMA on ct and a), ct and a are read
// in the accumulator layout, two columns per load where aligned.
// TMA needs 16-byte row strides: bf16 Cin must be a multiple of 8 (the
// wrapper zero-pads x and wt otherwise).
//
// fp32 (text localisation runs K2 in fp32) takes the split design at every
// Cout on the 3xTF32 route of bcos_tf32.cuh: a small launch splits wt into
// hi and lo and their transposes, launch 1 writes g in f32 to the scratch
// [M, round_up(Cout, 4)] with the same mainloop as K3 and K2's epilogue,
// launch 2 runs the mainloop as a plain GEMM, dx = g w, on the transposed
// hi and lo (tf32 wgmma reads B K-major only). At one 224^2 image (M = 49
// to 3136) the deep layers' launches run split-K (their 128 x 128 tiles
// would leave most SMs idle behind chains of up to 64 stages), with their
// partial sums in the scratch too. TMA needs 16-byte rows here too: fp32
// Cin must be a multiple of 4 (the wrapper zero-pads x and wt otherwise).
#include "bcos_engine.cuh"
#include "bcos_tf32.cuh"

namespace {

// ---------------------------------------------------------------- bf16
using bf16 = __nv_bfloat16;
enum Mode { kFused = 0, kWriteG = 1, kDxFromG = 2 };
constexpr int kFusedMaxCout = 1024;          // beyond: the split path (the wrapper knows it too)
constexpr int kSmallCout = 256;              // up to here fused blocks of 64 rows, two per SM
constexpr int kRows128MinM = 2 * 132 * 128;  // 128-row blocks need two row blocks per H100 SM

struct BwdArgs {
  const bf16* ct;
  const bf16* a;
  const float* mult;
  int M, K, N, rows, stages, outs;
  float eps;
  int eps_outside, relu;
  int pairs;         // ct and a may be read two columns at a time
  int tma_ct, tma_a;  // fused: ct (and a) come by TMA into staging buffers 0 (and 1)
};

__host__ __device__ inline int g_slab_bytes(int rows, int N) {  // resident g of the fused mode
  return (N + engine::kChunk - 1) / engine::kChunk * 2 * rows * 128;
}

// tm_a: x [M, Cin], or g [M, Cout] in kDxFromG; tm_w: wt [Cout, Cin];
// tm_out: dx [M, Cin], or g in kWriteG; tm_ct, tm_act: ct and the layer's
// output a [M, Cout] where p.tma_ct, p.tma_a.
template <int kMode>
__global__ void __launch_bounds__(engine::kMaxThreads, 1)
    conv1x1_bwd_wgmma(const __grid_constant__ CUtensorMap tm_a,
                      const __grid_constant__ CUtensorMap tm_w,
                      const __grid_constant__ CUtensorMap tm_out,
                      const __grid_constant__ CUtensorMap tm_ct,
                      const __grid_constant__ CUtensorMap tm_act, BwdArgs p) {
  using namespace engine;
  extern __shared__ __align__(1024) unsigned char smem[];
  const int R = p.rows;
  const Smem L{R, p.stages, kMode == kFused ? g_slab_bytes(R, p.N) : 0, p.outs};
  unsigned char* base = aligned_base(smem);
  Ring ring = make_ring(base, L);

  // Tile t of the persistent walk: its R rows, its u-chains [n_begin, n_end)
  // and its dx-chains [k_begin, k_end). Fused: all chains; write-g: one
  // u-chain (Cout fastest); dx-from-g: one dx-chain (Cin fastest).
  const int k_tiles = (p.K + 63) / 64, n_tiles = (p.N + 63) / 64;
  const int cols = kMode == kWriteG ? (p.N + kChunk - 1) / kChunk
                   : kMode == kDxFromG ? (p.K + kChunk - 1) / kChunk : 1;
  const int tiles = (p.M + R - 1) / R * cols;
  struct Span { int row0, n_begin, n_end, k_begin, k_end; };
  auto span = [&](int tile) {
    Span sp{(tile / cols) * R, 0, 0, 0, 0};
    const int c0 = (tile % cols) * kChunk;
    if (kMode == kFused) {
      sp.n_end = p.N;
      sp.k_end = p.K;
    } else if (kMode == kWriteG) {
      sp.n_begin = c0;
      sp.n_end = min(c0 + kChunk, p.N);
    } else {
      sp.k_begin = c0;
      sp.k_end = min(c0 + kChunk, p.K);
    }
    return sp;
  };

  if (warpgroup() == R / 64) {  // the producer warp
    if (threadIdx.x == 2 * R)
      for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
        const Span sp = span(tile);
        for (int n0 = sp.n_begin; n0 < sp.n_end; n0 += kChunk)
          for (int kt = 0; kt < k_tiles; ++kt)
            load_stage(ring, &tm_w, 64 * kt, n0, 64 * kt, n0 + 64, &tm_a, 64 * kt, sp.row0,
                       R / 64);
        for (int k0 = sp.k_begin; k0 < sp.k_end; k0 += kChunk)
          for (int nt = 0; nt < n_tiles; ++nt)
            load_stage(ring, &tm_w, k0, 64 * nt, k0 + 64, 64 * nt, &tm_a, 64 * nt, sp.row0,
                       kMode == kDxFromG ? R / 64 : 0);
      }
    return;
  }

  const int wg = threadIdx.x / 128;
  const bool leader = threadIdx.x % 128 == 0;
  unsigned char* g_s = base + L.extra_offset();
  unsigned char* staging = staging_of(base + L.out_offset());  // dx, or g in kWriteG
  unsigned char* ct_s = staging;                                // ct where p.tma_ct
  unsigned char* a_s = staging_of(base + L.out_offset(1));      // a where p.tma_a
  uint64_t* ops_bar = op_bar(base, L);
  uint32_t ops_phase = 0;
  float acc[64];
  for (int tile = blockIdx.x, iter = 0; tile < tiles; tile += gridDim.x, ++iter) {
    const Span sp = span(tile);
    const int row0 = sp.row0;
    float* ssq_s = reinterpret_cast<float*>(base + L.ssq_offset()) + (iter & 1) * R;

    // ---- phase 1: g = ct * mult * [a > 0] * |u| / n, one u-chain at a time.
    // (Fused: this tile's g may overwrite the last tile's only after this
    // warpgroup's wgmmas of it are done, which its first publish_row_ssq
    // barrier ensures; each warpgroup reads only its own rows of g.)
    for (int n0 = sp.n_begin; n0 < sp.n_end; n0 += kChunk) {
      float part = 0.f;
      const bool first = n0 == sp.n_begin;
      if (kMode == kWriteG) staging_wait();
      if (p.tma_ct) {
        // this chain's ct (and a) tiles come by TMA under the mainloop, into
        // buffers that the last chain's epilogue and the last tile's dx
        // store are done with
        hopper::named_bar_sync(1 + wg, 128);
        if (leader) {
          staging_wait();
          hopper::mbar_arrive_expect_tx(ops_bar, (p.tma_a ? 4 : 2) * kBoxBytes);
          for (int h = 0; h < 2; ++h) {
            hopper::tma_load_2d(ct_s + h * kBoxBytes, &tm_ct, ops_bar, n0 + 64 * h, row0 + 64 * wg);
            if (p.tma_a)
              hopper::tma_load_2d(a_s + h * kBoxBytes, &tm_act, ops_bar, n0 + 64 * h,
                                  row0 + 64 * wg);
          }
        }
      }
      // this chain's mult, loaded under the mainloop (columns beyond Cout
      // clamped: their ct is zero)
      float mult[32];
#pragma unroll
      for (int q = 0; q < 32; ++q)
        mult[q] = p.mult == nullptr
                      ? 1.f
                      : __ldg(p.mult + min(n0 + 8 * (q / 2) + 2 * (int)(threadIdx.x % 4) + q % 2,
                                           p.N - 1));
      mma_chain<0>(acc, ring, k_tiles, nullptr, 0, first ? &part : nullptr);
      if (p.tma_ct) {
        hopper::mbar_wait(ops_bar, ops_phase);
        ops_phase ^= 1;
      }
      // this chain's ct, and [a > 0] as bits, in the accumulator's layout
      uint32_t ct2[32], live[2] = {~0u, ~0u};
      for_each_slot([&](int i, int r, int c) {
        ct2[i] = p.tma_ct ? staged_pair(ct_s, r, c)
                          : load_pair(p.ct, p.M, p.N, row0 + 64 * wg + r, n0 + c, p.pairs);
      });
      if (p.relu) {
        live[0] = live[1] = 0u;
        for_each_slot([&](int i, int r, int c) {
          const uint32_t w = p.tma_a ? staged_pair(a_s, r, c)
                                     : load_pair(p.a, p.M, p.N, row0 + 64 * wg + r, n0 + c, p.pairs);
          live[i / 16] |= (uint32_t)(lo_bf16(w) > 0.f) << (2 * (i % 16)) |
                          (uint32_t)(hi_bf16(w) > 0.f) << (2 * (i % 16) + 1);
        });
      }
      if (first) publish_row_ssq(part, ssq_s);
      float norm[2];
      row_norms(ssq_s, p.eps, p.eps_outside, norm);
      for_each_slot([&](int i, int r, int c) {
        const int rr = 64 * wg + r, gn = n0 + c;
        float g[2] = {lo_bf16(ct2[i]), hi_bf16(ct2[i])};  // 0 beyond M and N
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          g[e] *= mult[i / 2 * 2 + e];
          if (!((live[i / 16] >> (2 * (i % 16) + e)) & 1u)) g[e] = 0.f;
          g[e] = g[e] * (fabsf(acc[2 * i + e]) / norm[i % 2]);
        }
        if (kMode == kFused)  // slab gn / 64 of g
          *reinterpret_cast<__nv_bfloat162*>(g_s + (gn / 64) * R * 128 + swizzled(rr, gn % 64)) =
              __floats2bfloat162_rn(g[0], g[1]);
        else
          stage_pair(staging, r, c, g[0], g[1]);
      });
      if (kMode == kWriteG) store_staged(&tm_out, staging, n0, row0 + 64 * wg, p.N);
    }
    if (kMode == kFused) {  // g's generic stores before wgmma's async-proxy reads
      hopper::fence_proxy_async();
      hopper::named_bar_sync(1 + wg, 128);
    }

    // ---- phase 2: dx = g @ wt, one dx-chain at a time
    for (int k0 = sp.k_begin; k0 < sp.k_end; k0 += kChunk) {
      mma_chain<1>(acc, ring, n_tiles, kMode == kFused ? g_s : nullptr, R * 128, nullptr);
      staging_wait();
      hopper::named_bar_sync(1 + wg, 128);
      for_each_pair(acc, [&](int r, int c, float v0, float v1) { stage_pair(staging, r, c, v0, v1); });
      store_staged(&tm_out, staging, k0, row0 + 64 * wg, p.K);
    }
  }
  staging_wait();  // shared memory stays until the last store has read it
}

template <int kMode>
int launch_mode(const CUtensorMap& tm_a, const CUtensorMap& tm_w, const CUtensorMap& tm_out,
                const CUtensorMap& tm_ct, const CUtensorMap& tm_act, const BwdArgs& p,
                int tiles, int extra, cudaStream_t s) {
  static const cudaError_t attr = cudaFuncSetAttribute(
      conv1x1_bwd_wgmma<kMode>, cudaFuncAttributeMaxDynamicSharedMemorySize, engine::kSmemLimit);
  if (attr != cudaSuccess) return (int)attr;
  if (p.stages == 0) return (int)cudaErrorInvalidValue;
  const int threads = engine::block_threads(p.rows);
  const int smem = engine::Smem{p.rows, p.stages, extra, p.outs}.bytes();
  const dim3 grid(engine::persistent_blocks(conv1x1_bwd_wgmma<kMode>, threads, smem, tiles));
  conv1x1_bwd_wgmma<kMode><<<grid, threads, smem, s>>>(tm_a, tm_w, tm_out, tm_ct, tm_act, p);
  return (int)cudaGetLastError();
}

int launch_bf16(const void* x, const void* wt, const void* ct, const void* a, const void* mult,
                void* dx, void* g, int M, int K, int N, float eps, int eps_outside, int relu,
                cudaStream_t s) {
  CUtensorMap tm_x, tm_w, tm_dx, tm_ct{}, tm_act{};
  int err = hopper::encode_tile_map(&tm_x, x, M, K, K);
  if (err == 0) err = hopper::encode_tile_map(&tm_w, wt, N, K, K);
  if (err == 0) err = hopper::encode_tile_map(&tm_dx, dx, M, K, K);
  if (err != 0) return err;
  const auto aligned = [](const void* q, int n) { return reinterpret_cast<uintptr_t>(q) % n == 0; };
  BwdArgs p{static_cast<const bf16*>(ct), static_cast<const bf16*>(a),
            static_cast<const float*>(mult), M, K, N, 64, 0, 1, eps, eps_outside, relu,
            N % 2 == 0 && aligned(ct, 4) && (a == nullptr || aligned(a, 4)), 0, 0};
  if (N <= kFusedMaxCout) {
    // ct, and a with relu, come by TMA where their rows are whole 16-byte
    // units. 64 rows, two blocks per SM, where g is small; 128 rows (two
    // warpgroups sharing the wt tiles) up to Cout 512 on a large M where
    // they fit; else 64.
    p.tma_ct = N % 8 == 0 && aligned(ct, 16) && hopper::encode_tile_map(&tm_ct, ct, M, N, N) == 0;
    p.tma_a = p.tma_ct && relu && aligned(a, 16) &&
              hopper::encode_tile_map(&tm_act, a, M, N, N) == 0;
    p.outs = p.tma_a ? 2 : 1;
    const bool small = N <= kSmallCout;
    const int budget = small ? engine::kSmemHalf : engine::kSmemLimit;
    const auto stages = [&](int rows) {
      return engine::fit_stages(engine::Smem{rows, 0, g_slab_bytes(rows, N), p.outs}, budget);
    };
    p.rows = (!small && N <= 512 && M >= kRows128MinM && stages(128) != 0) ? 128 : 64;
    p.stages = stages(p.rows);
    return launch_mode<kFused>(tm_x, tm_w, tm_dx, tm_ct, tm_act, p, (M + p.rows - 1) / p.rows,
                               g_slab_bytes(p.rows, N), s);
  }
  if (g == nullptr) return (int)cudaErrorInvalidValue;
  const int ld_g = (N + 7) / 8 * 8;  // the wrapper's scratch row stride
  CUtensorMap tm_g;
  err = hopper::encode_tile_map(&tm_g, g, M, N, ld_g);
  if (err != 0) return err;
  p.stages = engine::fit_stages(engine::Smem{64, 0, 0, 1}, engine::kSmemHalf);  // two per SM
  const int row_tiles = (M + 63) / 64;
  err = launch_mode<kWriteG>(tm_x, tm_w, tm_g, tm_ct, tm_act, p,
                             (N + engine::kChunk - 1) / engine::kChunk * row_tiles, 0, s);
  if (err != 0) return err;
  return launch_mode<kDxFromG>(tm_g, tm_w, tm_dx, tm_ct, tm_act, p,
                               (K + engine::kChunk - 1) / engine::kChunk * row_tiles, 0, s);
}

// fp32: scratch = [g: M x Np | wt hi, lo: 2 x N x K | their transposes
// [K, Np]: 2 x K x Np | the partial sums of split-K] floats, Np =
// round_up(N, 4); launch 1 runs in splits_g K splits, launch 2 in splits_dx.
int launch_f32(const float* x, const float* wt, const float* ct, const float* a,
               const float* mult, float* dx, float* scratch, int M, int K, int N, float eps,
               int eps_outside, int relu, int splits_g, int splits_dx, cudaStream_t s) {
  if (scratch == nullptr) return (int)cudaErrorInvalidValue;
  const int np = (N + 3) / 4 * 4;
  float* g = scratch;
  float* whi = g + (long long)M * np;
  float* wlo = whi + (long long)N * K;
  float* thi = wlo + (long long)N * K;
  float* tlo = thi + (long long)K * np;
  int err = tf32::launch_split(wt, whi, wlo, thi, tlo, N, K, np, s);
  if (err != 0) return err;
  const auto aligned = [](const void* q, int n) { return reinterpret_cast<uintptr_t>(q) % n == 0; };
  const int pairs = N % 2 == 0 && aligned(ct, 8) && (a == nullptr || aligned(a, 8));
  float* part = tlo + (long long)K * np;
  tf32::Args pg{g, ct, a, mult, M, K, N, np, eps, eps_outside, relu, 1, pairs};
  pg.splits = splits_g;
  err = tf32::launch<tf32::kGrad>(x, K, whi, wlo, K, pg, part, s);
  if (err != 0) return err;
  tf32::Args pd{dx, nullptr, nullptr, nullptr, M, N, K, K, 0.f, 0, 0, 1, 0};
  pd.splits = splits_dx;
  return tf32::launch<tf32::kStore>(g, np, thi, tlo, np, pd, part, s);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (Cin a multiple of 8 (bf16) or 4 (fp32),
// 16-byte aligned x, wt and dx). a may be null when relu == 0; mult may be
// null (taken as 1). g: scratch, 16-byte aligned: bf16, a bf16 [M,
// round_up(Cout, 8)] when Cout > 1024 (the split path), else unused; fp32,
// M round_up(Cout, 4) + 2 Cout Cin + 2 Cin round_up(Cout, 4) floats and the
// larger split-K region of the two launches (see launch_f32). splits_g,
// splits_dx: fp32 only, the K splits of the g and dx GEMMs (1: none).
// Returns a CUDA error code (0 after a good launch).
extern "C" int bcos_conv1x1_bwd_explain(int dtype, const void* x, const void* wt,
                                        const void* ct, const void* a, const void* mult,
                                        void* dx, void* g, int M, int K, int N, float eps,
                                        int eps_outside, int relu, int splits_g, int splits_dx,
                                        void* stream) {
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  if (relu && a == nullptr) return (int)cudaErrorInvalidValue;
  if (dtype == 0)
    return launch_f32(static_cast<const float*>(x), static_cast<const float*>(wt),
                      static_cast<const float*>(ct), static_cast<const float*>(a),
                      static_cast<const float*>(mult), static_cast<float*>(dx),
                      static_cast<float*>(g), M, K, N, eps, eps_outside, relu, splits_g,
                      splits_dx, s);
  if (dtype == 1)
    return launch_bf16(x, wt, ct, a, mult, dx, g, M, K, N, eps, eps_outside, relu, s);
  return (int)cudaErrorInvalidValue;
}
