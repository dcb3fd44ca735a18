// CPU stand-in for csrc/hopper.cuh (tests only): the same functions in C++,
// with the meaning the PTX gives them, so that a mistake in a descriptor, a
// swizzle, a box coordinate or a barrier phase fails on the CPU.
// - TMA: a synchronous copy of one box (64 rows of 128 bytes: 64 bf16 or 32
//   f32 columns, as the map's element size says) into shared memory with
//   the 128-byte swizzle (taken from the absolute shared address, as the
//   hardware does), zeros outside the matrix, then its bytes completed on
//   the mbarrier; a store copies a box back, skipping what lies outside the
//   matrix. Boxes in shared memory must be 1024-byte aligned.
// - mbarriers: arrival count, transaction count and completed phases under
//   one mutex; a wait blocks until the phase of the given parity completes
//   and fails after 60 s (a phase bug hangs instead on the card).
// - wgmma m64n128k16: each thread computes its own 64 accumulators in the PTX
//   layout, reading A and B through the decoded descriptors (K-major, or
//   MN-major for B with the transpose bit), in f32.
// - wgmma m64n128k8 tf32: A from the registers of the whole warpgroup (each
//   thread publishes its fragment, in the PTX layout, then the warpgroup
//   meets), B K-major through the decoded descriptor; both read as the
//   tensor cores read tf32, the low 13 mantissa bits of each f32 dropped,
//   so a kernel that skipped the hi/lo split would lose accuracy here too;
//   each k8 step's sum is added to the accumulator rounding toward zero, as
//   the tensor cores add (a long chain in one accumulator drifts here too).
//   tf32_rna rounds to nearest, ties away from zero, as cvt.rna does.
// - fences and commit/wait (wgmma and bulk groups): no-ops
//   (the copies and products are synchronous here).
#pragma once
#include <chrono>
#include <condition_variable>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <mutex>
#include <unordered_map>

struct CUtensorMap {
  const unsigned char* base;
  long long rows, cols, ld_bytes;
  int elem;  // bytes per element: 2 (bf16) or 4 (f32)
};

namespace hopper {

constexpr int kBox = 64;
constexpr int kBoxBytes = kBox * kBox * 2;

[[noreturn]] inline void emu_fail(const char* what) {
  std::fprintf(stderr, "cuda_emu hopper: %s\n", what);
  std::abort();
}

inline int encode_tile_map(CUtensorMap* map, const void* ptr, int rows, int cols, int ld,
                           int elem = 2) {
  if ((elem != 2 && elem != 4) || ((long long)ld * elem) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(ptr) % 16 != 0 || cols > ld)
    return 1;
  *map = {static_cast<const unsigned char*>(ptr), rows, cols, (long long)ld * elem, elem};
  return 0;
}

inline uint32_t smem_addr(const void* p) {
  const auto* c = static_cast<const unsigned char*>(p);
  if (c < g_dyn_smem || c >= g_dyn_smem + sizeof(g_dyn_smem)) emu_fail("not a shared-memory address");
  return (uint32_t)(c - g_dyn_smem);
}

inline uint32_t swizzle128(uint32_t addr) { return addr ^ (((addr >> 7) & 7) << 4); }

// ---- mbarriers
struct EmuMbar {
  int expected, pending;
  long long tx;
  unsigned completed;
};
inline std::mutex g_mbar_mutex;
inline std::condition_variable g_mbar_cv;
inline std::unordered_map<uint32_t, EmuMbar> g_mbars;

inline EmuMbar& mbar_locked(uint64_t* bar) {
  auto it = g_mbars.find(smem_addr(bar));
  if (it == g_mbars.end()) emu_fail("mbarrier used before mbar_init");
  return it->second;
}
inline void mbar_complete_locked(EmuMbar& b) {
  if (b.pending == 0 && b.tx == 0) {
    ++b.completed;
    b.pending = b.expected;
    g_mbar_cv.notify_all();
  }
}
inline void mbar_arrive_locked(EmuMbar& b) {
  if (--b.pending < 0) emu_fail("mbarrier: more arrivals than its count");
  mbar_complete_locked(b);
}

inline void mbar_init(uint64_t* bar, int count) {
  std::lock_guard<std::mutex> lock(g_mbar_mutex);
  g_mbars[smem_addr(bar)] = EmuMbar{count, count, 0, 0};
}
inline void fence_barrier_init() {}
inline void mbar_arrive_expect_tx(uint64_t* bar, uint32_t bytes) {
  std::lock_guard<std::mutex> lock(g_mbar_mutex);
  EmuMbar& b = mbar_locked(bar);
  b.tx += bytes;
  mbar_arrive_locked(b);
}
inline void mbar_arrive(uint64_t* bar) {
  std::lock_guard<std::mutex> lock(g_mbar_mutex);
  mbar_arrive_locked(mbar_locked(bar));
}
inline void mbar_wait(uint64_t* bar, uint32_t parity) {
  std::unique_lock<std::mutex> lock(g_mbar_mutex);
  if (!g_mbar_cv.wait_for(lock, std::chrono::seconds(60),
                          [&] { return (mbar_locked(bar).completed & 1) != parity; }))
    emu_fail("mbarrier wait timed out (a phase that never completes)");
}

// ---- TMA
inline void tma_load_2d(void* dst, const CUtensorMap* map, uint64_t* bar, int col, int row) {
  const uint32_t d = smem_addr(dst);
  if (d % 1024 != 0) emu_fail("TMA box destination not 1024-byte aligned (128-byte swizzle)");
  if (d + kBoxBytes > sizeof(g_dyn_smem)) emu_fail("TMA box beyond shared memory");
  const int e = map->elem;
  for (int r = 0; r < kBox; ++r)
    for (int c = 0; c < 128 / e; ++c) {
      const long long gr = (long long)row + r, gc = (long long)col + c;
      uint32_t v = 0;
      if (gr >= 0 && gr < map->rows && gc >= 0 && gc < map->cols)
        std::memcpy(&v, map->base + gr * map->ld_bytes + gc * e, e);
      std::memcpy(g_dyn_smem + swizzle128(d + r * 128 + c * e), &v, e);
    }
  std::lock_guard<std::mutex> lock(g_mbar_mutex);
  EmuMbar& b = mbar_locked(bar);
  b.tx -= kBoxBytes;
  mbar_complete_locked(b);
}

inline void tma_store_2d(const CUtensorMap* map, const void* src, int col, int row) {
  const uint32_t d = smem_addr(src);
  if (d % 1024 != 0) emu_fail("TMA box source not 1024-byte aligned (128-byte swizzle)");
  const int e = map->elem;
  for (int r = 0; r < kBox; ++r)
    for (int c = 0; c < 128 / e; ++c) {
      const long long gr = (long long)row + r, gc = (long long)col + c;
      if (gr < 0 || gr >= map->rows || gc < 0 || gc >= map->cols) continue;
      unsigned char* dst = const_cast<unsigned char*>(map->base) + gr * map->ld_bytes + gc * e;
      std::memcpy(dst, g_dyn_smem + swizzle128(d + r * 128 + c * e), e);
    }
}
inline void bulk_commit() {}
template <int N> inline void bulk_wait_read() {}

// ---- wgmma
inline uint64_t desc_sw128(const void* p, uint32_t lbo, uint32_t sbo) {
  return (uint64_t)((smem_addr(p) & 0x3FFFF) >> 4) | ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFF) << 32) | (1ull << 62);
}

// element (mn, k) of the operand a descriptor describes
inline float desc_elem(uint64_t desc, int mn, int k, bool mn_major) {
  if ((desc >> 62) != 1) emu_fail("wgmma descriptor: not the 128-byte swizzle");
  const uint32_t start = (uint32_t)(desc & 0x3FFF) << 4;
  const uint32_t lbo = (uint32_t)((desc >> 16) & 0x3FFF) << 4;
  const uint32_t sbo = (uint32_t)((desc >> 32) & 0x3FFF) << 4;
  const uint32_t addr = mn_major
      ? start + (mn / 64) * lbo + (k / 8) * sbo + (k % 8) * 128 + (mn % 64) * 2
      : start + (mn / 8) * sbo + (mn % 8) * 128 + k * 2;
  if (addr + 2 > sizeof(g_dyn_smem)) emu_fail("wgmma operand beyond shared memory");
  __nv_bfloat16 v;
  std::memcpy(&v, g_dyn_smem + swizzle128(addr), 2);
  return __bfloat162float(v);
}

inline void wgmma_fence() {}
inline void wgmma_commit() {}
template <int N> inline void wgmma_wait() {}
inline void fence_operand(float&) {}

template <int TransB>
inline void wgmma_m64n128k16(float (&d)[64], uint64_t desc_a, uint64_t desc_b, int scale_d) {
  const int t = threadIdx.x % 128;
  for (int q = 0; q < 64; ++q) {
    const int j = q / 4, h = (q / 2) % 2, c = q % 2;
    const int row = 16 * (t / 32) + (t % 32) / 4 + 8 * h, col = 8 * j + 2 * (t % 4) + c;
    float s = scale_d ? d[q] : 0.f;
    for (int k = 0; k < 16; ++k)
      s += desc_elem(desc_a, row, k, false) * desc_elem(desc_b, col, k, TransB != 0);
    d[q] = s;
  }
}

inline uint32_t tf32_rna(float x) {
  uint32_t b;
  std::memcpy(&b, &x, 4);
  if ((b & 0x7f800000u) != 0x7f800000u) b += 0x1000u;  // the magnitude, half away from zero
  return b & 0xffffe000u;
}

// an f32 as the tensor cores read it as tf32: the top 19 bits
inline float tf32_read(uint32_t b) {
  b &= 0xffffe000u;
  float f;
  std::memcpy(&f, &b, 4);
  return f;
}

inline uint32_t g_tf32_a[1024][4];  // each thread's A fragment during a tf32 wgmma

inline void wgmma_m64n128k8_tf32(float (&d)[64], const uint32_t (&a)[4], uint64_t desc_b,
                                 int scale_d) {
  if ((desc_b >> 62) != 1) emu_fail("wgmma descriptor: not the 128-byte swizzle");
  const uint32_t start = (uint32_t)(desc_b & 0x3FFF) << 4;
  const uint32_t sbo = (uint32_t)((desc_b >> 32) & 0x3FFF) << 4;
  const int t = threadIdx.x % 128, wg0 = threadIdx.x - t;
  std::memcpy(g_tf32_a[threadIdx.x], a, sizeof(a));
  emu_warpgroup_sync();
  for (int q = 0; q < 64; ++q) {
    const int j = q / 4, h = (q / 2) % 2, c = q % 2;
    const int row = 16 * (t / 32) + (t % 32) / 4 + 8 * h, col = 8 * j + 2 * (t % 4) + c;
    double s = 0.0;
    for (int k = 0; k < 8; ++k) {
      // A (row, k) lies in register (row % 16) / 8 + 2 (k / 4) of thread
      // 32 (row / 16) + 4 (row % 8) + k % 4
      const int holder = wg0 + 32 * (row / 16) + 4 * (row % 8) + k % 4;
      const float av = tf32_read(g_tf32_a[holder][(row % 16) / 8 + 2 * (k / 4)]);
      const uint32_t addr = start + (col / 8) * sbo + (col % 8) * 128 + k * 4;
      if (addr + 4 > sizeof(g_dyn_smem)) emu_fail("wgmma operand beyond shared memory");
      uint32_t bb;
      std::memcpy(&bb, g_dyn_smem + swizzle128(addr), 4);
      s += (double)av * tf32_read(bb);
    }
    // the tensor cores add into the accumulator rounding toward zero
    const double exact = (scale_d ? d[q] : 0.0) + s;
    float r = (float)exact;
    if (std::fabs((double)r) > std::fabs(exact)) r = std::nextafter(r, 0.f);
    d[q] = r;
  }
  emu_warpgroup_sync();  // no thread republishes before all have read
}

inline void fence_proxy_async() {}
inline void named_bar_sync(int id, int count) { emu_named_bar_sync(id, count); }

}  // namespace hopper
