#pragma once
// CPU stand-in for __nv_bfloat16 and __nv_bfloat162 (tests only):
// round-to-nearest-even.
#include <cstdint>
#include <cstring>
struct __nv_bfloat16 { uint16_t x; };
struct __nv_bfloat162 { __nv_bfloat16 x, y; };
inline float __bfloat162float(__nv_bfloat16 v) { uint32_t u = (uint32_t)v.x << 16; float f; std::memcpy(&f, &u, 4); return f; }
inline __nv_bfloat16 __float2bfloat16(float f) {
  uint32_t u; std::memcpy(&u, &f, 4);
  uint32_t r = u + 0x7FFF + ((u >> 16) & 1);  // round to nearest even (no NaN inputs here)
  return __nv_bfloat16{(uint16_t)(r >> 16)};
}
inline __nv_bfloat162 __floats2bfloat162_rn(float a, float b) { return {__float2bfloat16(a), __float2bfloat16(b)}; }
inline float2 __bfloat1622float2(__nv_bfloat162 v) { return {__bfloat162float(v.x), __bfloat162float(v.y)}; }
