// Host emulation of the bf16 type and conversions the kernels use
// (round to nearest even).
#pragma once
#include <cstdint>
#include <cstring>

struct __nv_bfloat16 {
  uint16_t x;
};
inline float __bfloat162float(__nv_bfloat16 h) {
  const uint32_t u = (uint32_t)h.x << 16;
  float f;
  std::memcpy(&f, &u, 4);
  return f;
}
inline __nv_bfloat16 __float2bfloat16(float f) {
  uint32_t u;
  std::memcpy(&u, &f, 4);
  u += 0x7FFFu + ((u >> 16) & 1u);
  return {(uint16_t)(u >> 16)};
}
