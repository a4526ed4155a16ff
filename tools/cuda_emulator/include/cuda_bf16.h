// Host emulation of the bf16 type and conversions the kernels use.
#pragma once
#include "cuda_runtime.h"

struct __nv_bfloat16 {
  uint16_t x;
};
inline float __bfloat162float(__nv_bfloat16 h) {
  return __uint_as_float(static_cast<uint32_t>(h.x) << 16);
}
inline __nv_bfloat16 __float2bfloat16_rn(float f) {  // nearest even
  uint32_t u = __float_as_uint(f);
  u += 0x7fffu + ((u >> 16) & 1u);
  return {static_cast<uint16_t>(u >> 16)};
}
