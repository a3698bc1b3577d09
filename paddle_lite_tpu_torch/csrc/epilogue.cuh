// Fused int8 epilogue shared by the GEMM and depthwise kernels.
//
// y = acc * scale[c]; y = y + bias[c]; y = act(y); then either fp32 out or
// int8 clip(rint(y * inv_out_scale), -127, 127).
//
// The reference rounds acc*scale and +bias separately (two fp32 roundings),
// so these sources are compiled with --fmad=false: an FMA would round once
// and can flip a requant tie.  rintf / __float2int_rn round half to even,
// as jnp.round does; roundf would round half away from zero.
#pragma once

#include <stdint.h>

namespace plt {

enum Act : int { ACT_NONE = 0, ACT_RELU = 1, ACT_RELU6 = 2 };

__device__ __forceinline__ float apply_act(float y, int act) {
  if (act == ACT_RELU) return fmaxf(y, 0.0f);
  if (act == ACT_RELU6) return fminf(fmaxf(y, 0.0f), 6.0f);
  return y;
}

__device__ __forceinline__ int8_t requant(float y, float inv_out_scale) {
  float q = rintf(y * inv_out_scale);
  q = fminf(fmaxf(q, -127.0f), 127.0f);
  return static_cast<int8_t>(static_cast<int>(q));
}

template <bool HAS_BIAS>
__device__ __forceinline__ float scale_bias_act(float acc, const float* scale,
                                                const float* bias, int c,
                                                int act) {
  float y = acc * scale[c];
  if (HAS_BIAS) y = y + bias[c];
  return apply_act(y, act);
}

}  // namespace plt
