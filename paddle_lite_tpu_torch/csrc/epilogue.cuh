// Fused int8 epilogue shared by the GEMM, depthwise and fused dw+pw kernels,
// and the conversion-free int8 / int32 -> float helpers and the index
// division they share.
//
// y = acc * scale[c]; y = y + bias[c]; y = act(y); then either fp32 out or
// int8 clip(rint(y * inv_out_scale), -127, 127).  The GEMM may add an int8
// residual before the activation: y = y + float(r) * s_r, r made float by
// to_f32x4 below, each step rounded on its own.
//
// The reference rounds acc*scale and +bias separately (two fp32 roundings),
// so these sources are compiled with --fmad=false: an FMA would round once
// and can flip a requant tie.  rintf / __float2int_rn round half to even,
// as jnp.round does; roundf would round half away from zero.
//
// The activations are those of paddle_lite_tpu/ops/common.py:36-98: each
// formula below is the reference's, operation for operation, with its
// parameters as fp32 (a Python float applied to an fp32 array is fp32 there
// too).  hard_swish divides with IEEE division (plain `/` without
// fast-math).  Codes 1-5 have no transcendental: their fp32 arithmetic is
// reproduced bit for bit.  Codes 6-8 (gelu in jax.nn.gelu's two forms,
// tanh; only the GEMM instantiates them) call tanhf / erfcf, never the
// __tanhf-style intrinsics: the result differs from PyTorch's only where
// the card's tanhf / erfcf and PyTorch's tanh / erfc differ.
#pragma once

#include <stdint.h>

namespace plt {

enum Act : int {
  ACT_NONE = 0,
  ACT_RELU = 1,
  ACT_RELU6 = 2,
  ACT_LEAKY_RELU = 3,    // p0 = alpha
  ACT_HARD_SWISH = 4,    // p0 = threshold, p1 = scale, p2 = offset
  ACT_HARD_SIGMOID = 5,  // p0 = slope, p1 = offset
  ACT_GELU_TANH = 6,     // p0 = sqrt(2/pi), p1 = 0.044715
  ACT_GELU_ERF = 7,      // p0 = sqrt(1/2)
  ACT_TANH = 8,
};

// Not a code the host passes: the GEMM's one instantiation for the three
// transcendental codes, which switches between them at run time
// (apply_transcendental); their time goes to tanhf / erfcf, not the switch.
constexpr int ACT_TRANSCENDENTAL = 100;

struct ActParams {
  int code;
  float p0, p1, p2;
};

// The activation fixed at compile time (the depthwise kernel instantiates
// one kernel per code); the runtime form below switches into these.
template <int ACT>
__device__ __forceinline__ float apply_act(float y, const ActParams& a) {
  if (ACT == ACT_RELU) return fmaxf(y, 0.0f);
  if (ACT == ACT_RELU6) return fminf(fmaxf(y, 0.0f), 6.0f);
  // where(y >= 0, y, alpha * y)
  if (ACT == ACT_LEAKY_RELU) return y >= 0.0f ? y : a.p0 * y;
  // y * clip(y + offset, 0, threshold) / scale
  if (ACT == ACT_HARD_SWISH) return y * fminf(fmaxf(y + a.p2, 0.0f), a.p0) / a.p1;
  // clip(slope * y + offset, 0, 1)
  if (ACT == ACT_HARD_SIGMOID) return fminf(fmaxf(a.p0 * y + a.p1, 0.0f), 1.0f);
  // y * (0.5 * (1 + tanh(c * (y + 0.044715 * ((y * y) * y)))))
  if (ACT == ACT_GELU_TANH)
    return y * (0.5f * (1.0f + tanhf(a.p0 * (y + a.p1 * ((y * y) * y)))));
  // (0.5 * y) * erfc(-y * sqrt(1/2))
  if (ACT == ACT_GELU_ERF) return (0.5f * y) * erfcf(-y * a.p0);
  if (ACT == ACT_TANH) return tanhf(y);
  return y;
}

__device__ __forceinline__ float apply_transcendental(float y, const ActParams& a) {
  switch (a.code) {
    case ACT_GELU_TANH: return apply_act<ACT_GELU_TANH>(y, a);
    case ACT_GELU_ERF: return apply_act<ACT_GELU_ERF>(y, a);
    default: return apply_act<ACT_TANH>(y, a);
  }
}

__device__ __forceinline__ float apply_act(float y, const ActParams& a) {
  switch (a.code) {
    case ACT_RELU: return apply_act<ACT_RELU>(y, a);
    case ACT_RELU6: return apply_act<ACT_RELU6>(y, a);
    case ACT_LEAKY_RELU: return apply_act<ACT_LEAKY_RELU>(y, a);
    case ACT_HARD_SWISH: return apply_act<ACT_HARD_SWISH>(y, a);
    case ACT_HARD_SIGMOID: return apply_act<ACT_HARD_SIGMOID>(y, a);
    default: return y;
  }
}

__device__ __forceinline__ int8_t requant(float y, float inv_out_scale) {
  float q = rintf(y * inv_out_scale);
  q = fminf(fmaxf(q, -127.0f), 127.0f);
  return static_cast<int8_t>(static_cast<int>(q));
}

// acc * scale (+ bias) -> act, with the channel's scale and bias in hand
__device__ __forceinline__ float scale_bias_act(float acc, float scale,
                                                float bias, bool has_bias,
                                                const ActParams& act) {
  float y = acc * scale;
  if (has_bias) y = y + bias;
  return apply_act(y, act);
}

template <bool HAS_BIAS>
__device__ __forceinline__ float scale_bias_act(float acc, const float* scale,
                                                const float* bias, int c,
                                                const ActParams& act) {
  return scale_bias_act(acc, scale[c], HAS_BIAS ? bias[c] : 0.0f, HAS_BIAS, act);
}

// The activation of y, for the depthwise and GEMM kernels.  hard_swish with
// FAST: its division n / p1 as q = n * rb with rb = 1/p1 (itself an IEEE
// quotient), then q + (n - p1*q) * rb, the remainder exact in one FMA: the
// correctly rounded quotient while n and p1 lie in [2^-60, 2^60]
// (Markstein); zero keeps its sign.  A dividend outside that range sets
// `bad`, and the caller redoes the unit without FAST.
template <int ACT, bool FAST>
__device__ __forceinline__ float act_value(float y, const plt::ActParams& a, float rb,
                                           bool& bad) {
  if constexpr (ACT == plt::ACT_HARD_SWISH && FAST) {
    const float n = y * fminf(fmaxf(y + a.p2, 0.0f), a.p0);
    const float q = n * rb;
    const uint32_t m = __float_as_uint(n) & 0x7fffffffu;
    bad |= m != 0u && m - 0x21800000u > 0x5D800000u - 0x21800000u;
    return m == 0u ? q : __fmaf_rn(__fmaf_rn(-q, a.p1, n), rb, q);
  }
  if constexpr (ACT == plt::ACT_TRANSCENDENTAL) return plt::apply_transcendental(y, a);
  return plt::apply_act<ACT>(y, a);
}

// plt::requant's int8 in the low byte: clip(rint(t)) == rint(clip(t)) for
// integer bounds, and t + 1.5 * 2^23 rounds t to an integer, half to even,
// with the integer's two's complement in the low byte of the sum's bits
__device__ __forceinline__ uint32_t requant_lo(float y, float inv) {
  const float t = fminf(fmaxf(y * inv, -127.0f), 127.0f);
  return __float_as_uint(t + 12582912.0f);
}

// four int8 in a word -> four exact floats: 0x4B0000xx is 2^23 + xx, and
// xx = b + 128 after flipping the sign bits
__device__ __forceinline__ void to_f32x4(uint32_t v, float f[4]) {
  v ^= 0x80808080u;
  f[0] = __int_as_float(__byte_perm(v, 0x4B000000u, 0x7540)) - 8388736.0f;
  f[1] = __int_as_float(__byte_perm(v, 0x4B000000u, 0x7541)) - 8388736.0f;
  f[2] = __int_as_float(__byte_perm(v, 0x4B000000u, 0x7542)) - 8388736.0f;
  f[3] = __int_as_float(__byte_perm(v, 0x4B000000u, 0x7543)) - 8388736.0f;
}

// int -> float without a conversion instruction (those run at a sixteenth
// of the FP32 rate on sm_90 and bound the epilogue of the streaming
// shapes), exact for a in [-SMALL_OFFSET, 2^23 - SMALL_OFFSET): the bits of
// 2^23 plus a + SMALL_OFFSET are the float 2^23 + a + SMALL_OFFSET (one ulp
// is 1 in that binade), and subtracting 2^23 + SMALL_OFFSET leaves a.  For
// K <= 256 every int8 x int8 accumulator lies in [-K * 128 * 127,
// K * 128 * 128] inside that window.  (tests/test_torch_gemm_plan.py checks
// it in float32, bit for bit.)
constexpr int SMALL_OFFSET = 256 * 128 * 127;

__device__ __forceinline__ float small_int_to_float(int a) {
  return __int_as_float(0x4B000000 + SMALL_OFFSET + a) - (8388608.0f + SMALL_OFFSET);
}

// a / d for a < 2^20 and d < 2^12 by a multiply: m = ceil(2^32 / d), exact
// while a * d < 2^32 (m = 0 stands for d = 1)
struct FastDiv {
  uint32_t d, m;
  __host__ __device__ explicit FastDiv(uint32_t d_ = 1)
      : d(d_), m(d_ == 1 ? 0u : (uint32_t)((0x100000000ull + d_ - 1) / d_)) {}
  __device__ __forceinline__ uint32_t div(uint32_t a) const {
    return m ? __umulhi(a, m) : a;
  }
};

}  // namespace plt
