// int8 NHWC depthwise convolution with the fused int8 epilogue.
//
// Replaces the Pallas kernels `_dw_kernel_s1`, `_dw_kernel_s2` and
// `_dw_kernel` of paddle_lite_tpu/ops/kernels/depthwise.py:
//   out[n, oh, ow, c] = epilogue(sum_{i,j} x[n, oh*s - p + i, ow*s - p + j, c]
//                                           * w[i, j, c])
// for square k in {3, 5}, stride s in {1, 2}, SAME padding p = (k-1)/2 and
// channel multiplier 1.  x is (N, H, W, C) int8, w is (k, k, 1, C) int8.
//
// Design: one thread per (image, output row, run of P = 4 output columns,
// group of 4 channels).  Channels are the fastest index across threads, so
// a warp reads neighbouring 4-byte groups of one pixel row (one char4 load
// per pixel when C % 4 == 0, byte loads otherwise).  Per kernel row the
// thread loads the (P-1)*s + k input columns its P outputs need once and
// reuses them across the k taps.  Padding is bounds checks: no padded copy
// and no polyphase split (those were TPU layout choices).  The sum is taken
// in fp32 with explicit FMAs: int8 products and at most 25 of them stay
// below 2^24, so every partial sum is an exact integer, as in int32.
//
// What bounds it on an H100: at MobileNetV1's shapes the kernel reads each
// input byte about once and writes each output byte once, k*k FMAs per
// output element; the 112x112x32 layer at b64 needs ~51 MB (15 us at
// 3.35 TB/s) against 0.23 G FMAs (~7 us at the fp32 CUDA-core rate), so
// bytes bind and the design spends nothing on data reuse beyond the row
// run.
#include <cuda_runtime.h>
#include <stdint.h>

#include "epilogue.cuh"

namespace {

constexpr int P = 4;  // output columns per thread
constexpr int THREADS = 256;

template <bool VEC>
__device__ __forceinline__ void load4(const int8_t* p, int c0, int C,
                                      float v[4]) {
  if (VEC) {
    const char4 q = *reinterpret_cast<const char4*>(p + c0);
    v[0] = q.x; v[1] = q.y; v[2] = q.z; v[3] = q.w;
  } else {
#pragma unroll
    for (int c = 0; c < 4; ++c) v[c] = (c0 + c < C) ? float(p[c0 + c]) : 0.0f;
  }
}

template <int KS, int S, bool VEC, bool OUT_I8, bool HAS_BIAS>
__global__ void __launch_bounds__(THREADS)
dw_conv_kernel(const int8_t* __restrict__ x, const int8_t* __restrict__ w,
               const float* __restrict__ scale, const float* __restrict__ bias,
               void* __restrict__ out, int N, int H, int W, int C, int OH,
               int OW, plt::ActParams act,
               float inv_out_scale) {
  constexpr int PAD = (KS - 1) / 2;
  constexpr int SPAN = (P - 1) * S + KS;
  const int C4 = (C + 3) / 4;
  const int OWG = (OW + P - 1) / P;
  const long long total = (long long)N * OH * OWG * C4;
  const long long idx = (long long)blockIdx.x * THREADS + threadIdx.x;
  if (idx >= total) return;
  const int c0 = int(idx % C4) * 4;
  long long r = idx / C4;
  const int ow0 = int(r % OWG) * P;
  r /= OWG;
  const int oh = int(r % OH);
  const int n = int(r / OH);

  float acc[P][4];
#pragma unroll
  for (int p = 0; p < P; ++p)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[p][c] = 0.0f;

#pragma unroll
  for (int i = 0; i < KS; ++i) {
    const int ih = oh * S - PAD + i;
    if (ih < 0 || ih >= H) continue;
    const int8_t* xrow = x + (size_t)(n * H + ih) * W * C;
    float xv[SPAN][4];
#pragma unroll
    for (int j = 0; j < SPAN; ++j) {
      const int iw = ow0 * S - PAD + j;
      if (iw >= 0 && iw < W) {
        load4<VEC>(xrow + (size_t)iw * C, c0, C, xv[j]);
      } else {
#pragma unroll
        for (int c = 0; c < 4; ++c) xv[j][c] = 0.0f;
      }
    }
#pragma unroll
    for (int j = 0; j < KS; ++j) {
      float wv[4];
      load4<VEC>(w + (size_t)(i * KS + j) * C, c0, C, wv);
#pragma unroll
      for (int p = 0; p < P; ++p)
#pragma unroll
        for (int c = 0; c < 4; ++c)
          acc[p][c] = __fmaf_rn(xv[p * S + j][c], wv[c], acc[p][c]);
    }
  }

#pragma unroll
  for (int p = 0; p < P; ++p) {
    const int ow = ow0 + p;
    if (ow >= OW) break;
    const size_t o = ((size_t)(n * OH + oh) * OW + ow) * C + c0;
    float y[4];
#pragma unroll
    for (int c = 0; c < 4; ++c)
      y[c] = (VEC || c0 + c < C)
                 ? plt::scale_bias_act<HAS_BIAS>(acc[p][c], scale, bias,
                                                 c0 + c, act)
                 : 0.0f;
    if (OUT_I8) {
      int8_t* dst = static_cast<int8_t*>(out) + o;
      if (VEC) {
        char4 q;
        q.x = plt::requant(y[0], inv_out_scale);
        q.y = plt::requant(y[1], inv_out_scale);
        q.z = plt::requant(y[2], inv_out_scale);
        q.w = plt::requant(y[3], inv_out_scale);
        *reinterpret_cast<char4*>(dst) = q;
      } else {
        for (int c = 0; c < 4 && c0 + c < C; ++c)
          dst[c] = plt::requant(y[c], inv_out_scale);
      }
    } else {
      float* dst = static_cast<float*>(out) + o;
      if (VEC) {
        *reinterpret_cast<float4*>(dst) = make_float4(y[0], y[1], y[2], y[3]);
      } else {
        for (int c = 0; c < 4 && c0 + c < C; ++c) dst[c] = y[c];
      }
    }
  }
}

template <int KS, int S, bool VEC, bool OUT_I8, bool HAS_BIAS>
void launch(const int8_t* x, const int8_t* w, const float* sc, const float* bi,
            void* out, int N, int H, int W, int C, int OH, int OW,
            plt::ActParams act, float inv, cudaStream_t stream) {
  const long long total =
      (long long)N * OH * ((OW + P - 1) / P) * ((C + 3) / 4);
  const unsigned blocks = (unsigned)((total + THREADS - 1) / THREADS);
  dw_conv_kernel<KS, S, VEC, OUT_I8, HAS_BIAS><<<blocks, THREADS, 0, stream>>>(
      x, w, sc, bi, out, N, H, W, C, OH, OW, act, inv);
}

template <int KS, int S>
void dispatch(const int8_t* x, const int8_t* w, const float* sc,
              const float* bi, void* out, int N, int H, int W, int C, int OH,
              int OW, plt::ActParams act, int out_i8, float inv,
              cudaStream_t s) {
  const bool vec = (C % 4) == 0;
#define PLT_DW(V, O, B) \
  launch<KS, S, V, O, B>(x, w, sc, bi, out, N, H, W, C, OH, OW, act, inv, s)
  if (vec) {
    if (out_i8) { if (bi) PLT_DW(true, true, true); else PLT_DW(true, true, false); }
    else { if (bi) PLT_DW(true, false, true); else PLT_DW(true, false, false); }
  } else {
    if (out_i8) { if (bi) PLT_DW(false, true, true); else PLT_DW(false, true, false); }
    else { if (bi) PLT_DW(false, false, true); else PLT_DW(false, false, false); }
  }
#undef PLT_DW
}

}  // namespace

// C interface, bound with ctypes.  Device pointers; `bias` may be null.
// `act` is a plt::Act code and p0..p2 its parameters (epilogue.cuh).
// Returns cudaGetLastError() after the launch, or cudaErrorInvalidValue
// (1) for a kernel size or stride the kernel does not take.
extern "C" int plt_dw_conv(const void* x, const void* w, const void* scale,
                           const void* bias, void* out, int N, int H, int W,
                           int C, int OH, int OW, int k, int stride, int act,
                           float p0, float p1, float p2, int out_i8,
                           float inv_out_scale, void* stream) {
  const int8_t* xp = static_cast<const int8_t*>(x);
  const int8_t* wp = static_cast<const int8_t*>(w);
  const float* sc = static_cast<const float*>(scale);
  const float* bi = static_cast<const float*>(bias);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const plt::ActParams act_p{act, p0, p1, p2};
  if ((long long)N * OH * OW * C == 0) return static_cast<int>(cudaGetLastError());
  if (k == 3 && stride == 1)
    dispatch<3, 1>(xp, wp, sc, bi, out, N, H, W, C, OH, OW, act_p, out_i8, inv_out_scale, s);
  else if (k == 3 && stride == 2)
    dispatch<3, 2>(xp, wp, sc, bi, out, N, H, W, C, OH, OW, act_p, out_i8, inv_out_scale, s);
  else if (k == 5 && stride == 1)
    dispatch<5, 1>(xp, wp, sc, bi, out, N, H, W, C, OH, OW, act_p, out_i8, inv_out_scale, s);
  else if (k == 5 && stride == 2)
    dispatch<5, 2>(xp, wp, sc, bi, out, N, H, W, C, OH, OW, act_p, out_i8, inv_out_scale, s);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}
