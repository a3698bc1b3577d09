// The int8 GEMM's gathering launches: a group-1, dilation-1 conv of an
// unpadded NHWC int8 input x by an (OC, kh·kw·C) weight Bt, as the GEMM over
// the conv's (N·OH·OW, kh·kw·C) im2col rows in (i, j, c) order, which are
// never made: the kernel's slabs read them from x (copy_slab_conv,
// int8_gemm.cuh), with the epilogue of the dense launches
// (int8_gemm.cu's header note).  A library of its own, built beside
// int8_gemm.cu's by its own nvcc, so that neither build's critical path
// carries the other's instantiations: fp32 and int8 outputs, no residual,
// every tile width, one and two warpgroups.
#include "int8_gemm.cuh"

namespace {

#define PLT_GEMM_CONV_KIND(FN, WGS, ...)                                       \
  switch (out_kind) {                                                          \
    case OUT_F32: PLT_GEMM_BN(FN, WGS, OUT_F32, false, true, __VA_ARGS__)      \
    case OUT_I8: PLT_GEMM_BN(FN, WGS, OUT_I8, false, true, __VA_ARGS__)        \
    default: return cudaErrorInvalidValue;                                     \
  }
#define PLT_GEMM_CONV_DISPATCH(FN, ...)                      \
  if (wgs == 1) { PLT_GEMM_CONV_KIND(FN, 1, __VA_ARGS__) }   \
  if (wgs == 2) { PLT_GEMM_CONV_KIND(FN, 2, __VA_ARGS__) }   \
  return cudaErrorInvalidValue;

cudaError_t dispatch(int bn, int wgs, int out_kind, const int8_t* x, const int8_t* Bt,
                     const float* scale, const float* bias, void* out, int M, int N,
                     int K, int bk, int width, int out_width, int smem, int blocks,
                     plt::ActParams act, float inv, const ConvGeom& geom,
                     cudaStream_t s) {
  PLT_GEMM_CONV_DISPATCH(launch, x, Bt, scale, bias, out, M, N, K, bk, width, out_width,
                         smem, blocks, act, inv, nullptr, 0.0f, 0, geom, s)
}

cudaError_t prepare_one(int bn, int wgs, int out_kind) {
  PLT_GEMM_CONV_DISPATCH(allow_smem)
}

cudaError_t occupancy_one(int bn, int wgs, int out_kind, int smem, int* n) {
  PLT_GEMM_CONV_DISPATCH(occupancy, smem, n)
}

}  // namespace

// C interface, bound with ctypes; as plt_int8_gemm (int8_gemm.cu) with the
// conv in place of A's shape and no residual: x is the (n, h, w, c) int8
// input, kh x kw the window, sh, sw the strides and pt, pb, pl, pr the
// paddings (top, bottom, left, right) of a dilation-1 conv; Bt is (oc,
// kh·kw·c), out (n·oh·ow, oc).  out_kind is OUT_F32 or OUT_I8, and `width`
// must divide c (a piece never straddles two taps).  A conv or plan the
// kernel cannot take returns cudaErrorInvalidValue without launching.
extern "C" int plt_int8_gemm_conv(const void* x, const void* Bt, const void* scale,
                                  const void* bias, void* out, int n, int h, int w, int c,
                                  int kh, int kw, int sh, int sw, int pt, int pb, int pl,
                                  int pr, int oc, int act, float p0, float p1, float p2,
                                  int out_kind, float inv_out_scale, int bn, int bk, int wgs,
                                  int width, int out_width, int smem, int blocks,
                                  void* stream) {
  // FastDiv's numerators (a row or a column of a slab, past M or K by less
  // than a tile) and x's pixel index stay below 2^31
  const long long lim = (1LL << 31) - 256;
  if (n < 1 || h < 1 || w < 1 || c < 1 || kh < 1 || kw < 1 || sh < 1 || sw < 1 ||
      pt < 0 || pb < 0 || pl < 0 || pr < 0 || h + pt + pb < kh || w + pl + pr < kw ||
      (long long)n * h * w >= lim || (long long)kh * kw * c >= lim)
    return static_cast<int>(cudaErrorInvalidValue);
  const int oh = (h + pt + pb - kh) / sh + 1, ow = (w + pl + pr - kw) / sw + 1;
  const long long m = (long long)n * oh * ow;
  if (m >= lim || (out_kind != OUT_F32 && out_kind != OUT_I8) ||
      width < 2 || c % width != 0 ||
      !plan_ok(x, Bt, out, nullptr, (int)m, oc, kh * kw * c, out_kind, bn, bk, wgs, width,
               out_width, smem, blocks))
    return static_cast<int>(cudaErrorInvalidValue);
  const ConvGeom geom{h, w, c, kw, oh, ow, sh, sw, pt, pl,
                      fast_div(c), fast_div(kw), fast_div(ow), fast_div(oh)};
  const cudaError_t rc = dispatch(
      bn, wgs, out_kind, static_cast<const int8_t*>(x), static_cast<const int8_t*>(Bt),
      static_cast<const float*>(scale), static_cast<const float*>(bias), out, (int)m, oc,
      kh * kw * c, bk, width, out_width, smem, blocks, plt::ActParams{act, p0, p1, p2},
      inv_out_scale, geom, static_cast<cudaStream_t>(stream));
  if (rc != cudaSuccess) return static_cast<int>(rc);
  return static_cast<int>(cudaGetLastError());
}

// Blocks of one gathering instantiation that an SM of the current device
// holds at `smem` shared bytes a block.
extern "C" int plt_int8_gemm_conv_occupancy(int bn, int wgs, int out_kind, int smem,
                                            int* blocks_per_sm) {
  return static_cast<int>(occupancy_one(bn, wgs, out_kind, smem, blocks_per_sm));
}

// The shared-memory limit of every gathering instantiation, for the
// current device: run once per device before its first launch.
extern "C" int plt_int8_gemm_conv_prepare() {
  const int bns[] = {8, 16, 32, 64, 128, 256};
  for (int wgs = 1; wgs <= 2; ++wgs)
    for (int out_kind = OUT_F32; out_kind <= OUT_I8; ++out_kind)
      for (int bn : bns) {
        const cudaError_t rc = prepare_one(bn, wgs, out_kind);
        if (rc != cudaSuccess) return static_cast<int>(rc);
      }
  return 0;
}
