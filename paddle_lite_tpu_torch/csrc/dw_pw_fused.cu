// Fused int8 depthwise 3x3 / stride 1 + pointwise 1x1 block.
//
// Replaces the Pallas kernel `_kernel` of
// paddle_lite_tpu/ops/kernels/dw_pw_fused.py (driven by `_fused_impl`):
//   d[n,h,w,c] = requant(dw_epilogue(sum_{i,j} x[n,h+i-1,w+j-1,c] * wd[i,j,c]))
//   out[n,h,w,o] = pw_epilogue(sum_c d[n,h,w,c] * wp[c,o])
// with SAME padding, x (N, H, W, C) int8, wd (3, 3, 1, C) int8 and the
// pointwise weights repacked as (O, C), K contiguous, as int8_gemm.cu reads
// them.  The int8 intermediate d never reaches device memory.
//
// Design: one block of 256 threads per (image, band of R output rows,
// strip of TW output columns).
//  1. The (R+2) x (TW+2) x C int8 halo slab goes to shared memory, zeros
//     outside the image (16-byte copies when C % 16 == 0, bytes otherwise).
//     The TPU kernel builds its halo in VMEM too.
//  2. The stencil runs in fp32 FMAs, as in the TPU kernel and dw_conv.cu:
//     int8 products and at most 9 of them stay below 2^24, so the sum is the
//     exact integer.  Each thread keeps a group of 4 channels, with their
//     36 weights, scales and biases in registers, and walks the block's
//     pixels; the dw epilogue and its requant (epilogue.cuh) write an int8
//     (R*TW) x C tile to shared memory, K-contiguous, padded to a depth of
//     32 with zeros.
//  3. The tile runs through mma.sync s8 x s8 -> s32 (mma_s8.cuh) against
//     the pointwise weights, BO output channels at a time, each warp a 32x32
//     sub-tile; the pw epilogue runs on the accumulators in registers and
//     writes the (R*TW) x O output once, two neighbouring channels a store.
//     A lane's output rows are located once per sub-tile and its columns'
//     scales and biases loaded once.  (The first version reloaded the
//     per-channel constants for every pixel and element and divided by TW
//     for every element; it took about twice as long.)
// The arithmetic is that of dw_conv.cu followed by int8_gemm.cu, so the
// block's output equals the unfused pair's bit for bit.  R and TW come
// from the shared-memory budget (three blocks an SM, which the 80
// registers a thread also allow); rows and columns past the image are
// computed on zeros and not stored.
//
// What bounds it on an H100: bytes.  At MobileNetV1's fused blocks (b64,
// 112x112x32 -> 64 and 56x56x128 -> 128) it must read the input once and
// write the output once (77 MB and 51 MB), against 0.23 G / 0.23 G fp32 FMAs
// and 3.3 G / 6.6 G int8 tensor-core operations.  This first version keeps
// one stage in flight (load, sync, compute) and its stores are 2 bytes wide
// and scattered over 8 rows a warp; a pipelined slab load and coalesced
// stores through shared memory are the next steps.
#include <cuda_runtime.h>
#include <stdint.h>

#include "epilogue.cuh"
#include "mma_s8.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int BO = 128;  // pointwise output channels per pass over the tile
constexpr int PAD = 16;  // bytes added to each K-contiguous shared row
constexpr int MAX_TW = 128;
constexpr int MAX_R = 16;
constexpr size_t BUDGET = 74 * 1024;  // shared bytes: three blocks an SM
constexpr size_t SMEM_MAX = 232448;    // what one block may take on sm_90

__host__ __device__ inline size_t up(size_t v, size_t m) {
  return (v + m - 1) / m * m;
}

// Shared-memory carve-up for a band of R rows by a strip of TW columns.
struct Layout {
  int cs;    // bytes per slab pixel: C rounded up to 4
  int kp;    // GEMM depth: C rounded up to 32
  int lda;   // tile / weight row stride: kp + PAD
  int rows;  // tile rows: R*TW rounded up to 32
  size_t slab, wdw, tile, wpw;

  __host__ __device__ Layout(int R, int TW, int C) {
    cs = (int)up(C, 4);
    kp = (int)up(C, 32);
    lda = kp + PAD;
    rows = (int)up((size_t)R * TW, 32);
    slab = up((size_t)(R + 2) * (TW + 2) * cs, 16);
    wdw = (size_t)9 * kp * sizeof(float);
    tile = (size_t)rows * lda;
    wpw = (size_t)BO * lda;
  }
  __host__ __device__ size_t total() const { return slab + wdw + tile + wpw; }
};

template <bool VEC, bool OUT_I8, bool EVEN_O>
__global__ void __launch_bounds__(THREADS)
dw_pw_fused_kernel(const int8_t* __restrict__ x, const int8_t* __restrict__ wd,
                   const float* __restrict__ dw_scale,
                   const float* __restrict__ dw_bias, plt::ActParams dw_act,
                   float inv_dw, const int8_t* __restrict__ wp,
                   const float* __restrict__ pw_scale,
                   const float* __restrict__ pw_bias, plt::ActParams pw_act,
                   float inv_out, void* __restrict__ out, int H, int W, int C,
                   int O, int R, int TW) {
  extern __shared__ __align__(16) int8_t smem[];
  const Layout L(R, TW, C);
  int8_t* slab = smem;
  float* wdw = reinterpret_cast<float*>(smem + L.slab);
  int8_t* tile = smem + L.slab + L.wdw;
  int8_t* wpw = tile + L.tile;

  const int tid = threadIdx.x;
  const int n = blockIdx.z, h0 = blockIdx.y * R, w0 = blockIdx.x * TW;
  const int rv = min(R, H - h0), wv = min(TW, W - w0);  // in the image
  const int SW = TW + 2;

  // 1. the halo slab and the depthwise weights (as fp32, zero past C)
  if (VEC) {  // C % 16 == 0, so cs == C
    const int cpp = C / 16;
    const int total = (R + 2) * SW * cpp;
    for (int i = tid; i < total; i += THREADS) {
      const int ch = i % cpp, p = i / cpp;
      const int ih = h0 - 1 + p / SW, iw = w0 - 1 + p % SW;
      int4 v = make_int4(0, 0, 0, 0);
      if (ih >= 0 && ih < H && iw >= 0 && iw < W)
        v = *reinterpret_cast<const int4*>(
            x + (((size_t)n * H + ih) * W + iw) * C + ch * 16);
      *reinterpret_cast<int4*>(slab + (size_t)p * C + ch * 16) = v;
    }
  } else {
    const int total = (R + 2) * SW * L.cs;
    for (int i = tid; i < total; i += THREADS) {
      const int c = i % L.cs, p = i / L.cs;
      const int ih = h0 - 1 + p / SW, iw = w0 - 1 + p % SW;
      int8_t v = 0;
      if (c < C && ih >= 0 && ih < H && iw >= 0 && iw < W)
        v = x[(((size_t)n * H + ih) * W + iw) * C + c];
      slab[i] = v;
    }
  }
  for (int i = tid; i < 9 * L.kp; i += THREADS) {
    const int c = i % L.kp;
    wdw[i] = c < C ? static_cast<float>(wd[(i / L.kp) * C + c]) : 0.0f;
  }
  __syncthreads();

  // 2. stencil, dw epilogue and requant into the int8 tile (row p = r*TW+wl).
  // Each thread keeps one group of 4 channels and walks rows p0, p0+pstep..
  const int groups = L.kp / 4, pstep = THREADS / groups;
  if (tid < pstep * groups) {
    const int c0 = (tid % groups) * 4;
    // this thread's channels: weights, scales and biases held in registers
    float wk[9][4], sc[4], bi[4];
#pragma unroll
    for (int t = 0; t < 9; ++t) {
      const float4 v = *reinterpret_cast<const float4*>(wdw + t * L.kp + c0);
      wk[t][0] = v.x; wk[t][1] = v.y; wk[t][2] = v.z; wk[t][3] = v.w;
    }
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int c = min(c0 + k, C - 1);  // lanes past C are dropped below
      sc[k] = dw_scale[c];
      bi[k] = dw_bias ? dw_bias[c] : 0.0f;
    }
    int p = tid / groups, r = p / TW, wl = p % TW;
    for (; p < L.rows; p += pstep) {
      int8_t q[4] = {0, 0, 0, 0};
      if (c0 < C && r < R) {
        float acc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
        for (int ki = 0; ki < 3; ++ki) {
#pragma unroll
          for (int kj = 0; kj < 3; ++kj) {
            const char4 xv = *reinterpret_cast<const char4*>(
                slab + ((r + ki) * SW + wl + kj) * L.cs + c0);
            const float* w4 = wk[ki * 3 + kj];
            acc[0] = __fmaf_rn(static_cast<float>(xv.x), w4[0], acc[0]);
            acc[1] = __fmaf_rn(static_cast<float>(xv.y), w4[1], acc[1]);
            acc[2] = __fmaf_rn(static_cast<float>(xv.z), w4[2], acc[2]);
            acc[3] = __fmaf_rn(static_cast<float>(xv.w), w4[3], acc[3]);
          }
        }
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const float y = plt::scale_bias_act(acc[k], sc[k], bi[k], dw_bias != nullptr, dw_act);
          q[k] = c0 + k < C ? plt::requant(y, inv_dw) : 0;
        }
      }
      *reinterpret_cast<char4*>(tile + (size_t)p * L.lda + c0) =
          make_char4(q[0], q[1], q[2], q[3]);
      for (wl += pstep; wl >= TW; wl -= TW) ++r;
    }
  }

  // 3. the pointwise GEMM, BO output channels at a time
  const int warp = tid >> 5, lane = tid & 31;
  const int mtiles = L.rows / 32;
  for (int o0 = 0; o0 < O; o0 += BO) {
    __syncthreads();  // the tile is written; the previous chunk is done
    if (VEC) {
      const int cpr = L.kp / 16;  // 16-byte chunks a weight row
      for (int i = tid; i < BO * cpr; i += THREADS) {
        const int o = i / cpr, c = (i % cpr) * 16;
        int4 v = make_int4(0, 0, 0, 0);
        if (o0 + o < O && c < C)
          v = *reinterpret_cast<const int4*>(wp + (size_t)(o0 + o) * C + c);
        *reinterpret_cast<int4*>(wpw + (size_t)o * L.lda + c) = v;
      }
    } else {
      for (int i = tid; i < BO * L.kp; i += THREADS) {
        const int o = i / L.kp, c = i % L.kp;
        wpw[(size_t)o * L.lda + c] =
            (o0 + o < O && c < C) ? wp[(size_t)(o0 + o) * C + c] : 0;
      }
    }
    __syncthreads();
    const int ntiles = (min(BO, O - o0) + 31) / 32;
    for (int t = warp; t < mtiles * ntiles; t += THREADS / 32) {
      const int mt = t / ntiles, nt = t % ntiles;
      int acc[2][4][4];
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[i][j][e] = 0;
      plt::warp_mma_32x32(acc, tile + (size_t)mt * 32 * L.lda, L.lda,
                          wpw + (size_t)nt * 32 * L.lda, L.lda, L.kp, lane);
      // lane's rows: g and g + 8 of each m16 tile, located once; its
      // columns 2t, 2t + 1 of each n8 tile, with their scales and biases
      size_t row[2][2];
      bool ok[2][2];
#pragma unroll
      for (int mi = 0; mi < 2; ++mi) {
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          const int p = mt * 32 + mi * 16 + plt::acc_row(lane, 2 * hf);
          const int r = p / TW, wl = p - r * TW;
          ok[mi][hf] = r < rv && wl < wv;
          row[mi][hf] = (((size_t)n * H + h0 + r) * W + w0 + wl) * O;
        }
      }
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) {
        const int o = o0 + nt * 32 + ni * 8 + plt::acc_col(lane, 0);
        if (o >= O) continue;
        float sc[2], bi[2];
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int oj = min(o + j, O - 1);  // a column past O is dropped
          sc[j] = pw_scale[oj];
          bi[j] = pw_bias ? pw_bias[oj] : 0.0f;
        }
#pragma unroll
        for (int mi = 0; mi < 2; ++mi) {
#pragma unroll
          for (int hf = 0; hf < 2; ++hf) {
            if (!ok[mi][hf]) continue;
            float y[2];
#pragma unroll
            for (int j = 0; j < 2; ++j)
              y[j] = plt::scale_bias_act(static_cast<float>(acc[mi][ni][2 * hf + j]),
                                         sc[j], bi[j], pw_bias != nullptr, pw_act);
            if (OUT_I8) {
              int8_t* dst = static_cast<int8_t*>(out) + row[mi][hf] + o;
              const int8_t q0 = plt::requant(y[0], inv_out);
              if (EVEN_O) {  // o is even, so the pair is 2-byte aligned
                const int8_t q1 = plt::requant(y[1], inv_out);
                *reinterpret_cast<char2*>(dst) = make_char2(q0, q1);
              } else {
                dst[0] = q0;
                if (o + 1 < O) dst[1] = plt::requant(y[1], inv_out);
              }
            } else {
              float* dst = static_cast<float*>(out) + row[mi][hf] + o;
              if (EVEN_O) {
                *reinterpret_cast<float2*>(dst) = make_float2(y[0], y[1]);
              } else {
                dst[0] = y[0];
                if (o + 1 < O) dst[1] = y[1];
              }
            }
          }
        }
      }
    }
  }
}

template <bool VEC, bool OUT_I8, bool EVEN_O>
int launch(const int8_t* x, const int8_t* wd, const float* ds, const float* db,
           plt::ActParams da, float inv_dw, const int8_t* wp, const float* ps,
           const float* pb, plt::ActParams pa, float inv_out, void* out,
           int N, int H, int W, int C, int O, int R, int TW, size_t smem,
           cudaStream_t s) {
  static const cudaError_t attr = cudaFuncSetAttribute(
      dw_pw_fused_kernel<VEC, OUT_I8, EVEN_O>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)SMEM_MAX);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  dim3 grid((W + TW - 1) / TW, (H + R - 1) / R, N);
  dw_pw_fused_kernel<VEC, OUT_I8, EVEN_O><<<grid, THREADS, smem, s>>>(
      x, wd, ds, db, da, inv_dw, wp, ps, pb, pa, inv_out, out, H, W, C, O, R,
      TW);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The band and strip a launch uses: TW = min(W, 128); R the largest band
// of at most 16 rows within the three-blocks-an-SM budget, preferring one
// that divides H.  Writes R, TW and the shared bytes; returns 0, or 1
// (cudaErrorInvalidValue) when not even one row fits in a block or C is
// past 1024.
extern "C" int plt_dw_pw_fused_tiling(int H, int W, int C, int* R, int* TW,
                                      long long* smem) {
  const int tw = W < MAX_TW ? W : MAX_TW;
  if (up(C, 32) / 4 > (size_t)THREADS)  // the stencil gives each thread 4 channels
    return static_cast<int>(cudaErrorInvalidValue);
  int best = 0;
  for (int r = (H < MAX_R ? H : MAX_R); r >= 1; --r) {
    if (Layout(r, tw, C).total() > BUDGET) continue;
    if (best == 0) best = r;
    if (H % r == 0) {
      best = r;
      break;
    }
  }
  if (best == 0 && Layout(1, tw, C).total() <= SMEM_MAX) best = 1;
  if (best == 0) return static_cast<int>(cudaErrorInvalidValue);
  *R = best;
  *TW = tw;
  *smem = (long long)Layout(best, tw, C).total();
  return 0;
}

// C interface, bound with ctypes.  Device pointers; `dw_bias` and `pw_bias`
// may be null; `pw_w` is (O, C).  Each activation is a plt::Act code and its
// parameters p0..p2 (epilogue.cuh).  `inv_dw` = fp32(1/dw_out_scale) and
// `inv_out` = fp32(1/out_scale), each taken in double by the caller.
// `vec` selects 16-byte loads (the caller checks C % 16 == 0 and 16-byte
// alignment of x and pw_w).  Returns cudaGetLastError() after the launch,
// or the error of plt_dw_pw_fused_tiling.
extern "C" int plt_dw_pw_fused(const void* x, const void* dw_w,
                               const void* dw_scale, const void* dw_bias,
                               int dw_act, float d0, float d1, float d2,
                               float inv_dw, const void* pw_w,
                               const void* pw_scale, const void* pw_bias,
                               int pw_act, float p0, float p1, float p2,
                               int out_i8, float inv_out, void* out, int N,
                               int H, int W, int C, int O, int vec,
                               void* stream) {
  if ((long long)N * H * W * O == 0) return static_cast<int>(cudaGetLastError());
  int R = 0, TW = 0;
  long long smem = 0;
  const int rc = plt_dw_pw_fused_tiling(H, W, C, &R, &TW, &smem);
  if (rc != 0) return rc;
  const int8_t* xp = static_cast<const int8_t*>(x);
  const int8_t* wd = static_cast<const int8_t*>(dw_w);
  const int8_t* wp = static_cast<const int8_t*>(pw_w);
  const float* ds = static_cast<const float*>(dw_scale);
  const float* db = static_cast<const float*>(dw_bias);
  const float* ps = static_cast<const float*>(pw_scale);
  const float* pb = static_cast<const float*>(pw_bias);
  const plt::ActParams da{dw_act, d0, d1, d2}, pa{pw_act, p0, p1, p2};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define PLT_FUSED(V, O8, E)                                                \
  launch<V, O8, E>(xp, wd, ds, db, da, inv_dw, wp, ps, pb, pa, inv_out, out, \
                   N, H, W, C, O, R, TW, (size_t)smem, s)
  if (O % 2 == 0) {
    if (vec) return out_i8 ? PLT_FUSED(true, true, true) : PLT_FUSED(true, false, true);
    return out_i8 ? PLT_FUSED(false, true, true) : PLT_FUSED(false, false, true);
  }
  if (vec) return out_i8 ? PLT_FUSED(true, true, false) : PLT_FUSED(true, false, false);
  return out_i8 ? PLT_FUSED(false, true, false) : PLT_FUSED(false, false, false);
#undef PLT_FUSED
}
