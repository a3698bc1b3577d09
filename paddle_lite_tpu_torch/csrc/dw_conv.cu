// int8 NHWC depthwise convolution with the fused int8 epilogue.
//
// Replaces the Pallas kernels `_dw_kernel_s1`, `_dw_kernel_s2` and
// `_dw_kernel` of paddle_lite_tpu/ops/kernels/depthwise.py:
//   out[n, oh, ow, c] = epilogue(sum_{i,j} x[n, oh*s - p + i, ow*s - p + j, c]
//                                           * w[i, j, c])
// for square k in {3, 5}, stride s in {1, 2}, SAME padding p = (k-1)/2 and
// channel multiplier 1.  x is (N, H, W, C) int8, w is (k, k, 1, C) int8.
//
// What bounds it on an H100: at the paths' shapes the bytes (each input
// byte read once, each output byte written once; 3.35 TB/s) and k*k fp32
// FMAs an output element (the CUDA cores' rate) give bounds within a few
// times of each other; a kernel that reads every tap from global memory is
// bound by instructions and load latency instead.  This design reads each
// input byte from device memory about once, cuts the instructions an
// output takes, and hides the copies' latency behind compute:
//  1. Tiles.  A tile is `ipb` images x TH output rows x TW output columns x
//     CV channels (the plan, computed in Python by
//     ops/kernels/depthwise.plan and checked here).  Its input halo,
//     ((TH-1)*s+k) x ((TW-1)*s+k) x CV bytes an image, goes to shared memory
//     with cp.async: 16-byte copies when C % 16 == 0, 8 or 4 bytes when C is
//     a multiple of only those, bytes otherwise.  Padding is a zero fill
//     (source size 0, the source address the tensor's base), so no address
//     outside x is formed.  Layout [row][col][CV], a row's bytes rounded
//     up to the copy width (at least 4).
//     The tile's k*k x CV weights, scales and biases come with it.
//  2. A persistent grid, two buffers.  As many blocks as the SMs hold walk
//     the tiles; a block copies tile i+1 into one buffer while it computes
//     tile i from the other.
//  3. Each thread owns a fixed group of 4 channels of the tile: their k*k
//     weights, scales and biases sit in registers for the tile (36 + 8
//     floats for k = 3, 100 + 8 for k = 5).  It walks units of (image,
//     output row, run of P = 7 output columns): MobileNet's widths (112,
//     56, 28, 14, 7) are multiples of 7, so no lane idles at W = 7 or 14.
//     A unit reads each of its (P-1)*s+k input columns once a kernel row
//     and feeds every output that uses it.  Bytes become floats by a byte
//     permute into 2^23 + (b + 128) and one subtraction (exact), not by a
//     conversion instruction.  The sum is taken in fp32 with explicit FMAs:
//     int8 products and at most 25 of them stay below 2^24, so every
//     partial sum is an exact integer, as in int32.
//  4. The epilogue is epilogue.cuh's, with the activation a template
//     parameter (plt::apply_act<ACT>), except hard_swish's IEEE division by
//     its scale: a multiply by the reciprocal and one exact correction
//     (act_value), with the IEEE division redone for a unit whose dividends
//     leave the range where the two agree.  The requant clips y * (1/s) to
//     +-127 and rounds it by adding 1.5 * 2^23, whose sum's low byte is
//     rint's result as an int8 (round half to even, as rintf), without the
//     conversion unit.  int8 outputs are staged in shared memory and leave
//     in the plan's vector width (16 bytes where C % 16 == 0), coalesced
//     along the channel rows; fp32 outputs leave as float4 from registers.
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "epilogue.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int CHANNELS = 4;             // a thread's channels (to_f32x4, the stores)
constexpr int P = 7;                    // output columns a unit (a thread's run)
// hard_swish divides by the reciprocal, checked (act_value); false gives
// every activation plt::apply_act, IEEE division included.  Only
// paddle_lite_tpu_torch/tools/dw_plan_study.py builds it false, to time
// the difference.
constexpr bool CHECKED_DIVISION = true;
constexpr uint32_t IDX_MAX = 1u << 20;  // bound of FastDiv's numerators
// a card, as plt_dw_conv_prepare reads it on that device: SMs, shared bytes
// an SM has, one block may take (opt-in), and the runtime keeps for each
// block.  One entry a device index; sms == 0 until that device is prepared.
struct Card {
  int sms, smem_sm, smem_block, smem_reserved;
};
constexpr int MAX_DEVICES = 64;
Card g_cards[MAX_DEVICES] = {};

// The entry of the current device (the wrapper makes it the tensor's
// device), or null when the device is out of the table's range.
Card* current_card() {
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= MAX_DEVICES) return nullptr;
  return &g_cards[dev];
}

__host__ __device__ inline int cdiv(int a, int b) { return (a + b - 1) / b; }
__host__ __device__ inline int up(int a, int b) { return cdiv(a, b) * b; }

using plt::FastDiv;

struct Args {
  const int8_t* x;
  const int8_t* w;
  const float* scale;
  const float* bias;  // may be null
  void* out;
  int N, H, W, C, OH, OW;
  plt::ActParams act;
  float inv_out_scale;
  int th, tw, cv, vb, ipb;      // the plan
  int rs;                       // a halo row's bytes in shared memory
  int sh, sw, runs, ntiles;     // derived from it
  int halo_bytes, buf_bytes;    // shared memory: two buffers of halo + constants
  FastDiv chunks, tiles_w, tiles_h, cpp, halo_row, th_div, tw_div, sh_div, runs_div;
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

template <int B>
__device__ __forceinline__ void cp_async(int8_t* dst, const void* src, bool valid) {
  const int n = valid ? B : 0;  // source size 0: the B bytes are zero-filled
  if constexpr (B == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
                 "l"(src), "r"(n));
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(smem_addr(dst)),
                 "l"(src), "n"(B), "r"(n));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

struct Tile {
  int n0, c0, oh0, ow0;
};

__device__ __forceinline__ Tile tile_at(const Args& a, int t) {
  // channel chunk fastest, then column tile, row tile, group of images
  const int r1 = (int)a.chunks.div(t);
  const int r2 = (int)a.tiles_w.div(r1);
  const int r3 = (int)a.tiles_h.div(r2);
  return Tile{r3 * a.ipb, (t - r1 * (int)a.chunks.d) * a.cv,
              (r2 - r3 * (int)a.tiles_h.d) * a.th, (r1 - r2 * (int)a.tiles_w.d) * a.tw};
}

// Tile t's input halo (ipb * sh rows of sw pixels, cv bytes each, in B-byte
// pieces; zeros outside the image, past C and past N) and its constants
// (k*k rows of cv weight bytes, cv scales, cv biases; zeros past C) into
// `buf`.  B = 1: plain byte copies, done when this returns.
template <int KS, int S, int B>
__device__ __forceinline__ void fetch_tile(const Args& a, int8_t* buf, int t) {
  constexpr int PAD = (KS - 1) / 2;
  const Tile tl = tile_at(a, t);
  const int ih0 = tl.oh0 * S - PAD, iw0 = tl.ow0 * S - PAD;
  const int per_row = a.sw * (int)a.cpp.d;
  const int rows = a.ipb * a.sh;
  if (per_row <= THREADS) {
    // a thread keeps one piece of a row and walks rows: the piece's column,
    // channels and bounds are worked out once
    const int rpp = THREADS / per_row, r0 = threadIdx.x / per_row;
    const int j = threadIdx.x - r0 * per_row;
    const int col = (int)a.cpp.div(j);
    const int cc = (j - col * (int)a.cpp.d) * B;
    const int iw = iw0 + col, c = tl.c0 + cc;
    const bool col_ok = iw >= 0 && iw < a.W && c < a.C;
    int8_t* dst = buf + col * a.cv + cc;
    for (int row = (r0 < rpp ? r0 : rows); row < rows; row += rpp) {
      const int img = (int)a.sh_div.div(row);
      const int n = tl.n0 + img, ih = ih0 + row - img * a.sh;
      const bool ok = col_ok && n < a.N && ih >= 0 && ih < a.H;
      const int8_t* src = ok ? a.x + ((((size_t)n * a.H + ih) * a.W + iw) * a.C + c) : a.x;
      if constexpr (B == 1)
        dst[row * a.rs] = ok ? *src : int8_t(0);
      else
        cp_async<B>(dst + row * a.rs, src, ok);
    }
  }
  const int total = per_row <= THREADS ? 0 : rows * per_row;
  for (int i = threadIdx.x; i < total; i += THREADS) {
    const int row = (int)a.halo_row.div(i);
    const int rem = i - row * per_row;
    const int col = (int)a.cpp.div(rem);
    const int cc = (rem - col * (int)a.cpp.d) * B;
    const int img = (int)a.sh_div.div(row);
    const int n = tl.n0 + img, ih = ih0 + row - img * a.sh, iw = iw0 + col;
    const int c = tl.c0 + cc;
    const bool ok = n < a.N && ih >= 0 && ih < a.H && iw >= 0 && iw < a.W && c < a.C;
    int8_t* dst = buf + row * a.rs + col * a.cv + cc;
    const int8_t* src = ok ? a.x + ((((size_t)n * a.H + ih) * a.W + iw) * a.C + c) : a.x;
    if constexpr (B == 1)
      *dst = ok ? *src : int8_t(0);
    else
      cp_async<B>(dst, src, ok);
  }
  int8_t* wbuf = buf + a.halo_bytes;
  const int wtotal = KS * KS * (int)a.cpp.d;
  for (int i = threadIdx.x; i < wtotal; i += THREADS) {
    const int tap = (int)a.cpp.div(i);
    const int cc = (i - tap * (int)a.cpp.d) * B;
    const int c = tl.c0 + cc;
    const bool ok = c < a.C;
    const int8_t* src = ok ? a.w + tap * a.C + c : a.w;
    if constexpr (B == 1)
      wbuf[tap * a.cv + cc] = ok ? *src : int8_t(0);
    else
      cp_async<B>(wbuf + tap * a.cv + cc, src, ok);
  }
  float* sbuf = reinterpret_cast<float*>(wbuf + up(KS * KS * a.cv, 16));
  for (int i = threadIdx.x; i < 2 * a.cv; i += THREADS) {
    const bool is_bias = i >= a.cv;
    const int c = tl.c0 + (is_bias ? i - a.cv : i);
    const float* base = is_bias ? a.bias : a.scale;
    if (base == nullptr) continue;  // no bias: never read
    const bool ok = c < a.C;
    cp_async<4>(reinterpret_cast<int8_t*>(sbuf + i), ok ? base + c : base, ok);
  }
}

template <int KS, int S>
__device__ __forceinline__ void fetch(const Args& a, int8_t* buf, int t) {
  switch (a.vb) {
    case 16: fetch_tile<KS, S, 16>(a, buf, t); break;
    case 8: fetch_tile<KS, S, 8>(a, buf, t); break;
    case 4: fetch_tile<KS, S, 4>(a, buf, t); break;
    default: fetch_tile<KS, S, 1>(a, buf, t); break;
  }
}

using plt::act_value;
using plt::to_f32x4;
using plt::requant_lo;

template <int B>
__device__ __forceinline__ void copy_piece(int8_t* dst, const int8_t* src) {
  if constexpr (B == 16) *reinterpret_cast<int4*>(dst) = *reinterpret_cast<const int4*>(src);
  if constexpr (B == 8) *reinterpret_cast<int2*>(dst) = *reinterpret_cast<const int2*>(src);
  if constexpr (B == 4) *reinterpret_cast<int*>(dst) = *reinterpret_cast<const int*>(src);
  if constexpr (B == 1) *dst = *src;
}

// The staged int8 tile (ipb * th rows of tw pixels, cv bytes each) to the
// output, B bytes a store, skipping what lies past N, OH, OW or C.
template <int B>
__device__ __forceinline__ void store_tile(const Args& a, const int8_t* stage,
                                           const Tile& tl) {
  int8_t* out = static_cast<int8_t*>(a.out);
  const int total = a.ipb * a.th * a.tw * (int)a.cpp.d;
  for (int i = threadIdx.x; i < total; i += THREADS) {
    const int pix = (int)a.cpp.div(i);
    const int cc = (i - pix * (int)a.cpp.d) * B;
    const int row = (int)a.tw_div.div(pix);
    const int col = pix - row * a.tw;
    const int img = (int)a.th_div.div(row);
    const int n = tl.n0 + img, oh = tl.oh0 + row - img * a.th, ow = tl.ow0 + col;
    const int c = tl.c0 + cc;
    if (n < a.N && oh < a.OH && ow < a.OW && c < a.C)
      copy_piece<B>(out + (((size_t)n * a.OH + oh) * a.OW + ow) * a.C + c,
                    stage + pix * a.cv + cc);
  }
}

// k = 3 fits two blocks an SM in registers (<= 128 a thread); k = 5 holds
// 100 weights a thread and takes one
template <int KS, int S, int ACT, bool OUT_I8>
__global__ void __launch_bounds__(THREADS, KS == 3 ? 2 : 1) dw_conv_kernel(const Args a) {
  constexpr int SPAN = (P - 1) * S + KS;  // input columns of one unit
  extern __shared__ __align__(16) int8_t smem[];
  int8_t* stage = smem + 2 * a.buf_bytes;
  int t = blockIdx.x;
  fetch<KS, S>(a, smem, t);
  cp_async_commit();

  const int g = a.cv >> 2, ustep = THREADS / g;
  const int cg = threadIdx.x % g, u0 = threadIdx.x / g;
  const int units = a.ipb * a.th * a.runs;
  const bool has_bias = a.bias != nullptr;
  // hard_swish's divisor, its reciprocal, and whether the fast division holds for it
  const float rb = 1.0f / a.act.p1;
  const bool fast_div = CHECKED_DIVISION && ACT == plt::ACT_HARD_SWISH &&
                        fabsf(a.act.p1) >= 0x1p-60f && fabsf(a.act.p1) <= 0x1p60f;

  for (int it = 0; t < a.ntiles; ++it, t += gridDim.x) {
    int8_t* buf = smem + (it & 1) * a.buf_bytes;
    if (t + (int)gridDim.x < a.ntiles)  // the next tile into the other buffer
      fetch<KS, S>(a, smem + ((it + 1) & 1) * a.buf_bytes, t + gridDim.x);
    cp_async_commit();
    cp_async_wait<1>();  // this tile's copies are done
    __syncthreads();
    const Tile tl = tile_at(a, t);

    // this thread's 4 channels: weights, scales, biases in registers
    const int8_t* wbuf = buf + a.halo_bytes;
    const float* sbuf = reinterpret_cast<const float*>(wbuf + up(KS * KS * a.cv, 16));
    float wk[KS * KS][4], scv[4], biv[4];
#pragma unroll
    for (int tap = 0; tap < KS * KS; ++tap)
      to_f32x4(*reinterpret_cast<const uint32_t*>(wbuf + tap * a.cv + cg * 4), wk[tap]);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      scv[j] = sbuf[cg * 4 + j];
      biv[j] = has_bias ? sbuf[a.cv + cg * 4 + j] : -0.0f;  // y + -0 == y, bit for bit
    }
    const int cl = tl.c0 + cg * 4;  // the thread's first channel

    // units of (image, output row, run of P columns), rows fastest
    for (int u = (u0 < ustep ? u0 : units); u < units; u += ustep) {
      const int q = (int)a.th_div.div(u);
      const int r = u - q * a.th;
      const int img = (int)a.runs_div.div(q);
      const int run = q - img * a.runs;
      if (tl.n0 + img >= a.N || tl.oh0 + r >= a.OH) continue;
      const int8_t* base = buf + (img * a.sh + r * S) * a.rs + run * P * S * a.cv + cg * 4;
      float acc[P][4];
#pragma unroll
      for (int p = 0; p < P; ++p)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[p][j] = 0.0f;
#pragma unroll
      for (int i = 0; i < KS; ++i) {
        const int8_t* rowp = base + i * a.rs;
#pragma unroll
        for (int col = 0; col < SPAN; ++col) {
          float xv[4];
          to_f32x4(*reinterpret_cast<const uint32_t*>(rowp + col * a.cv), xv);
#pragma unroll
          for (int p = 0; p < P; ++p) {
            const int kj = col - p * S;
            if (kj < 0 || kj >= KS) continue;
#pragma unroll
            for (int j = 0; j < 4; ++j)
              acc[p][j] = __fmaf_rn(xv[j], wk[i * KS + kj][j], acc[p][j]);
          }
        }
      }
      const int owr = tl.ow0 + run * P;
      const size_t orow = ((size_t)(tl.n0 + img) * a.OH + tl.oh0 + r) * a.OW;
      bool bad = false;
      auto emit = [&](auto fast) {
#pragma unroll
        for (int p = 0; p < P; ++p) {
          float y[4];
#pragma unroll
          for (int j = 0; j < 4; ++j)  // acc * scale + bias, rounded twice, as epilogue.cuh
            y[j] = act_value<ACT, decltype(fast)::value>(acc[p][j] * scv[j] + biv[j], a.act,
                                                         rb, bad);
          if constexpr (OUT_I8) {
            const float inv = a.inv_out_scale;
            const uint32_t lo = __byte_perm(requant_lo(y[0], inv), requant_lo(y[1], inv), 0x0040);
            const uint32_t hi = __byte_perm(requant_lo(y[2], inv), requant_lo(y[3], inv), 0x0040);
            *reinterpret_cast<uint32_t*>(
                stage + ((img * a.th + r) * a.tw + run * P + p) * a.cv + cg * 4) =
                __byte_perm(lo, hi, 0x5410);
          } else if (owr + p < a.OW) {
            float* dst = static_cast<float*>(a.out) + (orow + owr + p) * a.C + cl;
            if (a.vb >= 4) {  // C % 4 == 0: the 4 channels lie together, aligned
              if (cl < a.C) *reinterpret_cast<float4*>(dst) = make_float4(y[0], y[1], y[2], y[3]);
            } else {
#pragma unroll
              for (int j = 0; j < 4; ++j)
                if (cl + j < a.C) dst[j] = y[j];
            }
          }
        }
      };
      if (fast_div) {
        emit(std::true_type{});
        if (bad) emit(std::false_type{});  // a dividend outside the fast range: IEEE
      } else {
        emit(std::false_type{});
      }
    }
    __syncthreads();  // the stage is written; this buffer is free again
    if constexpr (OUT_I8) {
      switch (a.vb) {
        case 16: store_tile<16>(a, stage, tl); break;
        case 8: store_tile<8>(a, stage, tl); break;
        case 4: store_tile<4>(a, stage, tl); break;
        default: store_tile<1>(a, stage, tl); break;
      }
    }
  }
  cp_async_wait<0>();
}

using Kernel = void (*)(const Args);

template <int KS, int S, bool O8>
Kernel pick_act(int act) {
  switch (act) {
    case plt::ACT_NONE: return dw_conv_kernel<KS, S, plt::ACT_NONE, O8>;
    case plt::ACT_RELU: return dw_conv_kernel<KS, S, plt::ACT_RELU, O8>;
    case plt::ACT_RELU6: return dw_conv_kernel<KS, S, plt::ACT_RELU6, O8>;
    case plt::ACT_LEAKY_RELU: return dw_conv_kernel<KS, S, plt::ACT_LEAKY_RELU, O8>;
    case plt::ACT_HARD_SWISH: return dw_conv_kernel<KS, S, plt::ACT_HARD_SWISH, O8>;
    case plt::ACT_HARD_SIGMOID: return dw_conv_kernel<KS, S, plt::ACT_HARD_SIGMOID, O8>;
    default: return nullptr;
  }
}

template <int KS, int S>
Kernel pick_out(int act, int out_i8) {
  return out_i8 ? pick_act<KS, S, true>(act) : pick_act<KS, S, false>(act);
}

Kernel pick(int k, int s, int act, int out_i8) {
  if (k == 3 && s == 1) return pick_out<3, 1>(act, out_i8);
  if (k == 3 && s == 2) return pick_out<3, 2>(act, out_i8);
  if (k == 5 && s == 1) return pick_out<5, 1>(act, out_i8);
  if (k == 5 && s == 2) return pick_out<5, 2>(act, out_i8);
  return nullptr;
}

// Blocks of `kern` with `smem` shared bytes each that `card` holds at once.
cudaError_t resident_blocks(const Card& card, Kernel kern, size_t smem, long long* out) {
  int per_sm = 0;
  const cudaError_t e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, THREADS, smem);
  *out = (long long)per_sm * card.sms;
  return e;
}

}  // namespace

// Reads the current device's SMs and shared-memory sizes into its entry
// and lets every instantiation take all the dynamic shared memory a block
// may there.  The wrapper calls it once per device, when the library is
// first used there (never inside a CUDA-graph capture).  Returns the first
// CUDA error, or 0.
extern "C" int plt_dw_conv_prepare() {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (dev < 0 || dev >= MAX_DEVICES) return static_cast<int>(cudaErrorInvalidDevice);
  Card c = {};
  const struct {
    int* to;
    cudaDeviceAttr attr;
  } reads[] = {{&c.sms, cudaDevAttrMultiProcessorCount},
               {&c.smem_sm, cudaDevAttrMaxSharedMemoryPerMultiprocessor},
               {&c.smem_block, cudaDevAttrMaxSharedMemoryPerBlockOptin},
               {&c.smem_reserved, cudaDevAttrReservedSharedMemoryPerBlock}};
  for (const auto& r : reads)
    if (e == cudaSuccess) e = cudaDeviceGetAttribute(r.to, r.attr, dev);
  for (int k = 3; k <= 5 && e == cudaSuccess; k += 2)
    for (int s = 1; s <= 2 && e == cudaSuccess; ++s)
      for (int act = plt::ACT_NONE; act <= plt::ACT_HARD_SIGMOID && e == cudaSuccess; ++act)
        for (int o8 = 0; o8 <= 1 && e == cudaSuccess; ++o8)
          e = cudaFuncSetAttribute(pick(k, s, act, o8),
                                   cudaFuncAttributeMaxDynamicSharedMemorySize, c.smem_block);
  if (e == cudaSuccess) g_cards[dev] = c;  // the entry is whole, or stays unprepared
  return static_cast<int>(e);
}

// The k x k kernel's layout on the current device (its entry, which
// plt_dw_conv_prepare filled), for ops/kernels/depthwise.plan: threads a
// block, channels a thread, blocks an SM holds (the fewest over the k's
// instantiations, by registers and threads), the card's SMs, and the
// shared bytes one block may take while that many share an SM.  Returns a
// CUDA error, or 0.
extern "C" int plt_dw_conv_layout(int k, int* threads, int* channels, int* blocks_per_sm,
                                  int* sms, int* smem_per_block) {
  const Card* card = current_card();
  if (card == nullptr || card->sms <= 0 || (k != 3 && k != 5))
    return static_cast<int>(cudaErrorInvalidValue);
  long long fewest = -1;
  for (int s = 1; s <= 2; ++s)
    for (int act = plt::ACT_NONE; act <= plt::ACT_HARD_SIGMOID; ++act)
      for (int o8 = 0; o8 <= 1; ++o8) {
        long long n = 0;
        const cudaError_t e = resident_blocks(*card, pick(k, s, act, o8), 0, &n);
        if (e != cudaSuccess) return static_cast<int>(e);
        if (fewest < 0 || n < fewest) fewest = n;
      }
  *threads = THREADS;
  *channels = CHANNELS;
  *sms = card->sms;
  *blocks_per_sm = (int)(fewest / card->sms);
  if (*blocks_per_sm < 1) return static_cast<int>(cudaErrorInvalidValue);
  const int share = card->smem_sm / *blocks_per_sm - card->smem_reserved;
  *smem_per_block = share < card->smem_block ? share : card->smem_block;
  return 0;
}

// C interface, bound with ctypes.  Device pointers; `bias` may be null.
// `act` is a plt::Act code and p0..p2 its parameters (epilogue.cuh).  The
// plan (th, tw, cv, vec, ipb, smem, tiles_x, tiles_y) comes from
// ops/kernels/depthwise.plan; the kernel runs its tiles_x * tiles_y tiles on
// as many resident blocks as the card holds, by the entry of the current
// device (the wrapper makes it the tensor's).  Returns cudaGetLastError()
// after the launch, or cudaErrorInvalidValue (1) for a kernel size, stride,
// plan or pointer the kernel does not take, or on a device not prepared;
// it never substitutes another plan.
extern "C" int plt_dw_conv(const void* x, const void* w, const void* scale,
                           const void* bias, void* out, int N, int H, int W,
                           int C, int OH, int OW, int k, int stride, int act,
                           float p0, float p1, float p2, int out_i8,
                           float inv_out_scale, int th, int tw,
                           int cv, int vec, int ipb,
                           long long smem_bytes, int tiles_x, int tiles_y,
                           void* stream) {
  const int invalid = static_cast<int>(cudaErrorInvalidValue);
  const Kernel kern = pick(k, stride, act, out_i8);
  const Card* card = current_card();
  if (kern == nullptr || card == nullptr || card->sms <= 0) return invalid;
  if ((long long)N * OH * OW * C == 0) return static_cast<int>(cudaGetLastError());
  const int pad = (k - 1) / 2;
  if (OH != (H + 2 * pad - k) / stride + 1 || OW != (W + 2 * pad - k) / stride + 1)
    return invalid;
  // the plan: shapes the kernel's index math and copies take
  if (th < 1 || tw < P || tw % P || cv < CHANNELS || cv % CHANNELS ||
      cv / CHANNELS > THREADS ||
      ipb < 1 || (ipb > 1 && th < OH))
    return invalid;
  const int align = vec > 4 ? vec : 4;
  if (!(vec == 16 || vec == 8 || vec == 4 || vec == 1) || C % vec || cv % vec ||
      (uintptr_t)x % vec || (uintptr_t)w % vec ||
      (uintptr_t)scale % 4 || (uintptr_t)bias % 4 || (uintptr_t)out % 16)
    return invalid;
  Args a;
  a.x = static_cast<const int8_t*>(x);
  a.w = static_cast<const int8_t*>(w);
  a.scale = static_cast<const float*>(scale);
  a.bias = static_cast<const float*>(bias);
  a.out = out;
  a.N = N; a.H = H; a.W = W; a.C = C; a.OH = OH; a.OW = OW;
  a.act = plt::ActParams{act, p0, p1, p2};
  a.inv_out_scale = inv_out_scale;
  a.th = th; a.tw = tw; a.cv = cv; a.vb = vec; a.ipb = ipb;
  a.sh = (th - 1) * stride + k;
  a.sw = (tw - 1) * stride + k;
  a.runs = tw / P;
  a.rs = up(a.sw * cv, align);
  a.halo_bytes = up(ipb * a.sh * a.rs, 16);
  a.buf_bytes = a.halo_bytes + up(k * k * cv, 16) + 8 * cv;
  const long long need = 2LL * a.buf_bytes + (long long)ipb * th * tw * cv;
  if (need > smem_bytes || smem_bytes > card->smem_block) return invalid;
  const int chunks = cdiv(C, cv), tiles_w = cdiv(OW, tw), tiles_h = cdiv(OH, th);
  if (tiles_x != tiles_h * tiles_w * chunks || tiles_y != cdiv(N, ipb)) return invalid;
  // FastDiv's range: numerators below 2^20, divisors below 2^12
  const long long ntiles = (long long)tiles_x * tiles_y;
  const long long halo_pieces = (long long)ipb * a.sh * a.sw * (cv / vec);
  const long long out_pieces = (long long)ipb * th * tw * (cv / vec);
  if (ntiles >= IDX_MAX || halo_pieces >= IDX_MAX || out_pieces >= IDX_MAX ||
      a.sw * (cv / vec) >= 4096 || th >= 4096 || tw >= 4096 || chunks >= 4096 ||
      tiles_w >= 4096 || tiles_h >= 4096 || a.sh >= 4096 || a.runs >= 4096)
    return invalid;
  a.ntiles = (int)ntiles;
  a.chunks = FastDiv(chunks);
  a.tiles_w = FastDiv(tiles_w);
  a.tiles_h = FastDiv(tiles_h);
  a.cpp = FastDiv(cv / vec);
  a.halo_row = FastDiv(a.sw * (cv / vec));
  a.th_div = FastDiv(th);
  a.tw_div = FastDiv(tw);
  a.sh_div = FastDiv(a.sh);
  a.runs_div = FastDiv(a.runs);
  long long resident = 0;
  cudaError_t e = resident_blocks(*card, kern, (size_t)smem_bytes, &resident);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (resident < 1) return invalid;
  const int grid = (int)(ntiles < resident ? ntiles : resident);
  void* params[] = {&a};
  e = cudaLaunchKernel(reinterpret_cast<const void*>(kern), dim3(grid), dim3(THREADS),
                       params, (size_t)smem_bytes, static_cast<cudaStream_t>(stream));
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}
