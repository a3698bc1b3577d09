// Fused int8 depthwise 3x3 / stride 1 + pointwise 1x1 block.
//
// Replaces the Pallas kernel `_kernel` of
// paddle_lite_tpu/ops/kernels/dw_pw_fused.py (driven by `_fused_impl`):
//   d[n,h,w,c] = requant(dw_epilogue(sum_{i,j} x[n,h+i-1,w+j-1,c] * wd[i,j,c]))
//   out[n,h,w,o] = pw_epilogue(sum_c d[n,h,w,c] * wp[c,o])
// with SAME padding, x (N, H, W, C) int8 with C <= 128, wd (3, 3, 1, C) int8
// and the pointwise weights repacked as (O, C), K contiguous.  The int8
// intermediate d never reaches device memory.
//
// What bounds it on an H100: bytes.  At MobileNetV1's fused blocks (b64,
// 112x112x32 -> 64 and 56x56x128 -> 128) it must read the input once and
// write the int8 output once (77 MB and 51 MB at 3.35 TB/s), against
// 0.23 G fp32 FMAs and 3.3 G / 6.6 G int8 tensor-core operations.  So the
// design reads the input about once, overlaps the reads with the compute,
// writes whole rows, and keeps the instructions an output costs few:
//  1. Tiles.  A tile is one image's band of `rows` output rows by a strip
//     of `tw` columns (the plan, computed in Python by
//     ops/kernels/dw_pw_fused.plan and checked here).  Its input halo,
//     (rows+2) x (twp+2) pixels of C bytes (twp = tw rounded up to runs of
//     P columns), goes to shared memory by cp.async: 16-byte pieces where
//     C % 16 == 0, 8 or 4 bytes where C allows only those, bytes otherwise;
//     zero fill outside the image, so no address outside x is formed.
//  2. Persistent blocks of 512 threads, one an SM, two halo buffers.  The
//     blocks walk the tiles; a block copies tile i+1 into one buffer while
//     it computes tile i from the other.  The pointwise weights (zero past
//     C and O), scales and biases go to shared memory once a block (in
//     chunks of `oc` output channels per sub-tile only where all of them
//     do not fit), and so do the depthwise weights (each kernel row's 3
//     weights of a channel packed in a word), scales and biases; a
//     thread's 4 channels' words, scales and biases sit in registers while
//     it runs the stencil.
//  3. Sub-tiles.  A band's pixels are walked `sub` at a time (a multiple
//     of 224 = 7 x 32): the stencil fills an int8 sub x C tile, K
//     contiguous, the pointwise product consumes it, and the next sub-tile
//     follows, so the int8 tile need not hold the band.  A stencil unit is
//     a run of P = 7 output columns x 4 channels (7 columns apart, the
//     units of a warp read distinct banks at C = 32).  Its sums are
//     integer: a kernel row's 9 input words (4 channels each) become each
//     channel's pixels 0-3 and 4-7 as words by two 4 x 4 byte transposes,
//     each output's window of 3 pixels is one byte permute, and one
//     __dp4a against the packed row of weights (a fourth byte of 0) adds
//     it: 3 dp4a an output instead of 9 FMAs on bytes turned into floats.
//     The sum becomes a float by plt::small_int_to_float (|sum| <= 9*127*128)
//     with no conversion instruction.  The dw epilogue has its activation
//     as a template parameter (plt::act_value, hard_swish's division
//     checked and redone in IEEE for a pixel out of its range), and
//     requant is plt::requant_lo's add, packed 4 bytes a word.
//  4. The pointwise product: mma.sync s8 x s8 -> s32 (mma_s8.cuh), a warp
//     to each 32 x 32 piece of the sub x oc product, fragments by
//     ldmatrix, the depth unrolled.  Its epilogue is compiled once per
//     activation (one uniform switch a warp tile), converts the
//     accumulators with plt::small_int_to_float (|acc| <= 128*128*127,
//     inside its window) and requants with plt::requant_lo (its lower
//     clip left out after an activation whose outputs are >= 0).
//  5. The output sub-tile is staged in shared memory and leaves in
//     `out_width`-byte pieces (16 where O's bytes allow), consecutive
//     threads on consecutive pieces: with tw = W a band's output is one
//     contiguous run, so every store is coalesced.  fp32 output likewise.
// The sums are exact integers and the epilogues round as those of
// dw_conv.cu and int8_gemm.cu do, so the block's output equals the
// unfused pair's bit for bit.
//
// The constants below marked "ablation" are each built false only by
// paddle_lite_tpu_torch/tools/fused_ablation.py, to time what each part
// of the design is worth.
#include <cuda_runtime.h>
#include <float.h>
#include <stdint.h>

#include <type_traits>

#include "epilogue.cuh"
#include "mma_s8.cuh"

namespace {

constexpr int THREADS = 512;
constexpr int P = 7;             // output columns of a stencil unit
constexpr int SUB_STEP = 224;    // sub-tiles come in multiples of lcm(P, 32)
constexpr int MAX_C = 128;       // the pass fuses blocks of at most 128 channels
constexpr uint32_t IDX_MAX = 1u << 20;  // bound of FastDiv's numerators
// ablation: integer sums to floats and requant without conversion
// instructions (false: I2F, and rintf and F2I as plt::requant)
constexpr bool CONVERSION_FREE = true;
// ablation: the activations fixed at compile time, hard_swish's division
// checked (false: plt::apply_act's runtime switch for every element)
constexpr bool ACT_FIXED = true;
// ablation: the next tile's halo copied while this one computes (false:
// copy, wait, compute)
constexpr bool PIPELINED = true;
// ablation: the output staged and stored in whole-row pieces (false: two
// outputs a store straight from the accumulators, scattered over 8 rows)
constexpr bool STAGED_STORES = true;
// ablation: the stencil's sums by __dp4a on windows of 4 bytes (false:
// fp32 FMAs on bytes turned into floats by plt::to_f32x4, as dw_conv.cu)
constexpr bool STENCIL_DP4A = true;

using plt::FastDiv;

__host__ __device__ inline int cdiv(int a, int b) { return (a + b - 1) / b; }
__host__ __device__ inline int up(int a, int b) { return cdiv(a, b) * b; }

struct Args {
  const int8_t* x;
  const int8_t* wd;
  const float* dw_scale;
  const float* dw_bias;  // may be null
  const int8_t* wp;      // (O, C)
  const float* pw_scale;
  const float* pw_bias;  // may be null
  void* out;
  int N, H, W, C, O;
  plt::ActParams dw_act, pw_act;
  float inv_dw, inv_out;
  int rows, tw, twp, sub, oc, vb, ow;  // the plan
  int cs;        // bytes of a halo pixel: C rounded up to 4
  int rs;        // bytes of a halo row: (twp + 2) * cs rounded up to 16
  int kp, lda;   // product depth (C rounded up to 32) and int8 row stride
  int ldo;       // bytes of a staged output row
  int chunks;    // output-channel chunks of oc
  int slab_bytes, tiles;
  FastDiv strips, bands, twp_div, halo_cols, cpp, out_pieces;
};

// Shared-memory carve-up: two halo buffers, the int8 sub-tile, the
// pointwise weights (oc rows), the staged output sub-tile, chunks * oc
// pointwise scales and as many biases, then the depthwise constants: 3
// rows of cs words (a kernel row's 3 weights of a channel, bytes 0-2),
// cs scales and cs biases.
struct Smem {
  int8_t* dtile;
  int8_t* wpw;
  int8_t* stage;
  float* scale;
  float* bias;
  float* dwk;
  __device__ Smem(const Args& a, int8_t* base) {
    dtile = base + 2 * a.slab_bytes;
    wpw = dtile + a.sub * a.lda;
    stage = wpw + a.oc * a.lda;
    scale = reinterpret_cast<float*>(stage + a.sub * a.ldo);
    bias = scale + a.chunks * a.oc;
    dwk = bias + a.chunks * a.oc;
  }
};

__host__ inline long long smem_bytes(const Args& a) {
  return 2LL * a.slab_bytes + (long long)a.sub * a.lda + (long long)a.oc * a.lda +
         (long long)a.sub * a.ldo + 8LL * a.chunks * a.oc + 20LL * a.cs;
}

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
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

template <int B>
using Piece = typename std::conditional<
    B == 16, int4,
    typename std::conditional<
        B == 8, int2,
        typename std::conditional<B == 4, int,
                                  typename std::conditional<B == 2, short, int8_t>::type>::type>::type>::type;

struct Tile {
  int n, h0, w0, rv, wv;  // image, first row and column, rows and columns in the image
};

__device__ __forceinline__ Tile tile_at(const Args& a, int t) {
  // strips fastest, then bands, then images
  const int q = (int)a.strips.div(t);
  const int n = (int)a.bands.div(q);
  Tile tl;
  tl.n = n;
  tl.h0 = (q - n * (int)a.bands.d) * a.rows;
  tl.w0 = (t - q * (int)a.strips.d) * a.tw;
  tl.rv = min(a.rows, a.H - tl.h0);
  tl.wv = min(a.tw, a.W - tl.w0);
  return tl;
}

// Tile tl's input halo ((rows + 2) rows of twp + 2 pixels, cs bytes each,
// in B-byte pieces; zeros outside the image and past C) into `buf`.  B = 1:
// plain byte copies, done when this returns.
template <int B>
__device__ __forceinline__ void fetch_halo(const Args& a, int8_t* buf, const Tile& tl) {
  const int per_pixel = (int)a.cpp.d;
  const int total = (a.rows + 2) * (int)a.halo_cols.d * per_pixel;
  for (int i = threadIdx.x; i < total; i += THREADS) {
    const int pix = (int)a.cpp.div(i);
    const int cc = (i - pix * per_pixel) * B;
    const int r = (int)a.halo_cols.div(pix);
    const int col = pix - r * (int)a.halo_cols.d;
    const int ih = tl.h0 - 1 + r, iw = tl.w0 - 1 + col;
    const bool ok = ih >= 0 && ih < a.H && iw >= 0 && iw < a.W && cc < a.C;
    const int8_t* src = ok ? a.x + (((size_t)tl.n * a.H + ih) * a.W + iw) * a.C + cc : a.x;
    int8_t* dst = buf + r * a.rs + col * a.cs + cc;
    if constexpr (B == 1)
      *dst = ok ? *src : int8_t(0);
    else
      cp_async<B>(dst, src, ok);
  }
}

__device__ __forceinline__ void fetch(const Args& a, int8_t* buf, const Tile& tl) {
  switch (a.vb) {
    case 16: fetch_halo<16>(a, buf, tl); break;
    case 8: fetch_halo<8>(a, buf, tl); break;
    case 4: fetch_halo<4>(a, buf, tl); break;
    default: fetch_halo<1>(a, buf, tl); break;
  }
}

// Output channels [o0, o0 + oc) of the (O, C) pointwise weights into `wpw`
// (oc rows of lda bytes, zeros past O and C), B bytes a load.
template <int B>
__device__ __forceinline__ void load_weights(const Args& a, int8_t* wpw, int o0) {
  const int per_row = a.kp / B;
  for (int i = threadIdx.x; i < a.oc * per_row; i += THREADS) {
    const int o = i / per_row, c = (i - o * per_row) * B;
    Piece<B> v{};
    if (o0 + o < a.O && c < a.C)
      v = *reinterpret_cast<const Piece<B>*>(a.wp + (size_t)(o0 + o) * a.C + c);
    *reinterpret_cast<Piece<B>*>(wpw + o * a.lda + c) = v;
  }
}

__device__ __forceinline__ void weights(const Args& a, int8_t* wpw, int o0) {
  switch (a.vb) {
    case 16: load_weights<16>(a, wpw, o0); break;
    case 8: load_weights<8>(a, wpw, o0); break;
    case 4: load_weights<4>(a, wpw, o0); break;
    default: load_weights<1>(a, wpw, o0); break;
  }
}

// ---- the arithmetic, with the ablation's alternatives ----------------------

__device__ __forceinline__ void bytes_to_f32(uint32_t v, float f[4]) {
  if constexpr (CONVERSION_FREE) {
    plt::to_f32x4(v, f);
  } else {
#pragma unroll
    for (int j = 0; j < 4; ++j) f[j] = static_cast<float>(static_cast<int8_t>(v >> (8 * j)));
  }
}

__device__ __forceinline__ float acc_to_f32(int v) {
  if constexpr (CONVERSION_FREE) return plt::small_int_to_float(v);
  return static_cast<float>(v);
}

// Activations whose outputs are >= 0, -0 or 0 for every input (NaN too)
template <int ACT>
__host__ __device__ constexpr bool nonnegative() {
  return ACT == plt::ACT_RELU || ACT == plt::ACT_RELU6 || ACT == plt::ACT_HARD_SIGMOID;
}

// the int8 requant of y in the low byte.  NONNEG: y >= 0 or y = -0, and
// inv finite and > 0 (the launch refuses any other inverse scale), so
// y * inv never falls below -127 and plt::requant_lo's lower clip is
// left out.
template <bool NONNEG>
__device__ __forceinline__ uint32_t requant_byte(float y, float inv) {
  if constexpr (!CONVERSION_FREE) return static_cast<uint8_t>(plt::requant(y, inv));
  if constexpr (NONNEG) return __float_as_uint(fminf(y * inv, 127.0f) + 12582912.0f);
  return plt::requant_lo(y, inv);
}

template <int ACT, bool FAST>
__device__ __forceinline__ float act(float y, const plt::ActParams& p, float rb, bool& bad) {
  if constexpr (ACT_FIXED) return plt::act_value<ACT, FAST>(y, p, rb, bad);
  return plt::apply_act(y, p);
}

// hard_swish's divisor within the range of the checked division
__device__ __forceinline__ bool fast_division(const plt::ActParams& p) {
  return ACT_FIXED && p.code == plt::ACT_HARD_SWISH && fabsf(p.p1) >= 0x1p-60f &&
         fabsf(p.p1) <= 0x1p60f;
}

// ---- the stencil ------------------------------------------------------------

// The depthwise constants, zeros past C: each kernel row's 3 weights of a
// channel as the bytes 0-2 of a word (__dp4a's operand; byte 3 is 0),
// scales, and biases (-0 without a bias: y + -0 == y, bit for bit).
__device__ __forceinline__ void load_dw_consts(const Args& a, float* dwk) {
  for (int i = threadIdx.x; i < 5 * a.cs; i += THREADS) {
    const int row = i / a.cs, c = i - row * a.cs;
    float v = 0.0f;
    if (row < 3 && c < a.C) {
      const int8_t* w = a.wd + row * 3 * a.C + c;
      v = __uint_as_float(static_cast<uint8_t>(w[0]) | static_cast<uint8_t>(w[a.C]) << 8 |
                          static_cast<uint32_t>(static_cast<uint8_t>(w[2 * a.C])) << 16);
    } else if (row == 3) {
      v = c < a.C ? a.dw_scale[c] : 0.0f;
    } else if (row == 4) {
      v = c < a.C && a.dw_bias ? a.dw_bias[c] : -0.0f;
    }
    dwk[i] = v;
  }
}

// The int8 depthwise outputs of pixels [q0, q0 + sub) of the band (rows of
// twp pixels) into the sub-tile: units of (run of P pixels, 4 channels),
// channel group fixed per thread.
template <int ACT>
__device__ __forceinline__ void stencil(const Args& a, const int8_t* buf, int8_t* dtile,
                                        int q0, int rv, const float* dwk, bool fast_div,
                                        float rb) {
  const int g = a.cs >> 2, ustep = THREADS / g;
  const int cg = threadIdx.x % g, u0 = threadIdx.x / g;
  const int runs = a.sub / P;
  if (u0 >= ustep) return;
  // this thread's 4 channels: 3 weight words each, scales and biases
  uint32_t wq[3][4];
  float sc[4], bi[4];
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    const uint4 v = *reinterpret_cast<const uint4*>(dwk + i * a.cs + cg * 4);
    wq[i][0] = v.x; wq[i][1] = v.y; wq[i][2] = v.z; wq[i][3] = v.w;
  }
  {
    const float4 v = *reinterpret_cast<const float4*>(dwk + 3 * a.cs + cg * 4);
    const float4 b = *reinterpret_cast<const float4*>(dwk + 4 * a.cs + cg * 4);
    sc[0] = v.x; sc[1] = v.y; sc[2] = v.z; sc[3] = v.w;
    bi[0] = b.x; bi[1] = b.y; bi[2] = b.z; bi[3] = b.w;
  }
  for (int u = u0; u < runs; u += ustep) {
    const int p0 = q0 + u * P;
    const int r = (int)a.twp_div.div(p0);
    if (r >= rv) continue;  // past the band or the image: never stored
    const int wl = p0 - r * a.twp;
    const int8_t* base = buf + r * a.rs + wl * a.cs + cg * 4;
    float acc[P][4];
    if constexpr (STENCIL_DP4A) {
      int iacc[P][4];
#pragma unroll
      for (int p = 0; p < P; ++p)
#pragma unroll
        for (int j = 0; j < 4; ++j) iacc[p][j] = 0;
#pragma unroll
      for (int i = 0; i < 3; ++i) {
        uint32_t x[P + 2];
#pragma unroll
        for (int col = 0; col < P + 2; ++col)
          x[col] = *reinterpret_cast<const uint32_t*>(base + i * a.rs + col * a.cs);
        // pixels 0-3 and 4-7 of each channel as a word: 4 x 4 byte transposes
        uint32_t t[2][4];
#pragma unroll
        for (int b = 0; b < 2; ++b) {
          const uint32_t e0 = __byte_perm(x[4 * b], x[4 * b + 1], 0x5140);
          const uint32_t e1 = __byte_perm(x[4 * b], x[4 * b + 1], 0x7362);
          const uint32_t e2 = __byte_perm(x[4 * b + 2], x[4 * b + 3], 0x5140);
          const uint32_t e3 = __byte_perm(x[4 * b + 2], x[4 * b + 3], 0x7362);
          t[b][0] = __byte_perm(e0, e2, 0x5410);
          t[b][1] = __byte_perm(e0, e2, 0x7632);
          t[b][2] = __byte_perm(e1, e3, 0x5410);
          t[b][3] = __byte_perm(e1, e3, 0x7632);
        }
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int w = static_cast<int>(wq[i][j]);
          // output p's window: pixels p, p + 1, p + 2 (a fourth byte times 0)
          const uint32_t win[P] = {
              t[0][j], __byte_perm(t[0][j], t[1][j], 0x4321),
              __byte_perm(t[0][j], t[1][j], 0x5432), __byte_perm(t[0][j], t[1][j], 0x6543),
              t[1][j], __byte_perm(t[1][j], x[8], 0x0321 | (4 + j) << 12),
              __byte_perm(t[1][j], x[8], 0x0032 | (4 + j) << 8)};
#pragma unroll
          for (int p = 0; p < P; ++p) iacc[p][j] = __dp4a(static_cast<int>(win[p]), w, iacc[p][j]);
        }
      }
#pragma unroll
      for (int p = 0; p < P; ++p)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[p][j] = acc_to_f32(iacc[p][j]);
    } else {
#pragma unroll
      for (int p = 0; p < P; ++p)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[p][j] = 0.0f;
#pragma unroll
      for (int i = 0; i < 3; ++i) {
#pragma unroll
        for (int col = 0; col < P + 2; ++col) {
          float xv[4];
          bytes_to_f32(*reinterpret_cast<const uint32_t*>(base + i * a.rs + col * a.cs), xv);
#pragma unroll
          for (int p = 0; p < P; ++p) {
            const int kj = col - p;
            if (kj < 0 || kj > 2) continue;
#pragma unroll
            for (int j = 0; j < 4; ++j)
              acc[p][j] = __fmaf_rn(
                  xv[j], static_cast<float>(static_cast<int8_t>(wq[i][j] >> (8 * kj))), acc[p][j]);
          }
        }
      }
    }
    int8_t* dst = dtile + (u * P) * a.lda + cg * 4;
    // a pixel's 4 channels: acc * scale + bias (rounded twice, as
    // epilogue.cuh), the activation, the requant, packed into a word
    auto word = [&](int p, auto fast, bool& bad) {
      uint32_t q[4];
#pragma unroll
      for (int j = 0; j < 4; ++j)
        q[j] = requant_byte<nonnegative<ACT>()>(
            act<ACT, decltype(fast)::value>(acc[p][j] * sc[j] + bi[j], a.dw_act, rb, bad),
            a.inv_dw);
      return __byte_perm(__byte_perm(q[0], q[1], 0x0040), __byte_perm(q[2], q[3], 0x0040),
                         0x5410);
    };
#pragma unroll
    for (int p = 0; p < P; ++p) {
      bool bad = false;
      uint32_t q = word(p, std::bool_constant<ACT == plt::ACT_HARD_SWISH>{}, bad);
      if (ACT == plt::ACT_HARD_SWISH && (!fast_div || bad))  // out of the fast range: IEEE
        q = word(p, std::false_type{}, bad);
      *reinterpret_cast<uint32_t*>(dst + p * a.lda) = q;
    }
  }
}

// ---- the pointwise product and its epilogue ------------------------------

// Where a sub-tile's outputs go: the tile, the sub-tile's first pixel and
// the chunk's first output channel.
struct Sub {
  Tile tl;
  int q0, o0;
};

template <bool OUT_I8>
__device__ __forceinline__ size_t out_offset(const Args& a, const Sub& s, int r, int wl) {
  return ((((size_t)s.tl.n * a.H + s.tl.h0 + r) * a.W + s.tl.w0 + wl) * a.O + s.o0) *
         (OUT_I8 ? 1 : 4);
}

// The epilogue of one warp's 32 x 32 piece (rows mt*32.., chunk columns
// nt*32..) into the staged sub-tile.  Lane l = 4g + t holds rows g, g + 8
// of each m16 tile and columns 2t, 2t + 1 of each n8 tile (mma_s8.cuh).
// Returns whether a hard_swish dividend left the checked division's range
// (FAST: the caller redoes the piece without it).
template <int ACT, bool FAST, bool OUT_I8>
__device__ __forceinline__ bool pw_piece(const Args& a, const int (&acc)[2][4][4],
                                         int8_t* stage, const float* scale,
                                         const float* bias, int mt, int nt, float rb,
                                         const Sub& s) {
  const int lane = threadIdx.x & 31;
  bool bad = false;
  size_t at[2][2];  // without staging: the rows' output offsets, or ~0 past the image
  if constexpr (!STAGED_STORES) {
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int p = s.q0 + mt * 32 + mi * 16 + (lane >> 2) + 8 * hf;
        const int r = (int)a.twp_div.div(p), wl = p - r * a.twp;
        at[mi][hf] = r < s.tl.rv && wl < s.tl.wv ? out_offset<OUT_I8>(a, s, r, wl) : ~size_t(0);
      }
  }
#pragma unroll
  for (int ni = 0; ni < 4; ++ni) {
    const int col = nt * 32 + ni * 8 + 2 * (lane & 3);
    const float2 sc = *reinterpret_cast<const float2*>(scale + col);
    const float2 bi = *reinterpret_cast<const float2*>(bias + col);
#pragma unroll
    for (int mi = 0; mi < 2; ++mi) {
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const float y0 = act<ACT, FAST>(acc_to_f32(acc[mi][ni][2 * hf]) * sc.x + bi.x,
                                        a.pw_act, rb, bad);
        const float y1 = act<ACT, FAST>(acc_to_f32(acc[mi][ni][2 * hf + 1]) * sc.y + bi.y,
                                        a.pw_act, rb, bad);
        const int row = mt * 32 + mi * 16 + (lane >> 2) + 8 * hf;
        if constexpr (STAGED_STORES) {
          int8_t* dst = stage + row * a.ldo;
          if constexpr (OUT_I8)
            *reinterpret_cast<uint16_t*>(dst + col) = static_cast<uint16_t>(__byte_perm(
                requant_byte<nonnegative<ACT>()>(y0, a.inv_out),
                requant_byte<nonnegative<ACT>()>(y1, a.inv_out), 0x0040));
          else
            *reinterpret_cast<float2*>(dst + 4 * col) = make_float2(y0, y1);
        } else {
          const int o = s.o0 + col;
          if (at[mi][hf] == ~size_t(0) || o >= a.O) continue;
          if constexpr (OUT_I8) {
            int8_t* dst = static_cast<int8_t*>(a.out) + at[mi][hf] + col;
            dst[0] = static_cast<int8_t>(requant_byte<nonnegative<ACT>()>(y0, a.inv_out));
            if (o + 1 < a.O)
              dst[1] = static_cast<int8_t>(requant_byte<nonnegative<ACT>()>(y1, a.inv_out));
          } else {
            float* dst = reinterpret_cast<float*>(static_cast<int8_t*>(a.out) + at[mi][hf]) + col;
            dst[0] = y0;
            if (o + 1 < a.O) dst[1] = y1;
          }
        }
      }
    }
  }
  return bad;
}

template <int ACT, bool OUT_I8>
__device__ __forceinline__ void pw_piece_checked(const Args& a, const int (&acc)[2][4][4],
                                                 int8_t* stage, const float* scale,
                                                 const float* bias, int mt, int nt,
                                                 float rb, bool fast_div, const Sub& s) {
  if constexpr (ACT == plt::ACT_HARD_SWISH) {
    if (fast_div &&
        !pw_piece<ACT, true, OUT_I8>(a, acc, stage, scale, bias, mt, nt, rb, s))
      return;
  }
  pw_piece<ACT, false, OUT_I8>(a, acc, stage, scale, bias, mt, nt, rb, s);
}

// The product of the int8 sub-tile with the chunk's weights and its
// epilogue, a warp to each 32 x 32 piece; one uniform switch on the
// activation a piece.
template <bool OUT_I8>
__device__ __forceinline__ void pointwise(const Args& a, const Smem& sm, float rb,
                                          bool fast_div, const Sub& s) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int ntiles = cdiv(min(a.oc, a.O - s.o0), 32), mtiles = a.sub / 32;
  const float* scale = sm.scale + s.o0;
  const float* bias = sm.bias + s.o0;
  for (int t = warp; t < mtiles * ntiles; t += THREADS / 32) {
    const int mt = t / ntiles, nt = t - mt * ntiles;
    int acc[2][4][4];
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][j][e] = 0;
    const int8_t* pa = sm.dtile + mt * 32 * a.lda;
    const int8_t* pb = sm.wpw + nt * 32 * a.lda;
    switch (a.kp) {  // the product's depth, unrolled: C rounded up to 32
      case 32: plt::warp_mma_32x32<1>(acc, pa, a.lda, pb, a.lda, lane); break;
      case 64: plt::warp_mma_32x32<2>(acc, pa, a.lda, pb, a.lda, lane); break;
      case 96: plt::warp_mma_32x32<3>(acc, pa, a.lda, pb, a.lda, lane); break;
      default: plt::warp_mma_32x32<4>(acc, pa, a.lda, pb, a.lda, lane); break;
    }
    switch (a.pw_act.code) {
#define PLT_PW(A)                                                                        \
  case A:                                                                                \
    pw_piece_checked<A, OUT_I8>(a, acc, sm.stage, scale, bias, mt, nt, rb, fast_div, s); \
    break;
      PLT_PW(plt::ACT_RELU)
      PLT_PW(plt::ACT_RELU6)
      PLT_PW(plt::ACT_LEAKY_RELU)
      PLT_PW(plt::ACT_HARD_SWISH)
      PLT_PW(plt::ACT_HARD_SIGMOID)
#undef PLT_PW
      default:
        pw_piece_checked<plt::ACT_NONE, OUT_I8>(a, acc, sm.stage, scale, bias, mt, nt, rb,
                                                fast_div, s);
    }
  }
}

// The staged sub-tile's pixels in the image, out in OW-byte pieces:
// consecutive threads on consecutive pieces of a row, rows of consecutive
// pixels one after another.
template <int OW, bool OUT_I8>
__device__ __forceinline__ void store_sub(const Args& a, const int8_t* stage, const Sub& s) {
  constexpr int ES = OUT_I8 ? 1 : 4;
  const int per_row = (int)a.out_pieces.d;
  const int valid = min(a.oc, a.O - s.o0) * ES;
  for (int i = threadIdx.x; i < a.sub * per_row; i += THREADS) {
    const int row = (int)a.out_pieces.div(i);
    const int c = (i - row * per_row) * OW;
    const int p = s.q0 + row;
    const int r = (int)a.twp_div.div(p), wl = p - r * a.twp;
    if (r < s.tl.rv && wl < s.tl.wv && c < valid)
      *reinterpret_cast<Piece<OW>*>(static_cast<int8_t*>(a.out) +
                                    out_offset<OUT_I8>(a, s, r, wl) + c) =
          *reinterpret_cast<const Piece<OW>*>(stage + row * a.ldo + c);
  }
}

template <bool OUT_I8>
__device__ __forceinline__ void store(const Args& a, const int8_t* stage, const Sub& s) {
  switch (a.ow) {
    case 16: store_sub<16, OUT_I8>(a, stage, s); break;
    case 8: store_sub<8, OUT_I8>(a, stage, s); break;
    case 4: store_sub<4, OUT_I8>(a, stage, s); break;
    case 2: store_sub<2, OUT_I8>(a, stage, s); break;
    default: store_sub<1, OUT_I8>(a, stage, s); break;
  }
}

template <int DW_ACT, bool OUT_I8>
__global__ void __launch_bounds__(THREADS, 1) dw_pw_fused_kernel(const Args a) {
  extern __shared__ __align__(16) int8_t smem[];
  const Smem sm(a, smem);
  for (int i = threadIdx.x; i < a.chunks * a.oc; i += THREADS) {
    const bool in = i < a.O;
    sm.scale[i] = in ? a.pw_scale[i] : 0.0f;
    sm.bias[i] = in && a.pw_bias ? a.pw_bias[i] : (in ? -0.0f : 0.0f);
  }
  if (a.chunks == 1) weights(a, sm.wpw, 0);  // visible after the first barrier
  load_dw_consts(a, sm.dwk);
  const float rb_dw = 1.0f / a.dw_act.p1, rb_pw = 1.0f / a.pw_act.p1;
  const bool fast_dw = DW_ACT == plt::ACT_HARD_SWISH && fast_division(a.dw_act);
  const bool fast_pw = fast_division(a.pw_act);

  int t = blockIdx.x;
  Tile next = tile_at(a, t);
  fetch(a, smem, next);
  cp_async_commit();
  for (int it = 0; t < a.tiles; ++it, t += gridDim.x) {
    const int8_t* buf = smem + (it & 1) * a.slab_bytes;
    const Tile tl = next;
    const bool more = t + (int)gridDim.x < a.tiles;
    if (more) next = tile_at(a, t + gridDim.x);
    if constexpr (PIPELINED) {
      if (more) fetch(a, smem + ((it + 1) & 1) * a.slab_bytes, next);
      cp_async_commit();
      cp_async_wait<1>();  // this tile's copies are done
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    for (int q0 = 0; q0 < tl.rv * a.twp; q0 += a.sub) {
      stencil<DW_ACT>(a, buf, sm.dtile, q0, tl.rv, sm.dwk, fast_dw, rb_dw);
      for (int o0 = 0; o0 < a.O; o0 += a.oc) {
        if (a.chunks > 1) weights(a, sm.wpw, o0);  // the previous chunk's product is done
        __syncthreads();  // the sub-tile and weights are written; the stores are done
        const Sub s{tl, q0, o0};
        pointwise<OUT_I8>(a, sm, rb_pw, fast_pw, s);
        if constexpr (STAGED_STORES) {
          __syncthreads();  // the stage is written; the sub-tile is free again
          store<OUT_I8>(a, sm.stage, s);
        } else {
          __syncthreads();  // the sub-tile is free again
        }
      }
    }
    if constexpr (!PIPELINED) {
      if (more) fetch(a, smem + ((it + 1) & 1) * a.slab_bytes, next);
      cp_async_commit();
    }
  }
  cp_async_wait<0>();
}

using Kernel = void (*)(const Args);

template <bool O8>
Kernel pick_act(int act) {
  switch (act) {
    case plt::ACT_NONE: return dw_pw_fused_kernel<plt::ACT_NONE, O8>;
    case plt::ACT_RELU: return dw_pw_fused_kernel<plt::ACT_RELU, O8>;
    case plt::ACT_RELU6: return dw_pw_fused_kernel<plt::ACT_RELU6, O8>;
    case plt::ACT_LEAKY_RELU: return dw_pw_fused_kernel<plt::ACT_LEAKY_RELU, O8>;
    case plt::ACT_HARD_SWISH: return dw_pw_fused_kernel<plt::ACT_HARD_SWISH, O8>;
    case plt::ACT_HARD_SIGMOID: return dw_pw_fused_kernel<plt::ACT_HARD_SIGMOID, O8>;
    default: return nullptr;
  }
}

Kernel pick(int dw_act, int out_i8) {
  return out_i8 ? pick_act<true>(dw_act) : pick_act<false>(dw_act);
}

cudaError_t device_attr(int* to, cudaDeviceAttr attr) {
  int dev = 0;
  const cudaError_t e = cudaGetDevice(&dev);
  return e != cudaSuccess ? e : cudaDeviceGetAttribute(to, attr, dev);
}

}  // namespace

// Lets every instantiation take all the dynamic shared memory a block may
// on the current device.  The wrapper runs it once per device, when the
// library is first used there (never inside a CUDA-graph capture).
// Returns the first CUDA error, or 0.
extern "C" int plt_dw_pw_fused_prepare() {
  int optin = 0;
  cudaError_t e = device_attr(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin);
  for (int act = plt::ACT_NONE; act <= plt::ACT_HARD_SIGMOID && e == cudaSuccess; ++act)
    for (int o8 = 0; o8 <= 1 && e == cudaSuccess; ++o8)
      e = cudaFuncSetAttribute(pick(act, o8), cudaFuncAttributeMaxDynamicSharedMemorySize,
                               optin);
  return static_cast<int>(e);
}

// The kernel's layout on the current device, for ops/kernels/dw_pw_fused.plan:
// threads a block, the most blocks an SM holds by registers and threads
// (the fewest over the instantiations), the SMs, the shared bytes an SM
// has, the bytes the runtime keeps for each block, and the most one block
// may take.  Returns a CUDA error, or 0.
extern "C" int plt_dw_pw_fused_layout(int* threads, int* blocks_per_sm, int* sms,
                                      int* smem_per_sm, int* smem_reserved,
                                      int* smem_per_block) {
  cudaError_t e = device_attr(sms, cudaDevAttrMultiProcessorCount);
  if (e == cudaSuccess) e = device_attr(smem_per_sm, cudaDevAttrMaxSharedMemoryPerMultiprocessor);
  if (e == cudaSuccess) e = device_attr(smem_reserved, cudaDevAttrReservedSharedMemoryPerBlock);
  if (e == cudaSuccess) e = device_attr(smem_per_block, cudaDevAttrMaxSharedMemoryPerBlockOptin);
  int fewest = -1;
  for (int act = plt::ACT_NONE; act <= plt::ACT_HARD_SIGMOID && e == cudaSuccess; ++act)
    for (int o8 = 0; o8 <= 1 && e == cudaSuccess; ++o8) {
      int n = 0;
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, pick(act, o8), THREADS, 0);
      if (fewest < 0 || n < fewest) fewest = n;
    }
  if (e != cudaSuccess) return static_cast<int>(e);
  *threads = THREADS;
  *blocks_per_sm = fewest;
  return fewest < 1 ? static_cast<int>(cudaErrorInvalidValue) : 0;
}

// C interface, bound with ctypes.  Device pointers; `dw_bias` and `pw_bias`
// may be null; `pw_w` is (O, C).  Each activation is a plt::Act code and its
// parameters p0..p2 (epilogue.cuh).  `inv_dw` = fp32(1/dw_out_scale) and
// `inv_out` = fp32(1/out_scale), each taken in double by the caller.  The
// plan (rows, tw, twp, sub, oc, vec, out_width, shared bytes, tiles,
// blocks) comes from ops/kernels/dw_pw_fused.plan.  Returns
// cudaGetLastError() after the launch, or cudaErrorInvalidValue (1) for a
// plan, shape or pointer the kernel does not take; it never substitutes
// another plan.
extern "C" int plt_dw_pw_fused(const void* x, const void* dw_w, const void* dw_scale,
                               const void* dw_bias, int dw_act, float d0, float d1,
                               float d2, float inv_dw, const void* pw_w,
                               const void* pw_scale, const void* pw_bias, int pw_act,
                               float p0, float p1, float p2, int out_i8, float inv_out,
                               void* out, int N, int H, int W, int C, int O, int rows,
                               int tw, int twp, int sub, int oc, int vec, int out_width,
                               long long smem, int tiles, int blocks, void* stream) {
  const int invalid = static_cast<int>(cudaErrorInvalidValue);
  const Kernel kern = pick(dw_act, out_i8);
  if (kern == nullptr || pw_act < plt::ACT_NONE || pw_act > plt::ACT_HARD_SIGMOID)
    return invalid;
  if (N < 0 || H < 0 || W < 0 || O < 0 || C < 1 || C > MAX_C) return invalid;
  // requant_byte: inverse scales finite and > 0 (NaN fails both)
  if (!(inv_dw > 0.0f && inv_dw <= FLT_MAX) ||
      (out_i8 && !(inv_out > 0.0f && inv_out <= FLT_MAX)))
    return invalid;
  if ((long long)N * H * W * O == 0) return static_cast<int>(cudaGetLastError());
  const int es = out_i8 ? 1 : 4;
  auto aligned = [](const void* p, int w) { return reinterpret_cast<uintptr_t>(p) % w == 0; };
  if (rows < 1 || tw < 1 || twp != up(tw, P) || sub < SUB_STEP || sub % SUB_STEP ||
      oc < 32 || oc % 32 || !(vec == 16 || vec == 8 || vec == 4 || vec == 1) || C % vec ||
      !aligned(x, vec) || !aligned(pw_w, vec) ||
      !(out_width == 16 || out_width == 8 || out_width == 4 || out_width == 2 ||
        out_width == 1) ||
      (O * es) % out_width || (oc * es) % out_width || !aligned(out, out_width) ||
      !aligned(dw_scale, 4) || !aligned(dw_bias, 4) || !aligned(pw_scale, 4) ||
      !aligned(pw_bias, 4))
    return invalid;
  Args a;
  a.x = static_cast<const int8_t*>(x);
  a.wd = static_cast<const int8_t*>(dw_w);
  a.dw_scale = static_cast<const float*>(dw_scale);
  a.dw_bias = static_cast<const float*>(dw_bias);
  a.wp = static_cast<const int8_t*>(pw_w);
  a.pw_scale = static_cast<const float*>(pw_scale);
  a.pw_bias = static_cast<const float*>(pw_bias);
  a.out = out;
  a.N = N; a.H = H; a.W = W; a.C = C; a.O = O;
  a.dw_act = plt::ActParams{dw_act, d0, d1, d2};
  a.pw_act = plt::ActParams{pw_act, p0, p1, p2};
  a.inv_dw = inv_dw;
  a.inv_out = inv_out;
  a.rows = rows; a.tw = tw; a.twp = twp; a.sub = sub; a.oc = oc; a.vb = vec;
  a.ow = out_width;
  a.cs = up(C, 4);
  a.rs = up((twp + 2) * a.cs, 16);
  a.kp = up(C, 32);
  a.lda = a.kp + 16;
  a.ldo = out_i8 ? oc + 16 : 4 * oc + 32;
  a.chunks = cdiv(O, oc);
  a.slab_bytes = (rows + 2) * a.rs;
  const int strips = cdiv(W, tw), bands = cdiv(H, rows);
  int optin = 0;
  cudaError_t e = device_attr(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (smem != smem_bytes(a) || smem > optin) return invalid;
  // FastDiv's range: numerators below 2^20, divisors below 2^12
  const long long all_tiles = (long long)N * bands * strips;
  if (all_tiles != tiles || blocks < 1 || blocks > tiles || all_tiles >= IDX_MAX ||
      (long long)rows * twp + sub >= IDX_MAX || twp + 2 >= 4096 || strips >= 4096 ||
      bands >= 4096 || (long long)(rows + 2) * (twp + 2) * (a.cs / vec) >= IDX_MAX ||
      oc * es / out_width >= 4096 || (long long)sub * (oc * es / out_width) >= IDX_MAX)
    return invalid;
  a.tiles = tiles;
  a.strips = FastDiv(strips);
  a.bands = FastDiv(bands);
  a.twp_div = FastDiv(twp);
  a.halo_cols = FastDiv(twp + 2);
  a.cpp = FastDiv(a.cs / vec);
  a.out_pieces = FastDiv(oc * es / out_width);
  void* params[] = {&a};
  e = cudaLaunchKernel(reinterpret_cast<const void*>(kern), dim3(blocks), dim3(THREADS),
                       params, (size_t)smem, static_cast<cudaStream_t>(stream));
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}
