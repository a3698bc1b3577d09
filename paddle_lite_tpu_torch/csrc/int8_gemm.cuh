// The int8 GEMM kernel, int8_gemm_kernel, and what its two libraries
// share: int8_gemm.cu's launches read A as an (M, K) row-major matrix;
// int8_gemm_conv.cu's (CONV) gather A, a conv's im2col rows, straight from
// the conv's unpadded NHWC input.  int8_gemm.cu's header note says what
// bounds the kernel on an H100 and how its design answers that.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "epilogue.cuh"
#include "wgmma_s8.cuh"

namespace {

constexpr int STAGES = 4;
// the output kinds: fp32 and int8 after the epilogue, the raw int32 accumulator
constexpr int OUT_F32 = 0, OUT_I8 = 1, OUT_I32 = 2;
constexpr int SMEM_LIMIT = 232448;  // shared bytes a block may use (sm_90)

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// wgmma descriptor of a K-major operand at shared address `addr` in the
// swizzled layout of a bk-byte slab (bk = 32, 64 or 128: the 32-, 64- or
// 128-byte swizzle, layout types 3, 2, 1), 8-row groups 8 * bk bytes apart
// (SBO); LBO is unused for swizzled K-major operands.
__device__ __forceinline__ uint64_t desc(uint32_t addr, int bk) {
  const uint64_t layout = bk == 128 ? 1 : bk == 64 ? 2 : 3;
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (1ull << 16) |
         (static_cast<uint64_t>((8 * bk) >> 4) << 32) | (layout << 62);
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// x / d for 0 <= x < 2^31 by a multiply-high, an add and a shift
// (Granlund and Montgomery, "Division by invariant integers using
// multiplication", 1994, theorem 4.2): s = ceil(log2 d), mul = floor(2^32
// (2^s - d) / d) + 1, q = (umulhi(x, mul) + x) >> s, the sum below 2^32
// while x < 2^31; a power of two d gives mul = 1, x >> s.
// tests/test_torch_conv_gather.py computes the same pair in Python and
// holds it to floor division.
struct FastDiv {
  uint32_t mul;
  int shift;
  __device__ __forceinline__ int div(int x) const {
    const uint32_t u = static_cast<uint32_t>(x);
    return static_cast<int>((__umulhi(u, mul) + u) >> shift);
  }
};

inline FastDiv fast_div(int d) {
  int s = 0;
  while ((1LL << s) < d) ++s;
  return FastDiv{static_cast<uint32_t>((((1ULL << s) - d) << 32) / d + 1), s};
}

// A conv's geometry as a gathering launch reads it: the unpadded NHWC
// input's H, W and C, the window's width, the output's OH and OW, the
// strides and the top and left paddings (the bottom and right ones lie in
// OH and OW), and the divisors of a column by C and of a tap by kw, and of
// a row by OW and of that by OH.
struct ConvGeom {
  int h, w, c, kw, oh, ow, sh, sw, pt, pl;
  FastDiv div_c, div_kw, div_ow, div_oh;
};

// One W-byte piece from global `g` to shared byte `off` of the slab at
// shared address `base` (`dst` generic), or W zero bytes where !in.
// cp.async takes 16, 8 and 4 bytes; 2 go through registers.
template <int W>
__device__ __forceinline__ void copy_piece(int8_t* dst, uint32_t base, int off,
                                           const int8_t* g, bool in) {
  if constexpr (W == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
                 ::"r"(base + off), "l"(g), "r"(in ? 16 : 0) : "memory");
  } else if constexpr (W == 8 || W == 4) {
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n"
                 ::"r"(base + off), "l"(g), "n"(W), "r"(in ? W : 0)
                 : "memory");
  } else {  // 2: cp.async has no 2-byte form
    *reinterpret_cast<uint16_t*>(dst + off) =
        in ? __ldg(reinterpret_cast<const uint16_t*>(g)) : uint16_t(0);
  }
}

// Copy rows [r0, r0 + rows) x bytes [k0, k0 + bk) of a (R, K) row-major
// int8 matrix into a slab, in W-byte pieces, zero-filled past R and K
// (K % W == 0, so a piece is wholly in or wholly out).  The slab is
// wgmma's swizzled K-major layout: row r at r * bk bytes, its 16-byte
// chunk c at chunk c ^ ((r * bk / 128) % (bk / 16)).  Consecutive threads
// take consecutive pieces of a row, so eight of them read 128 contiguous
// bytes of the matrix (whole rows where bk < 128 and bk == K) and write
// 128 bytes of one swizzle row, on distinct banks.
template <int W, int THREADS>
__device__ __forceinline__ void copy_slab(int8_t* dst, const int8_t* src,
                                          int r0, int rows, int R, int k0,
                                          int bk_log2, int K) {
  constexpr int W_LOG2 = W == 16 ? 4 : W == 8 ? 3 : W == 4 ? 2 : 1;
  const int bk = 1 << bk_log2, per_row_log2 = bk_log2 - W_LOG2;
  const int pieces = rows << per_row_log2;
  const int swz = bk / 16 - 1;
  const uint32_t base = smem_u32(dst);
  for (int p = threadIdx.x; p < pieces; p += THREADS) {
    const int r = p >> per_row_log2, k = (p & ((1 << per_row_log2) - 1)) * W;
    const int chunk = (k >> 4) ^ (((r << bk_log2) >> 7) & swz);
    const int off = (r << bk_log2) + (chunk << 4) + (k & 15);
    const int gr = r0 + r, gk = k0 + k;
    const bool in = gr < R && gk < K;
    const int8_t* g = in ? src + (size_t)gr * K + gk : src;
    copy_piece<W>(dst, base, off, g, in);
  }
}

// A gathering launch's A slab: rows [r0, r0 + rows) x bytes [k0, k0 + bk)
// of a conv's (R, K) im2col rows, R = N·OH·OW, K = kh·kw·C, without the
// rows: row r = (n, oh, ow) and byte k = (tap i·kw + j, channel c) are
// x[n, oh·sh − pt + i, ow·sw − pl + j, c] of the unpadded NHWC input x,
// zero where that lies in the padding, past R or past K.  copy_slab's
// pieces, layout and order: a piece is W of one tap's C channels (C % W ==
// 0), so consecutive threads read consecutive bytes of a tap, and at
// stride 1 neighbouring rows' taps lie side by side in x.  A thread copies
// the same byte k of a slab in every piece (THREADS is a multiple of the
// pieces a row), so its tap and channel are worked out once a slab; each
// piece works out its row's (n, oh, ow) from r0 + r by two divisions.
template <int W, int THREADS>
__device__ __forceinline__ void copy_slab_conv(int8_t* dst, const int8_t* x,
                                               const ConvGeom& g, int r0, int rows, int R,
                                               int k0, int bk_log2, int K) {
  constexpr int W_LOG2 = W == 16 ? 4 : W == 8 ? 3 : W == 4 ? 2 : 1;
  const int bk = 1 << bk_log2, per_row_log2 = bk_log2 - W_LOG2;
  const int pieces = rows << per_row_log2;
  const int swz = bk / 16 - 1;
  const uint32_t base = smem_u32(dst);
  const int k = (threadIdx.x & ((1 << per_row_log2) - 1)) * W, gk = k0 + k;
  const int tap = g.div_c.div(gk), c = gk - tap * g.c;
  const int i = g.div_kw.div(tap);
  const int di = i - g.pt, dj = tap - i * g.kw - g.pl;
  const bool k_in = gk < K;
  for (int p = threadIdx.x; p < pieces; p += THREADS) {
    const int r = p >> per_row_log2;
    const int chunk = (k >> 4) ^ (((r << bk_log2) >> 7) & swz);
    const int off = (r << bk_log2) + (chunk << 4) + (k & 15);
    const int gr = r0 + r, q = g.div_ow.div(gr), n = g.div_oh.div(q);
    const int ih = (q - n * g.oh) * g.sh + di, iw = (gr - q * g.ow) * g.sw + dj;
    const bool in = k_in && gr < R && static_cast<unsigned>(ih) < static_cast<unsigned>(g.h) &&
                    static_cast<unsigned>(iw) < static_cast<unsigned>(g.w);
    const int8_t* src = in ? x + ((size_t)(n * g.h + ih) * g.w + iw) * g.c + c : x;
    copy_piece<W>(dst, base, off, src, in);
  }
}

// A's slab: copy_slab's rows of the matrix A, or with CONV
// copy_slab_conv's gather of the conv `g`'s rows from its input A.
template <int W, int THREADS, bool CONV>
__device__ __forceinline__ void copy_a(int8_t* dst, const int8_t* A, const ConvGeom& g,
                                       int r0, int rows, int R, int k0, int bk_log2, int K) {
  if constexpr (CONV) {
    copy_slab_conv<W, THREADS>(dst, A, g, r0, rows, R, k0, bk_log2, K);
  } else {
    copy_slab<W, THREADS>(dst, A, r0, rows, R, k0, bk_log2, K);
  }
}

template <int R>
__device__ __forceinline__ void fence_acc(int (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

template <int OUT, int BN>
__host__ __device__ constexpr int staged_ld() {  // bytes of a staged output row
  return OUT == OUT_I8 ? BN + 16 : 4 * BN + 32;
}

// Residual tiles in a block's ring: cdiv(STAGES, slabs a tile), so that
// the copies for tile u + slots go out (STAGES - 1 slabs ahead of that
// tile's epilogue) only after tile u's epilogue has read its slot.
__host__ __device__ inline int res_slots(int K, int bk) {
  const int per_tile = (K + bk - 1) / bk;
  return (STAGES + per_tile - 1) / per_tile;
}

// Shared bytes of a block: the ring of STAGES slabs, the staged output
// tile (an int32 tile as an fp32 one), BN scales and BN biases, then `rs`
// residual tiles of bm rows of bn + 16 bytes (0 without a residual).
__host__ __device__ inline int smem_bytes(int bm, int bn, int bk, int out_kind, int rs) {
  return STAGES * (bm + bn) * bk + bm * (out_kind == OUT_I8 ? bn + 16 : 4 * bn + 32) +
         8 * bn + rs * bm * (bn + 16);
}

// Copy rows [r0, r0 + rows) x bytes [c0, c0 + COLS) of an (R, N) row-major
// int8 matrix into a tile whose rows are ld bytes apart, in W-byte pieces,
// zero-filled past R and N (N % W == 0, so a piece is wholly in or out):
// consecutive threads on consecutive pieces of a row.  cp.async takes 16,
// 8 and 4 bytes; 2 and 1 go through registers.
template <int W, int THREADS, int COLS>
__device__ __forceinline__ void copy_rows(int8_t* dst, const int8_t* src, int r0, int rows,
                                          int R, int c0, int N, int ld) {
  if constexpr (W > COLS) return;  // never launched: the host's width divides BN
  constexpr int PER_ROW = W > COLS ? 1 : COLS / W;
  const uint32_t base = smem_u32(dst);
  for (int p = threadIdx.x; p < rows * PER_ROW; p += THREADS) {
    const int r = p / PER_ROW, c = (p % PER_ROW) * W;
    const int gr = r0 + r, gc = c0 + c, off = r * ld + c;
    const bool in = gr < R && gc < N;
    const int8_t* g = in ? src + (size_t)gr * N + gc : src;
    if constexpr (W == 16) {
      asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
                   ::"r"(base + off), "l"(g), "r"(in ? 16 : 0) : "memory");
    } else if constexpr (W == 8 || W == 4) {
      asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n"
                   ::"r"(base + off), "l"(g), "n"(W), "r"(in ? W : 0)
                   : "memory");
    } else if constexpr (W == 2) {
      *reinterpret_cast<uint16_t*>(dst + off) =
          in ? __ldg(reinterpret_cast<const uint16_t*>(g)) : uint16_t(0);
    } else {
      dst[off] = in ? __ldg(g) : int8_t(0);
    }
  }
}

// plt::small_int_to_float is exact for every accumulator of a K <= 256
// product (epilogue.cuh); past that the conversion instruction
constexpr int SMALL_K = 256;

// The accumulators as float bits, in place: one uniform branch for the
// tile, so the epilogue's code exists once for both conversions.
template <int R>
__device__ __forceinline__ void to_float_bits(int (&acc)[R], bool small) {
  if (small) {
#pragma unroll
    for (int r = 0; r < R; ++r) acc[r] = __float_as_int(plt::small_int_to_float(acc[r]));
  } else {
#pragma unroll
    for (int r = 0; r < R; ++r) acc[r] = __float_as_int(static_cast<float>(acc[r]));
  }
}

// The epilogue of one tile into the staged tile: the accumulator fragment
// of warp w of warpgroup g is rows 64g + 16w + lane/4 (+ 8), and
// d[4j + 2h + e] is row lane/4 + 8h, column 8j + 2(lane%4) + e.  ACT is
// fixed here so that the tile's BN/2 outputs a thread computes are one
// branch-free stretch of code; `acc` holds the accumulators already as
// float bits (to_float_bits).  y = acc * scale (+ bias) is
// plt::scale_bias_act's arithmetic; the activation is
// plt::act_value's (hard_swish's division checked with FAST: returns true
// where a dividend left its range, and the caller redoes the thread's
// outputs without it); the int8 out is plt::requant's, from
// plt::requant_lo's low byte.  With RES, float(r) * s_r is added after
// the bias, r read from the residual tile `res` (rows BN + 16 bytes apart)
// at the fragment's own row and columns.
template <int ACT, bool FAST, int BN, bool I8, bool RES, int R>
__device__ __forceinline__ bool stage_tile(int8_t* staged, const int (&acc)[R],
                                           const float* s_scale,
                                           const float* s_bias, bool has_bias,
                                           const plt::ActParams& act, float rb,
                                           float inv_out_scale, const int8_t* res,
                                           float res_scale) {
  constexpr int LD = staged_ld<I8 ? OUT_I8 : OUT_F32, BN>(), RLD = BN + 16;
  const int lane = threadIdx.x & 31;
  const int row0 = (threadIdx.x >> 7) * 64 + ((threadIdx.x >> 5) & 3) * 16 + (lane >> 2);
  bool bad = false;
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
    const int col = 8 * j + 2 * (lane & 3);
    const float2 sc = *reinterpret_cast<const float2*>(s_scale + col);
    const float2 bi = *reinterpret_cast<const float2*>(s_bias + col);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float y0 = __int_as_float(acc[4 * j + 2 * h]) * sc.x;
      float y1 = __int_as_float(acc[4 * j + 2 * h + 1]) * sc.y;
      y0 = has_bias ? y0 + bi.x : y0;
      y1 = has_bias ? y1 + bi.y : y1;
      if constexpr (RES) {
        float r[4];
        plt::to_f32x4(*reinterpret_cast<const uint16_t*>(res + (row0 + 8 * h) * RLD + col),
                      r);
        y0 = y0 + r[0] * res_scale;
        y1 = y1 + r[1] * res_scale;
      }
      y0 = plt::act_value<ACT, FAST>(y0, act, rb, bad);
      y1 = plt::act_value<ACT, FAST>(y1, act, rb, bad);
      int8_t* s = staged + (row0 + 8 * h) * LD;
      if (I8) {
        *reinterpret_cast<uint16_t*>(s + col) = static_cast<uint16_t>(__byte_perm(
            plt::requant_lo(y0, inv_out_scale), plt::requant_lo(y1, inv_out_scale), 0x0040));
      } else {
        *reinterpret_cast<float2*>(s + 4 * col) = make_float2(y0, y1);
      }
    }
  }
  return bad;
}

// The raw accumulators of one tile into the staged tile (OUT_I32), in the
// fragment layout stage_tile reads.
template <int BN, int R>
__device__ __forceinline__ void stage_acc(int8_t* staged, const int (&acc)[R]) {
  constexpr int LD = staged_ld<OUT_I32, BN>();
  const int lane = threadIdx.x & 31;
  const int row0 = (threadIdx.x >> 7) * 64 + ((threadIdx.x >> 5) & 3) * 16 + (lane >> 2);
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
    const int col = 8 * j + 2 * (lane & 3);
#pragma unroll
    for (int h = 0; h < 2; ++h)
      *reinterpret_cast<int2*>(staged + (row0 + 8 * h) * LD + 4 * col) =
          make_int2(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
  }
}

template <int ACT, int BN, bool I8, bool RES, int R>
__device__ __forceinline__ void stage_tile_checked(int8_t* staged, const int (&acc)[R],
                                                   const float* s_scale,
                                                   const float* s_bias, bool has_bias,
                                                   const plt::ActParams& act,
                                                   float rb, bool fast_div, float inv,
                                                   const int8_t* res, float res_scale) {
  if constexpr (ACT == plt::ACT_HARD_SWISH) {
    if (fast_div && !stage_tile<ACT, true, BN, I8, RES>(staged, acc, s_scale, s_bias,
                                                        has_bias, act, rb, inv, res,
                                                        res_scale))
      return;
  }
  stage_tile<ACT, false, BN, I8, RES>(staged, acc, s_scale, s_bias, has_bias, act, rb, inv,
                                      res, res_scale);
}

template <int BN, bool I8, bool RES, int R>
__device__ __forceinline__ void stage_tile_act(int8_t* staged, const int (&acc)[R],
                                               const float* s_scale,
                                               const float* s_bias, bool has_bias,
                                               const plt::ActParams& act, float rb,
                                               bool fast_div, float inv, const int8_t* res,
                                               float res_scale) {
  switch (act.code) {
#define PLT_STAGE(A)                                                             \
  case A:                                                                        \
    return stage_tile_checked<A, BN, I8, RES>(staged, acc, s_scale, s_bias,      \
                                              has_bias, act, rb, fast_div, inv,  \
                                              res, res_scale);
    PLT_STAGE(plt::ACT_RELU)
    PLT_STAGE(plt::ACT_RELU6)
    PLT_STAGE(plt::ACT_LEAKY_RELU)
    PLT_STAGE(plt::ACT_HARD_SWISH)
    PLT_STAGE(plt::ACT_HARD_SIGMOID)
#undef PLT_STAGE
    case plt::ACT_GELU_TANH:
    case plt::ACT_GELU_ERF:
    case plt::ACT_TANH:
      return stage_tile_checked<plt::ACT_TRANSCENDENTAL, BN, I8, RES>(
          staged, acc, s_scale, s_bias, has_bias, act, rb, fast_div, inv, res, res_scale);
    default:
      return stage_tile_checked<plt::ACT_NONE, BN, I8, RES>(
          staged, acc, s_scale, s_bias, has_bias, act, rb, fast_div, inv, res, res_scale);
  }
}

// The staged tile's rows [0, rows) x bytes [0, valid) out to `o` (rows
// row_bytes apart) in OW-byte pieces, consecutive threads on consecutive
// pieces of a row.
template <int OW, int LD, int THREADS>
__device__ __forceinline__ void store_tile(int8_t* o, const int8_t* staged,
                                           int rows, int valid,
                                           int row_bytes) {
  using V = typename std::conditional<OW == 16, int4, typename std::conditional<
      OW == 8, int2, typename std::conditional<OW == 4, int, typename std::conditional<
      OW == 2, short, int8_t>::type>::type>::type>::type;
  const int per_row = valid / OW;
  for (int p = threadIdx.x; p < rows * per_row; p += THREADS) {
    const int r = p / per_row, c = (p - r * per_row) * OW;
    *reinterpret_cast<V*>(o + (size_t)r * row_bytes + c) =
        *reinterpret_cast<const V*>(staged + r * LD + c);
  }
}

// A persistent block walks tiles blockIdx.x, + gridDim.x, ... (column
// tiles fastest).  The ring runs over the block's (tile, slab) sequence,
// so the copies of the next tile's first slabs are in flight while this
// tile's epilogue runs.  With RES, a tile's residual is copied with its
// last slab into slot (tile ordinal) % res_slots of the residual ring, in
// res_width-byte pieces.  With CONV, A is the conv `geom`'s im2col rows,
// gathered from x = A (copy_slab_conv); without, the copies and the code
// are those of the kernel before the flag.
template <int BN, int WGS, int OUT, bool RES, bool CONV>
__global__ void __launch_bounds__(128 * WGS)
int8_gemm_kernel(const int8_t* __restrict__ A, const int8_t* __restrict__ Bt,
                 const float* __restrict__ scale,
                 const float* __restrict__ bias, void* __restrict__ out,
                 int M, int N, int K, int bk, int width, int out_width,
                 plt::ActParams act, float inv_out_scale,
                 const int8_t* __restrict__ res, float res_scale, int res_width,
                 ConvGeom geom) {
  constexpr int BM = 64 * WGS, THREADS = 128 * WGS, R = BN / 2;
  constexpr int LD = staged_ld<OUT, BN>(), ES = OUT == OUT_I8 ? 1 : 4;
  constexpr int RLD = BN + 16;  // a residual tile's row bytes
  extern __shared__ __align__(1024) int8_t smem[];
  const int a_bytes = BM * bk, slab_bytes = (BM + BN) * bk;
  const int bk_log2 = bk == 128 ? 7 : bk == 64 ? 6 : 5;
  int8_t* staged = smem + STAGES * slab_bytes;
  float* s_scale = reinterpret_cast<float*>(staged + BM * LD);
  float* s_bias = s_scale + BN;
  int8_t* res_ring = reinterpret_cast<int8_t*>(s_bias + BN);
  const int tid = threadIdx.x, wg = tid >> 7;
  const int tiles_n = (N + BN - 1) / BN;
  const int tiles = tiles_n * ((M + BM - 1) / BM);
  const int per_tile = (K + bk - 1) / bk;
  const int mine = (int)blockIdx.x < tiles
                       ? (tiles - (int)blockIdx.x + (int)gridDim.x - 1) / (int)gridDim.x
                       : 0;
  const int total = mine * per_tile;  // slabs this block multiplies
  const int rs = RES ? res_slots(K, bk) : 1;

  auto load = [&](int i) {
    const int t = blockIdx.x + (i / per_tile) * gridDim.x, kt = i % per_tile;
    const int m0 = (t / tiles_n) * BM, n0 = (t % tiles_n) * BN, k0 = kt * bk;
    int8_t* s = smem + (i % STAGES) * slab_bytes;
    switch (width) {
      case 16:
        copy_a<16, THREADS, CONV>(s, A, geom, m0, BM, M, k0, bk_log2, K);
        copy_slab<16, THREADS>(s + a_bytes, Bt, n0, BN, N, k0, bk_log2, K);
        break;
      case 8:
        copy_a<8, THREADS, CONV>(s, A, geom, m0, BM, M, k0, bk_log2, K);
        copy_slab<8, THREADS>(s + a_bytes, Bt, n0, BN, N, k0, bk_log2, K);
        break;
      case 4:
        copy_a<4, THREADS, CONV>(s, A, geom, m0, BM, M, k0, bk_log2, K);
        copy_slab<4, THREADS>(s + a_bytes, Bt, n0, BN, N, k0, bk_log2, K);
        break;
      default:
        copy_a<2, THREADS, CONV>(s, A, geom, m0, BM, M, k0, bk_log2, K);
        copy_slab<2, THREADS>(s + a_bytes, Bt, n0, BN, N, k0, bk_log2, K);
    }
    if constexpr (RES) {
      if (kt == per_tile - 1) {  // the tile's residual, in its last slab's group
        int8_t* r = res_ring + ((i / per_tile) % rs) * (BM * RLD);
        switch (res_width) {
          case 16: copy_rows<16, THREADS, BN>(r, res, m0, BM, M, n0, N, RLD); break;
          case 8: copy_rows<8, THREADS, BN>(r, res, m0, BM, M, n0, N, RLD); break;
          case 4: copy_rows<4, THREADS, BN>(r, res, m0, BM, M, n0, N, RLD); break;
          case 2: copy_rows<2, THREADS, BN>(r, res, m0, BM, M, n0, N, RLD); break;
          default: copy_rows<1, THREADS, BN>(r, res, m0, BM, M, n0, N, RLD);
        }
      }
    }
  };

  int acc[R];
  int scale_n0 = -1;  // the column tile whose scales are in shared memory
  // hard_swish's divisor, its reciprocal, and whether the checked division
  // holds for it (plt::act_value)
  const float rb = 1.0f / act.p1;
  const bool fast_div = act.code == plt::ACT_HARD_SWISH &&
                        fabsf(act.p1) >= 0x1p-60f && fabsf(act.p1) <= 0x1p60f;
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < total) load(s);
    cp_async_commit();
  }
  for (int i = 0; i < total; ++i) {
    const int kt = i % per_tile;
    if (kt == 0) {
#pragma unroll
      for (int r = 0; r < R; ++r) acc[r] = 0;
    }
    cp_async_wait<STAGES - 2>();  // this thread's copies of slab i landed
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();              // everyone's have; slab i - 1 is free
    const int8_t* s = smem + (i % STAGES) * slab_bytes;
    const uint32_t a = smem_u32(s + wg * 64 * bk), b = smem_u32(s + a_bytes);
    fence_acc(acc);
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
    for (int k = 0; k < bk; k += 32)
      plt::Wgmma<BN>::mma(acc, desc(a + k, bk), desc(b + k, bk));
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
    if (i + STAGES - 1 < total) load(i + STAGES - 1);  // into slab i - 1's slot
    cp_async_commit();
    asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
    fence_acc(acc);
    if (kt != per_tile - 1) continue;

    // the tile's epilogue (the last slab's barrier above orders it after
    // the previous tile's stores and scale reads)
    const int t = blockIdx.x + (i / per_tile) * gridDim.x;
    const int m0 = (t / tiles_n) * BM, n0 = (t % tiles_n) * BN;
    if (OUT != OUT_I32 && n0 != scale_n0) {  // the column tile's scales and biases
      for (int c = tid; c < BN; c += THREADS) {
        const bool in = n0 + c < N;
        s_scale[c] = in ? scale[n0 + c] : 0.0f;
        s_bias[c] = in && bias ? bias[n0 + c] : 0.0f;
      }
      scale_n0 = n0;
      __syncthreads();
    }
    if constexpr (OUT == OUT_I32) {
      stage_acc<BN>(staged, acc);
    } else {
      to_float_bits(acc, K <= SMALL_K);
      stage_tile_act<BN, OUT == OUT_I8, RES>(
          staged, acc, s_scale, s_bias, bias != nullptr, act, rb, fast_div, inv_out_scale,
          res_ring + ((i / per_tile) % rs) * (BM * RLD), res_scale);
    }
    __syncthreads();
    const int rows = M - m0 < BM ? M - m0 : BM;
    const int valid = (N - n0 < BN ? N - n0 : BN) * ES;  // a multiple of out_width
    int8_t* o = static_cast<int8_t*>(out) + ((size_t)m0 * N + n0) * ES;
    switch (out_width) {
      case 16: store_tile<16, LD, THREADS>(o, staged, rows, valid, N * ES); break;
      case 8: store_tile<8, LD, THREADS>(o, staged, rows, valid, N * ES); break;
      case 4: store_tile<4, LD, THREADS>(o, staged, rows, valid, N * ES); break;
      case 2: store_tile<2, LD, THREADS>(o, staged, rows, valid, N * ES); break;
      default: store_tile<1, LD, THREADS>(o, staged, rows, valid, N * ES);
    }
  }
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

template <int BN, int WGS, int OUT, bool RES, bool CONV>
cudaError_t launch(const int8_t* A, const int8_t* Bt, const float* scale,
                   const float* bias, void* out, int M, int N, int K, int bk,
                   int width, int out_width, int smem, int blocks,
                   plt::ActParams act, float inv, const int8_t* res,
                   float res_scale, int res_width, const ConvGeom& geom,
                   cudaStream_t stream) {
  int8_gemm_kernel<BN, WGS, OUT, RES, CONV><<<blocks, 128 * WGS, smem, stream>>>(
      A, Bt, scale, bias, out, M, N, K, bk, width, out_width, act, inv, res, res_scale,
      res_width, geom);
  return cudaSuccess;
}

template <int BN, int WGS, int OUT, bool RES, bool CONV>
cudaError_t occupancy(int smem, int* blocks_per_sm) {
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks_per_sm, int8_gemm_kernel<BN, WGS, OUT, RES, CONV>, 128 * WGS, smem);
}

template <int BN, int WGS, int OUT, bool RES, bool CONV>
cudaError_t allow_smem() {
  return cudaFuncSetAttribute(int8_gemm_kernel<BN, WGS, OUT, RES, CONV>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              SMEM_LIMIT);
}

// fn<BN, WGS, OUT, RES, CONV>(args...) at the plan's tile width bn
#define PLT_GEMM_BN(FN, WGS, O, RS, CV, ...)                     \
  switch (bn) {                                                  \
    case 8: return FN<8, WGS, O, RS, CV>(__VA_ARGS__);           \
    case 16: return FN<16, WGS, O, RS, CV>(__VA_ARGS__);         \
    case 32: return FN<32, WGS, O, RS, CV>(__VA_ARGS__);         \
    case 64: return FN<64, WGS, O, RS, CV>(__VA_ARGS__);         \
    case 128: return FN<128, WGS, O, RS, CV>(__VA_ARGS__);       \
    case 256: return FN<256, WGS, O, RS, CV>(__VA_ARGS__);       \
    default: return cudaErrorInvalidValue;                       \
  }

bool aligned(const void* p, int w) { return reinterpret_cast<uintptr_t>(p) % w == 0; }

bool plan_ok(const void* A, const void* Bt, const void* out, const void* res, int M,
             int N, int K, int out_kind, int bn, int bk, int wgs, int width,
             int out_width, int smem, int blocks) {
  const int es = out_kind == OUT_I8 ? 1 : 4;
  const long long tiles = (long long)((N + bn - 1) / bn) * ((M + 64 * wgs - 1) / (64 * wgs));
  return M > 0 && N > 0 && K > 0 && (wgs == 1 || wgs == 2) &&
         (out_kind == OUT_F32 || out_kind == OUT_I8 || out_kind == OUT_I32) &&
         (bk == 32 || bk == 64 || bk == 128) &&
         (width == 16 || width == 8 || width == 4 || width == 2) &&
         K % width == 0 && bk % width == 0 && aligned(A, width) &&
         aligned(Bt, width) &&
         (out_width == 16 || out_width == 8 || out_width == 4 ||
          out_width == 2 || out_width == 1) &&
         (N * es) % out_width == 0 && (bn * es) % out_width == 0 &&
         aligned(out, out_width) && tiles < (1LL << 31) &&
         blocks >= 1 && blocks <= tiles && (res == nullptr || out_kind != OUT_I32) &&
         smem == smem_bytes(64 * wgs, bn, bk, out_kind, res ? res_slots(K, bk) : 0) &&
         smem <= SMEM_LIMIT;
}

}  // namespace
