// int8 GEMM with a fused scale / bias / activation / requant epilogue.
//
// Replaces the Pallas kernel `_matmul_kernel` of
// paddle_lite_tpu/ops/kernels/int8_matmul.py (epilogue `_epilogue` there):
//   out[m, n] = epilogue(sum_k A[m, k] * B[k, n])   (int8 x int8 -> int32)
// A is (M, K) row-major int8; the weights arrive repacked as Bt = B^T,
// (N, K) row-major, so that both operands are K-major, the only layout
// wgmma takes for 8-bit types.  The kernel is in int8_gemm.cuh; this file
// is the C interface of its dense launches, int8_gemm_conv.cu that of its
// gathering ones (below), each built into a library of its own.
//
// What bounds it on an H100: nearly every shape of the MobileNet / SSD
// paths moves more bytes than the tensor cores need time for (K, N of
// 16..1280 at M up to 802,816: the (802816, 32, 64) layer is pure
// streaming, A in and the int8 output out); only the 3136 x {512, 1024} x
// 1024 layers sit near the int8 tensor-core ridge.  At the streaming
// shapes the epilogue's arithmetic (51 M outputs for that layer) costs as
// much as the bytes.  So the design reads A from device memory once, keeps
// copies in flight across tiles, and keeps the epilogue short:
//
// - A tile is BM x BN outputs, BM = 64 a warpgroup (one or two
//   warpgroups), BN in {8, ..., 256} by N, so that at N <= 256 there is one
//   column tile and A is read once.  Its product is wgmma.mma_async
//   m64nBNk32 s8.s8.s32 (wgmma_s8.cuh), both operands read from shared
//   memory through descriptors.
// - K is walked in slabs of BK = 32, 64 or 128 bytes (one slab where
//   K <= 128, so a K = 32 layer copies and multiplies nothing past K)
//   through a ring of STAGES slabs in shared memory.  Every thread issues
//   cp.async copies of `width` bytes (16, 8 or 4: the widest that divides
//   K; 2-byte register copies for K = 18 or 30), zero-filled past M, N and
//   K.  A block is persistent: it walks tiles gridDim.x apart, and the ring
//   runs over its (tile, slab) sequence, so the next tile's first slabs are
//   in flight while this tile's epilogue runs.
// - A slab is wgmma's swizzled K-major layout of width BK (the 32-, 64- or
//   128-byte swizzle): consecutive threads copy consecutive 16-byte pieces
//   of a row, so eight of them read 128 contiguous bytes of the matrix
//   and write one swizzle row on distinct banks.  (A first cut used the
//   unswizzled layout, eight rows of one 16-byte column to eight threads:
//   each 16-byte read was half a sector, and its copies took up to six
//   times as long.)
// - Epilogue on the int32 accumulators in registers: plt::scale_bias_act's
//   arithmetic with the activation fixed per instantiation of the loop (no
//   branch per element; hard_swish's division checked, as in the depthwise
//   kernel), scale and bias staged in shared memory per column tile, and
//   int->float, rint and float->int done without conversion instructions
//   (a sixteenth of the FP32 rate), exactly as plt::requant
//   (small_int_to_float, plt::requant_lo).  gelu (both forms) and tanh
//   share one instantiation that switches per element between them
//   (plt::ACT_TRANSCENDENTAL): their cost is tanhf / erfcf.  The int8 /
//   fp32 tile is staged in shared memory (rows padded so the fragment
//   writes are conflict-free) and written out row by row in
//   `out_width`-byte pieces (16 where the row allows, else the widest that
//   divides N's bytes), masked at the edge.
// - A third output kind, int32 (OUT_I32), stages the raw accumulator
//   tile with no scale, bias, activation or requant: the partial product
//   of a row-parallel shard (parallel/tp_cuda.py), which is summed over
//   the shards in int32 before the epilogue runs.  Its tile takes the fp32
//   tile's bytes.  It replaces no TPU kernel: the reference's row-parallel
//   path ran the fp32-out kernel at unit scales and summed fp32 partials,
//   inexact once a partial passes 2^24 (paddle_lite_tpu/parallel/
//   tp_pallas.py:111-116).
// - An optional int8 residual R, (M, N) row-major like the output, with
//   one fp32 scale s_r (a shortcut add fused into a conv): the epilogue
//   adds float(r) * s_r after the bias and before the activation, each
//   step rounded on its own as the plain epilogue orders them, r made
//   float without a conversion instruction (plt::to_f32x4).  It is a
//   compile-time flag of the instantiation (RES), for the fp32 and int8
//   outputs only, so a launch without a residual runs the code it ran
//   before.  What bounds a residual launch here: ResNet-50's shortcut
//   convs are 1x1 GEMMs at K = 64..1024 and N = 256..2048, mostly
//   streaming (at K = 64, N = 256 the residual is as many bytes as the
//   int8 output, and A a quarter of that), so R's bytes have to be in
//   flight while the tile multiplies, not fetched after it.  R is read
//   once, in 16-byte coalesced pieces where N allows (the widest of 16,
//   8, 4, 2, 1 bytes that divides N and BN), by cp.async into a ring of
//   residual tiles in the int8 output tile's padded layout (rows BN + 16
//   bytes apart, so the epilogue's 2-byte fragment reads are
//   conflict-free): a tile's residual copies go out with its last slab's,
//   STAGES - 1 slabs ahead of its epilogue, in the same commit group, so
//   the ring's wait that lands the slab lands them too.  The ring holds
//   cdiv(STAGES, slabs a tile) residual tiles: the copies for tile
//   u + slots are issued only after tile u's epilogue has read its slot.
//   A block runs its epilogue after its products, so at short K, where
//   the epilogue dominates, the plan takes tiles narrow enough for two
//   blocks an SM, one's epilogue overlapping the other's copies
//   (int8_matmul.default_plan).
// - A gathering launch (a compile-time flag CONV, for the fp32 and int8
//   outputs without a residual) is a conv's GEMM without its im2col rows:
//   A is the conv's unpadded NHWC input x, and each slab's pieces are read
//   from x at their rows' taps (copy_slab_conv), into the same swizzled
//   layout, ring and commit groups, zero-filled where a tap lies in the
//   padding as past M and K.  What bounds the conv's GEMM here: its
//   explicit rows are kh·kw times x's bytes (nine times at 3x3), written by
//   a copy and read back from device memory, while x (0.8-12.8 MB at
//   ResNet-50 b32) fits the 50 MB L2, which serves the repeated taps.  A
//   piece is W of one tap's C channels (the widest W of 16, 8, 4, 2 that
//   divides C), so consecutive threads read consecutive bytes of a tap;
//   its row's (n, oh, ow) and its tap (i, j, c) come from divisions by
//   multiplication (FastDiv), the tap once a slab, the row once a piece.
//   The products and the K order are the explicit rows', so a gathering
//   launch is bit-exact against them; a launch without CONV runs the code
//   it ran before the flag.
// - The tiling is chosen by the caller's plan (int8_matmul.plan); the host
//   side here checks it and refuses what the kernel cannot take.
#include "int8_gemm.cuh"

namespace {

// Every dense instantiation: a residual only with the fp32 and int8 outputs.
#define PLT_GEMM_KIND(FN, WGS, ...)                                            \
  switch (out_kind) {                                                          \
    case OUT_F32:                                                              \
      if (has_res) { PLT_GEMM_BN(FN, WGS, OUT_F32, true, false, __VA_ARGS__) } \
      PLT_GEMM_BN(FN, WGS, OUT_F32, false, false, __VA_ARGS__)                 \
    case OUT_I8:                                                               \
      if (has_res) { PLT_GEMM_BN(FN, WGS, OUT_I8, true, false, __VA_ARGS__) }  \
      PLT_GEMM_BN(FN, WGS, OUT_I8, false, false, __VA_ARGS__)                  \
    case OUT_I32:                                                              \
      if (has_res) return cudaErrorInvalidValue;                               \
      PLT_GEMM_BN(FN, WGS, OUT_I32, false, false, __VA_ARGS__)                 \
    default: return cudaErrorInvalidValue;                                     \
  }
#define PLT_GEMM_DISPATCH(FN, ...)                      \
  if (wgs == 1) { PLT_GEMM_KIND(FN, 1, __VA_ARGS__) }   \
  if (wgs == 2) { PLT_GEMM_KIND(FN, 2, __VA_ARGS__) }   \
  return cudaErrorInvalidValue;

cudaError_t dispatch(int bn, int wgs, int out_kind, const int8_t* A,
                     const int8_t* Bt, const float* scale, const float* bias,
                     void* out, int M, int N, int K, int bk, int width,
                     int out_width, int smem, int blocks, plt::ActParams act,
                     float inv, const int8_t* res, float res_scale, int res_width,
                     cudaStream_t s) {
  const bool has_res = res != nullptr;
  PLT_GEMM_DISPATCH(launch, A, Bt, scale, bias, out, M, N, K, bk, width,
                    out_width, smem, blocks, act, inv, res, res_scale, res_width, ConvGeom{}, s)
}

cudaError_t prepare_one(int bn, int wgs, int out_kind, bool has_res) {
  PLT_GEMM_DISPATCH(allow_smem)
}

cudaError_t occupancy_one(int bn, int wgs, int out_kind, bool has_res, int smem, int* n) {
  PLT_GEMM_DISPATCH(occupancy, smem, n)
}

// The residual's copy width: the widest piece that divides N and bn and
// that its data is aligned to.
int res_width_of(const void* res, int N, int bn) {
  for (int w = 16; w > 1; w /= 2)
    if (N % w == 0 && bn % w == 0 && aligned(res, w)) return w;
  return 1;
}

}  // namespace

// C interface, bound with ctypes.  Pointers are device pointers; `bias` may
// be null, and `scale` too where out_kind is OUT_I32 (no epilogue).
// out_kind is OUT_F32, OUT_I8 or OUT_I32.  `act` is a plt::Act code and
// p0..p2 its parameters (epilogue.cuh).  `res` is the (M, N) int8 residual
// and res_scale its scale, or null for none (never with OUT_I32).  bn, bk,
// wgs, width, out_width, smem and blocks are the caller's plan
// (int8_matmul.plan, blocks from plt_int8_gemm_occupancy); a plan the
// kernel cannot take returns cudaErrorInvalidValue without launching.
// Returns cudaGetLastError() after the launch.
extern "C" int plt_int8_gemm(const void* A, const void* Bt, const void* scale,
                             const void* bias, void* out, int M, int N, int K,
                             int act, float p0, float p1, float p2, int out_kind,
                             float inv_out_scale, const void* res, float res_scale,
                             int bn, int bk, int wgs, int width, int out_width, int smem,
                             int blocks, void* stream) {
  if (!plan_ok(A, Bt, out, res, M, N, K, out_kind, bn, bk, wgs, width, out_width,
               smem, blocks))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t rc = dispatch(
      bn, wgs, out_kind, static_cast<const int8_t*>(A),
      static_cast<const int8_t*>(Bt), static_cast<const float*>(scale),
      static_cast<const float*>(bias), out, M, N, K, bk, width, out_width,
      smem, blocks, plt::ActParams{act, p0, p1, p2}, inv_out_scale,
      static_cast<const int8_t*>(res), res_scale, res ? res_width_of(res, N, bn) : 0,
      static_cast<cudaStream_t>(stream));
  if (rc != cudaSuccess) return static_cast<int>(rc);
  return static_cast<int>(cudaGetLastError());
}

// Blocks of one instantiation (`residual` nonzero: the one with a
// residual) that an SM of the current device holds at `smem` shared bytes
// a block.
extern "C" int plt_int8_gemm_occupancy(int bn, int wgs, int out_kind, int residual,
                                       int smem, int* blocks_per_sm) {
  return static_cast<int>(
      occupancy_one(bn, wgs, out_kind, residual != 0, smem, blocks_per_sm));
}

// The shared-memory limit of every instantiation, for the current device:
// run once per device before its first launch.
extern "C" int plt_int8_gemm_prepare() {
  const int bns[] = {8, 16, 32, 64, 128, 256};
  for (int wgs = 1; wgs <= 2; ++wgs)
    for (int out_kind = OUT_F32; out_kind <= OUT_I32; ++out_kind)
      for (int has_res = 0; has_res <= (out_kind == OUT_I32 ? 0 : 1); ++has_res)
        for (int bn : bns) {
          const cudaError_t rc = prepare_one(bn, wgs, out_kind, has_res != 0);
          if (rc != cudaSuccess) return static_cast<int>(rc);
        }
  return 0;
}
