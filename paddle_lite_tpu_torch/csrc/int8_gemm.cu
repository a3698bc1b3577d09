// int8 GEMM with a fused scale / bias / activation / requant epilogue.
//
// Replaces the Pallas kernel `_matmul_kernel` of
// paddle_lite_tpu/ops/kernels/int8_matmul.py (epilogue `_epilogue` there):
//   out[m, n] = epilogue(sum_k A[m, k] * B[k, n])   (int8 x int8 -> int32)
// A is (M, K) row-major int8; the weights arrive repacked as Bt = B^T,
// (N, K) row-major, so that both operands are K-contiguous, the layout
// mma.sync's "row.col" form reads.
//
// Design: one 128x64 output tile per block of 8 warps (4 along M, 2 along
// N, 32x32 each).  K is walked in 64-byte slabs: the block copies an A and
// a Bt slab into shared memory (16-byte vector loads when K % 16 == 0,
// bytes otherwise, zero-filled past M, N and K), then each warp issues
// mma.sync.m16n8k32 s8.s8.s32 on its 32x32 sub-tile (the fragment code is
// in mma_s8.cuh, shared with dw_pw_fused.cu).  Rows of the shared slabs are
// padded by 16 bytes so the fragment reads of one warp touch 32 distinct
// banks.  The epilogue runs on the int32 accumulators in registers
// and writes each output element once.
//
// What bounds it on an H100: the MobileNetV1 pointwise layers have K, N of
// 32..1024, so most of them move more bytes than the tensor cores need
// time for (the (802816, 32, 64) layer is pure streaming); the deepest ones
// (K = N = 1024) are near the int8 tensor-core ridge.  This first version
// keeps one slab in flight (load, sync, compute) and stores int8 outputs a
// byte at a time, so it runs far from either bound; coalesced stores, a
// cp.async / TMA pipeline and wgmma are the next steps.
#include <cuda_runtime.h>
#include <stdint.h>

#include "epilogue.cuh"
#include "mma_s8.cuh"

namespace {

constexpr int BM = 128;
constexpr int BN = 64;
constexpr int BK = 64;
constexpr int LDS = BK + 16;  // shared-memory row stride in bytes
constexpr int THREADS = 256;

// Copy a rows x BK slab of a (R, K) row-major int8 matrix into shared memory.
template <bool VEC, int ROWS>
__device__ __forceinline__ void load_slab(int8_t* dst, const int8_t* src,
                                          int r0, int R, int k0, int K) {
  if (VEC) {
    constexpr int CHUNKS = ROWS * BK / 16;
    for (int c = threadIdx.x; c < CHUNKS; c += THREADS) {
      const int r = c / (BK / 16);
      const int kc = (c % (BK / 16)) * 16;
      const int gr = r0 + r, gk = k0 + kc;
      int4 v = make_int4(0, 0, 0, 0);
      if (gr < R && gk < K)
        v = *reinterpret_cast<const int4*>(src + (size_t)gr * K + gk);
      *reinterpret_cast<int4*>(dst + r * LDS + kc) = v;
    }
  } else {
    for (int c = threadIdx.x; c < ROWS * BK; c += THREADS) {
      const int r = c / BK, kk = c % BK;
      const int gr = r0 + r, gk = k0 + kk;
      dst[r * LDS + kk] = (gr < R && gk < K) ? src[(size_t)gr * K + gk] : 0;
    }
  }
}

template <bool VEC, bool OUT_I8, bool HAS_BIAS>
__global__ void __launch_bounds__(THREADS)
int8_gemm_kernel(const int8_t* __restrict__ A, const int8_t* __restrict__ Bt,
                 const float* __restrict__ scale,
                 const float* __restrict__ bias, void* __restrict__ out,
                 int M, int N, int K, plt::ActParams act,
                 float inv_out_scale) {
  __shared__ __align__(16) int8_t As[BM * LDS];
  __shared__ __align__(16) int8_t Bs[BN * LDS];

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wm = warp >> 1, wn = warp & 1;
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BN;

  int acc[2][4][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0;

  for (int k0 = 0; k0 < K; k0 += BK) {
    load_slab<VEC, BM>(As, A, m0, M, k0, K);
    load_slab<VEC, BN>(Bs, Bt, n0, N, k0, K);
    __syncthreads();
    plt::warp_mma_32x32(acc, As + wm * 32 * LDS, LDS, Bs + wn * 32 * LDS, LDS,
                        BK, lane);
    __syncthreads();
  }

#pragma unroll
  for (int mi = 0; mi < 2; ++mi) {
#pragma unroll
    for (int ni = 0; ni < 4; ++ni) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = m0 + wm * 32 + mi * 16 + plt::acc_row(lane, e);
        const int col = n0 + wn * 32 + ni * 8 + plt::acc_col(lane, e);
        if (row >= M || col >= N) continue;
        const float y = plt::scale_bias_act<HAS_BIAS>(
            static_cast<float>(acc[mi][ni][e]), scale, bias, col, act);
        const size_t o = (size_t)row * N + col;
        if (OUT_I8)
          static_cast<int8_t*>(out)[o] = plt::requant(y, inv_out_scale);
        else
          static_cast<float*>(out)[o] = y;
      }
    }
  }
}

template <bool VEC, bool OUT_I8, bool HAS_BIAS>
void launch(const int8_t* A, const int8_t* Bt, const float* scale,
            const float* bias, void* out, int M, int N, int K,
            plt::ActParams act, float inv, cudaStream_t stream) {
  dim3 grid((M + BM - 1) / BM, (N + BN - 1) / BN);
  int8_gemm_kernel<VEC, OUT_I8, HAS_BIAS>
      <<<grid, THREADS, 0, stream>>>(A, Bt, scale, bias, out, M, N, K, act,
                                     inv);
}

template <bool VEC>
void dispatch(const int8_t* A, const int8_t* Bt, const float* scale,
              const float* bias, void* out, int M, int N, int K,
              plt::ActParams act, int out_i8, float inv, cudaStream_t s) {
  if (out_i8) {
    if (bias) launch<VEC, true, true>(A, Bt, scale, bias, out, M, N, K, act, inv, s);
    else launch<VEC, true, false>(A, Bt, scale, bias, out, M, N, K, act, inv, s);
  } else {
    if (bias) launch<VEC, false, true>(A, Bt, scale, bias, out, M, N, K, act, inv, s);
    else launch<VEC, false, false>(A, Bt, scale, bias, out, M, N, K, act, inv, s);
  }
}

}  // namespace

// C interface, bound with ctypes.  Pointers are device pointers; `bias` may
// be null.  `act` is a plt::Act code and p0..p2 its parameters
// (epilogue.cuh).  `vec` selects 16-byte loads (the caller checks
// K % 16 == 0 and 16-byte alignment of A and Bt).  Returns
// cudaGetLastError() after the launch.
extern "C" int plt_int8_gemm(const void* A, const void* Bt, const void* scale,
                             const void* bias, void* out, int M, int N, int K,
                             int act, float p0, float p1, float p2, int out_i8,
                             float inv_out_scale, int vec, void* stream) {
  const int8_t* a = static_cast<const int8_t*>(A);
  const int8_t* b = static_cast<const int8_t*>(Bt);
  const float* sc = static_cast<const float*>(scale);
  const float* bi = static_cast<const float*>(bias);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const plt::ActParams ap{act, p0, p1, p2};
  if (M > 0 && N > 0) {
    if (vec) dispatch<true>(a, b, sc, bi, out, M, N, K, ap, out_i8, inv_out_scale, s);
    else dispatch<false>(a, b, sc, bi, out, M, N, K, ap, out_i8, inv_out_scale, s);
  }
  return static_cast<int>(cudaGetLastError());
}
