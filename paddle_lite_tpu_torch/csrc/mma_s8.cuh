// int8 tensor-core fragments (mma.sync.m16n8k32, s8 x s8 -> s32) shared by
// the GEMM kernel (int8_gemm.cu) and the fused dw+pw kernel (dw_pw_fused.cu).
//
// Both operands sit in shared memory K-contiguous: A as rows of M, B as rows
// of N (the "row.col" form), each row `lds` bytes apart.  With lds = 16
// (mod 32) bytes the eight rows a warp reads for one fragment fall on
// distinct banks.  Lane l = 4g + t of a warp holds:
//   A: a0 = row g, bytes 4t..4t+3;  a1 = row g+8;  a2, a3 = the same at +16
//   B: b0 = row (column of C) g, bytes 4t..4t+3;  b1 = the same at +16
//   C: element e of the m16n8 tile at row g + 8*(e >> 1), column 2t + (e & 1).
#pragma once

#include <stdint.h>

namespace plt {

__device__ __forceinline__ void mma_s8(int* c, const uint32_t* a,
                                       const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ int acc_row(int lane, int e) {
  return (lane >> 2) + 8 * (e >> 1);
}

__device__ __forceinline__ int acc_col(int lane, int e) {
  return 2 * (lane & 3) + (e & 1);
}

// acc[mi][ni] += A[32 rows, depth] . B[32 rows, depth]^T for one warp: two
// m16 tiles of A against four n8 tiles of B, `depth` a multiple of 32.
__device__ __forceinline__ void warp_mma_32x32(int acc[2][4][4],
                                               const int8_t* A, int lda,
                                               const int8_t* B, int ldb,
                                               int depth, int lane) {
  const int g = lane >> 2, t = lane & 3;
  for (int ks = 0; ks < depth; ks += 32) {
    uint32_t a[2][4], b[4][2];
#pragma unroll
    for (int mi = 0; mi < 2; ++mi) {
      const int8_t* p = A + (mi * 16 + g) * lda + ks + 4 * t;
      a[mi][0] = *reinterpret_cast<const uint32_t*>(p);
      a[mi][1] = *reinterpret_cast<const uint32_t*>(p + 8 * lda);
      a[mi][2] = *reinterpret_cast<const uint32_t*>(p + 16);
      a[mi][3] = *reinterpret_cast<const uint32_t*>(p + 8 * lda + 16);
    }
#pragma unroll
    for (int ni = 0; ni < 4; ++ni) {
      const int8_t* p = B + (ni * 8 + g) * ldb + ks + 4 * t;
      b[ni][0] = *reinterpret_cast<const uint32_t*>(p);
      b[ni][1] = *reinterpret_cast<const uint32_t*>(p + 16);
    }
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) mma_s8(acc[mi][ni], a[mi], b[ni]);
  }
}

}  // namespace plt
