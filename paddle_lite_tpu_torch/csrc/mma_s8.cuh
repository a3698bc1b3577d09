// int8 tensor-core fragments (mma.sync.m16n8k32, s8 x s8 -> s32) for the
// fused dw+pw kernel (dw_pw_fused.cu).
//
// Both operands sit in shared memory K-contiguous: A as rows of M, B as rows
// of N (the "row.col" form), each row `lds` bytes apart, a multiple of 16.
// With lds = 16 (mod 32) bytes the eight 16-byte rows an ldmatrix reads fall
// on distinct banks.  Lane l = 4g + t of a warp holds:
//   A: a0 = row g, bytes 4t..4t+3;  a1 = row g+8;  a2, a3 = the same at +16
//   B: b0 = row (column of C) g, bytes 4t..4t+3;  b1 = the same at +16
//   C: element e of the m16n8 tile at row g + 8*(e >> 1), column 2t + (e & 1).
// ldmatrix.x4 of four 8 x 16-byte matrices hands each lane exactly these
// words (an 8 x 8 b16 matrix gives lane 4g + t row g, bytes 4t..4t+3): one
// instruction for an A fragment, one for the B fragments of two n8 tiles.
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

// four 8 x 16-byte matrices of shared memory; lane l gives the address of
// row l % 8 of matrix l / 8
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const int8_t* p) {
  const uint32_t addr = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// acc[mi][ni] += A[32 rows, 32 * KSTEPS].B[32 rows, 32 * KSTEPS]^T for one
// warp: two m16 tiles of A against four n8 tiles of B.
template <int KSTEPS>
__device__ __forceinline__ void warp_mma_32x32(int acc[2][4][4], const int8_t* A, int lda,
                                               const int8_t* B, int ldb, int lane) {
  // this lane's row and 16-byte half for A (matrix lane / 8: rows 0-7 or
  // 8-15, bytes 0-15 or 16-31) and for B (tiles ni, ni + 1; each half)
  const int8_t* pa = A + (lane & 15) * lda + (lane >> 4) * 16;
  const int8_t* pb = B + ((lane >> 4) * 8 + (lane & 7)) * ldb + ((lane >> 3) & 1) * 16;
#pragma unroll
  for (int ks = 0; ks < 32 * KSTEPS; ks += 32) {
    uint32_t a[2][4], b[4][2];
#pragma unroll
    for (int mi = 0; mi < 2; ++mi) ldmatrix_x4(a[mi], pa + mi * 16 * lda + ks);
#pragma unroll
    for (int nj = 0; nj < 2; ++nj) {
      uint32_t r[4];
      ldmatrix_x4(r, pb + nj * 16 * ldb + ks);
      b[2 * nj][0] = r[0];
      b[2 * nj][1] = r[1];
      b[2 * nj + 1][0] = r[2];
      b[2 * nj + 1][1] = r[3];
    }
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) mma_s8(acc[mi][ni], a[mi], b[ni]);
  }
}

}  // namespace plt
