"""Write ``csrc/wgmma_s8.cuh``: the int8 warpgroup MMA for every tile width
the GEMM kernel instantiates.

    python3 -m paddle_lite_tpu_torch.tools.gen_wgmma_s8

``wgmma.mma_async`` names each accumulator register of its N/2 a thread as
a separate operand, so one inline-assembly statement per width N is
written out here rather than by hand.  ``tests/test_torch_gemm_plan.py``
checks that the committed header is this script's output.
"""

from __future__ import annotations

from pathlib import Path

from ..ops.kernels.int8_matmul import BN_CHOICES

# the widths int8_gemm.cu instantiates; all are in the PTX ISA's list of N
# for .s8 (8, 16, 24, 32, 48, ..., 256)
WIDTHS = BN_CHOICES

HEADER = Path(__file__).resolve().parents[1] / "csrc" / "wgmma_s8.cuh"

_TOP = """\
// Generated by paddle_lite_tpu_torch/tools/gen_wgmma_s8.py; do not edit.
//
// plt::Wgmma<N>::mma(d, desc_a, desc_b): one
//   wgmma.mma_async.sync.aligned.m64nNk32.s32.s8.s8
// issued by the four warps of a warpgroup, accumulating into d (N/2 int32
// registers a thread): D(64 x N) += A(64 x 32) * B(32 x N), both operands
// K-major in shared memory, named by the descriptors.  The caller fences
// (wgmma.fence), commits and waits.
#pragma once

#include <stdint.h>

namespace plt {

template <int N>
struct Wgmma;
"""


def _one(n: int) -> str:
    r = n // 2
    regs = ", ".join(f"%{i}" for i in range(r))
    outs = ",\n          ".join(
        ", ".join(f'"+r"(d[{i}])' for i in range(j, min(j + 8, r)))
        for j in range(0, r, 8))
    return f"""
template <>
struct Wgmma<{n}> {{
  __device__ __forceinline__ static void mma(int (&d)[{r}], uint64_t a,
                                             uint64_t b) {{
    asm volatile(
        "{{\\n.reg .pred p;\\nsetp.ne.b32 p, %{r + 2}, 0;\\n"
        "wgmma.mma_async.sync.aligned.m64n{n}k32.s32.s8.s8 "
        "{{{regs}}}, %{r}, %{r + 1}, p;\\n}}\\n"
        : {outs}
        : "l"(a), "l"(b), "r"(1));
  }}
}};
"""


def render() -> str:
    return _TOP + "".join(_one(n) for n in WIDTHS) + "\n}  // namespace plt\n"


def main() -> None:
    HEADER.write_text(render())
    print(f"wrote {HEADER}")


if __name__ == "__main__":
    main()
