"""The problems the kernel table is keyed by, and the GEMM plans it sweeps.

Port of ``paddle_lite_tpu/ops/kernels/autotune.py``.  The reference's file
holds three things; here each has its counterpart:

- ``_gemm_problem`` (``:31-48`` there): the (m, k, n) of an op that the
  GEMM takes.  The reference maps only 1x1 stride-1 convs; the port runs
  every group-1 conv on the GEMM over its im2col rows, gathered by the
  launch or explicit (``ops_cuda.conv2d_cuda``), so a conv's problem is
  (N·OH·OW, kh·kw·C, OC), the rows the kernel multiplies.  Only an op
  ``select.gemm_eligible`` takes has a problem.
- ``choose_kernel`` (``:51-92``): ``select.choose_kernel``, which reads the
  measured table (``tune_cache``) bucket by bucket.
- ``gemm_blocks`` (``:101-121``), the TPU's static VMEM tiles: the GEMM's
  static plan is ``int8_matmul.plan``'s heuristic; :func:`plan_candidates`
  lists what ``tune_cache.sweep_gemm_blocks`` measures against it.

The reference's ``_gemm_dims_ok`` size gate (``:25-28``) is a TPU
threshold and is not ported: on the card an unmeasured bucket keeps the
kernel (``select.py``).
"""

from __future__ import annotations

import math
from typing import List, Optional, Tuple

from ..common import conv_out_size, normalize_2d, normalize_paddings
from . import depthwise
from .int8_matmul import BN_CHOICES, SMEM_LIMIT, slab_depths, smem_bytes


def _gemm_problem(graph, op) -> Optional[Tuple[int, int, int]]:
    """(m, k, n) of an op the GEMM takes (``select.gemm_eligible``): an
    ``fc`` / ``mul`` as its 2-D product, a ``conv2d`` over its im2col rows;
    None for another op."""
    from .select import gemm_eligible

    if not gemm_eligible(graph, op):
        return None
    if op.op_type == "fc":
        x = graph.vars[op.input("Input")].shape
        w = graph.vars[op.input("W")].shape
        cols = int(op.attrs.get("in_num_col_dims", len(x) - 1))
        return math.prod(x[:cols]), math.prod(x[cols:]), w[-1]
    if op.op_type == "mul":
        x = graph.vars[op.input("X")].shape
        y = graph.vars[op.input("Y")].shape
        xd = int(op.attrs.get("x_num_col_dims", 1))
        yd = int(op.attrs.get("y_num_col_dims", 1))
        return math.prod(x[:xd]), math.prod(y[:yd]), math.prod(y[yd:])
    n, h, w, _ = graph.vars[op.input("Input")].shape
    kh, kw, c, oc = graph.vars[op.input("Filter")].shape
    sh, sw = normalize_2d(op.attrs.get("strides", (1, 1)))
    (ph0, ph1), (pw0, pw1) = normalize_paddings(op.attrs.get("paddings", (0, 0)))
    oh = conv_out_size(h, kh, sh, (ph0, ph1), 1)
    ow = conv_out_size(w, kw, sw, (pw0, pw1), 1)
    return n * oh * ow, kh * kw * c, oc


def _dw_problem(graph, op) -> Optional[Tuple[int, int, int, int]]:
    """(h, c, k, s) of an int8 ``depthwise_conv2d`` the depthwise kernel
    takes (``depthwise.supported_general``, no residual), as
    ``tune_cache._dw_key`` buckets it; None otherwise."""
    if op.op_type != "depthwise_conv2d" or not op.attrs.get("enable_int8"):
        return None
    x = graph.vars[op.input("Input")].shape
    w = graph.vars[op.input("Filter")].shape
    if not depthwise.supported_general(op.attrs, x, w) or op.maybe_input("ResidualData"):
        return None
    s = normalize_2d(op.attrs.get("strides", (1, 1)))[0]
    return x[1], x[3], w[0], s


def plan_candidates(m: int, k: int, n: int, out: int) -> List[Tuple[int, int, int]]:
    """(bn, bk, warpgroups) of every GEMM plan the kernel runs at this
    problem: a tile width of ``BN_CHOICES`` no wider than the narrowest
    that covers N (a wider one only multiplies zero columns), a slab depth
    of ``slab_depths(k)`` and one or two warpgroups, where the block's
    shared memory at output kind `out` (``int8_matmul.OUT_*``; a bool
    reads as int8 / fp32) fits ``SMEM_LIMIT``."""
    widest = next((b for b in BN_CHOICES if b >= n), BN_CHOICES[-1])
    return [(bn, bk, wgs) for bn in BN_CHOICES if bn <= widest
            for bk in slab_depths(k) for wgs in (1, 2)
            if smem_bytes(64 * wgs, bn, bk, out) <= SMEM_LIMIT]
