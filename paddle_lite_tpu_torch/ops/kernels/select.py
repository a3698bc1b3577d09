"""Kernel selection: which ops run on the hand-written CUDA kernels.

Counterpart of ``paddle_lite_tpu/ops/kernels/autotune.choose_kernel``
(``autotune.py:51-92``).  The reference picks by tables measured on a TPU
(``.autotune/``) and by TPU size thresholds (``_gemm_dims_ok``,
``autotune.py:25-28``).  The port reads neither: it reads its own table,
measured on the card (below), and an int8 op that a kernel takes is tagged
``"cuda"`` unless that table measured its bucket slower than the op's
``"torch"`` impl.  The kernels take:

- ``conv2d`` with group 1 and dilation 1, of any kernel size, stride and
  explicit paddings, as the GEMM over its im2col rows (the reference's
  ``conv_gemmlike`` mapping, ``ops_pallas.py:79-80``): a k×k, strided or
  padded conv's launch gathers them from its input
  (``int8_matmul.int8_conv``), a 1x1 stride-1 conv's rows are its input,
  and a conv with a residual or of odd C takes ``ops_cuda.im2col_nhwc``'s
  explicit rows; ``fc`` and ``mul``; each with an even K → the int8 GEMM.  The GEMM
  accumulates in int32, exact for any K; the ``"torch"`` conv (an fp32
  conv, then ``round``) is exact only while every partial sum stays below
  2^24, which holds for every input only up to K = kh·kw·C = 1040.  A
  conv with a residual (a shortcut add fused into it) takes the GEMM when
  the residual is int8 with one per-tensor scale: the GEMM's epilogue
  adds it (the TPU kernel had no residual operand, ``ops_pallas.py:84-93``
  there, so the reference ran such convs on XLA).  A float residual stays
  on the ``"torch"`` path;
- ``depthwise_conv2d`` inside ``depthwise.supported_general`` → the
  depthwise kernel;

in both cases only when the fused activation is one the kernel's epilogue
computes (``int8_matmul.GEMM_ACTS`` for the GEMM, gelu and tanh among
them; ``int8_matmul.ACTS`` for the depthwise kernel).  Every
``multiclass_nms*`` op, int8 graph or not, takes the NMS kernel
(``autotune.py:60-65``: NMS runs in the fp32 island either way), and so
does every ``generate_proposals`` op, whose NMS the kernel runs in the
division form.  Everything else keeps the default ``"torch"`` impl.

The GEMM and depthwise picks read the kernel table measured on the card
(``tune_cache``, keyed by ``tune_cache._op_table_key``): a bucket measured
``"torch"`` keeps the ``"torch"`` impl, one measured ``"cuda"`` takes the
kernel.  **An unmeasured bucket takes the kernel**, where the reference
defaults to XLA (``autotune.py:51-60`` there): its XLA lowering beat its
first Pallas kernels on the TPU, whereas the port's kernels were redesigned
for this card (PRs 5-8) and ``chip_smoke.py`` holds these picks in-model on
every path.  So with an empty table every pick is as it was before the
table existed.  The NMS kernel's ops are not table-driven (nor are they
there, ``autotune.py:60-65``).
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from ...core.types import Precision
from ..common import normalize_2d
from .int8_matmul import GEMM_ACTS


def _kernel_epilogue(op, acts) -> bool:
    """int8, with a fused activation in `acts`, those the kernel's epilogue
    computes."""
    return bool(op.attrs.get("enable_int8")) and op.attrs.get("fuse_act") in acts


def _int8_per_tensor(graph, name: str) -> bool:
    """`name` is an int8 variable with one per-tensor scale."""
    v = graph.vars[name]
    return (v.precision == Precision.INT8 and v.quant is not None
            and not v.quant.per_channel and len(v.quant.scale) == 1)


def gemm_eligible(graph, op) -> bool:
    """An int8 ``fc`` / ``mul`` / ``conv2d`` that the GEMM takes: its K is
    even (the kernel copies rows in pieces of 2 bytes or more,
    ``int8_matmul.copy_width``); a conv has group 1, dilation 1 and no
    residual or an int8 one with a per-tensor scale (:func:`_int8_per_tensor`),
    which the GEMM's epilogue adds."""
    if not _kernel_epilogue(op, GEMM_ACTS):
        return False
    if op.op_type == "fc":
        return graph.vars[op.input("W")].shape[0] % 2 == 0
    if op.op_type == "mul":
        yd = int(op.attrs.get("y_num_col_dims", 1))
        return int(np.prod(graph.vars[op.input("Y")].shape[:yd])) % 2 == 0
    if op.op_type == "conv2d":
        kh, kw, c = graph.vars[op.input("Filter")].shape[:3]
        residual = op.maybe_input("ResidualData")
        return (
            int(op.attrs.get("groups", 1)) == 1
            and normalize_2d(op.attrs.get("dilations", (1, 1))) == (1, 1)
            and (residual is None or _int8_per_tensor(graph, residual))
            and (kh * kw * c) % 2 == 0
        )
    return False


def choose_kernel(graph, op) -> Optional[str]:
    """'cuda' for an op a kernel takes, unless the kernel table measured
    its bucket as 'torch'; else None (default impl)."""
    from . import tune_cache

    if op.op_type.startswith("multiclass_nms") or op.op_type == "generate_proposals":
        return "cuda"
    key = tune_cache._op_table_key(graph, op)
    if key is None:
        return None
    return None if tune_cache.lookup(key) == "torch" else "cuda"
