"""Kernel selection: which ops run on the hand-written CUDA kernels.

Counterpart of ``paddle_lite_tpu/ops/kernels/autotune.choose_kernel``
(``autotune.py:51-92``).  The reference picks by tables measured on a TPU
(``tune_cache.lookup_gemm`` / ``lookup_dw``, backed by ``.autotune/``) and by
TPU size thresholds (``_gemm_dims_ok``, ``autotune.py:25-28``).  None of
that describes this card, so the port reads neither: every int8 op that a
kernel takes is tagged ``"cuda"``:

- ``conv2d`` with group 1, dilation 1 and no residual, of any kernel size,
  stride and explicit paddings, through its im2col rows
  (``ops_cuda.im2col_nhwc``; the reference's ``conv_gemmlike`` mapping,
  ``ops_pallas.py:79-80``), ``fc`` and ``mul``, each with an even K →
  the int8 GEMM.  The GEMM accumulates in int32, exact for any K; the
  ``"torch"`` conv (an fp32 conv, then ``round``) is exact only while
  every partial sum stays below 2^24, which holds for every input only up
  to K = kh·kw·C = 1040.  Residual convs stay on the ``"torch"`` path: the
  GEMM has no residual operand (nor has the TPU one, ``ops_pallas.py:84-93``);
- ``depthwise_conv2d`` inside ``depthwise.supported_general`` → the
  depthwise kernel;

in both cases only when the fused activation is one the kernel's epilogue
computes (``int8_matmul.GEMM_ACTS`` for the GEMM, gelu and tanh among
them; ``int8_matmul.ACTS`` for the depthwise kernel).  Every
``multiclass_nms*`` op, int8 graph or not, takes the NMS kernel
(``autotune.py:60-65``: NMS runs in the fp32 island either way), and so
does every ``generate_proposals`` op, whose NMS the kernel runs in the
division form.  Everything else keeps the default ``"torch"`` impl.
A table measured on the H100 is later work (``ROADMAP.md``).
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from ..common import normalize_2d
from . import depthwise
from .int8_matmul import ACTS, GEMM_ACTS


def _kernel_epilogue(op, acts) -> bool:
    """int8, with a fused activation in `acts`, those the kernel's epilogue
    computes."""
    return bool(op.attrs.get("enable_int8")) and op.attrs.get("fuse_act") in acts


def gemm_eligible(graph, op) -> bool:
    """An int8 ``fc`` / ``mul`` / ``conv2d`` that the GEMM takes: its K is
    even (the kernel copies rows in pieces of 2 bytes or more,
    ``int8_matmul.copy_width``); a conv has group 1, dilation 1 and no
    residual."""
    if not _kernel_epilogue(op, GEMM_ACTS):
        return False
    if op.op_type == "fc":
        return graph.vars[op.input("W")].shape[0] % 2 == 0
    if op.op_type == "mul":
        yd = int(op.attrs.get("y_num_col_dims", 1))
        return int(np.prod(graph.vars[op.input("Y")].shape[:yd])) % 2 == 0
    if op.op_type == "conv2d":
        kh, kw, c = graph.vars[op.input("Filter")].shape[:3]
        return (
            int(op.attrs.get("groups", 1)) == 1
            and normalize_2d(op.attrs.get("dilations", (1, 1))) == (1, 1)
            and not op.maybe_input("ResidualData")
            and (kh * kw * c) % 2 == 0
        )
    return False


def choose_kernel(graph, op) -> Optional[str]:
    """'cuda' for an op a kernel takes, else None (default impl)."""
    if op.op_type.startswith("multiclass_nms") or op.op_type == "generate_proposals":
        return "cuda"
    if op.op_type == "depthwise_conv2d":
        x = graph.vars[op.input("Input")]
        w = graph.vars[op.input("Filter")]
        if (_kernel_epilogue(op, ACTS)
                and depthwise.supported_general(op.attrs, x.shape, w.shape)
                and not op.maybe_input("ResidualData")):
            return "cuda"
        return None
    return "cuda" if gemm_eligible(graph, op) else None
