"""Kernel selection: which ops run on the hand-written CUDA kernels.

Counterpart of ``paddle_lite_tpu/ops/kernels/autotune.choose_kernel``
(``autotune.py:51-92``).  The reference picks by tables measured on a TPU
(``tune_cache.lookup_gemm`` / ``lookup_dw``, backed by ``.autotune/``) and by
TPU size thresholds (``_gemm_dims_ok``, ``autotune.py:25-28``).  None of
that describes this card, so the port reads neither: every int8 op that a
kernel takes is tagged ``"cuda"``:

- 1x1 / stride 1 / group 1 / no-residual ``conv2d``, ``fc`` and ``mul``
  (the ``_gemm_problem`` rule, ``autotune.py:31-48``) with an even K →
  the int8 GEMM;
- ``depthwise_conv2d`` inside ``depthwise.supported_general`` → the
  depthwise kernel;

in both cases only when the fused activation is one the kernels' epilogue
computes (none, relu, relu6).  Every ``multiclass_nms*`` op, int8 graph or
not, takes the NMS kernel (``autotune.py:60-65``: NMS runs in the fp32
island either way).  Everything else keeps the default ``"torch"`` impl.
A table measured on the H100 is later work (``ROADMAP.md``).
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from ..common import normalize_2d
from . import depthwise
from .int8_matmul import ACTS

def gemm_eligible(graph, op) -> bool:
    """A GEMM the kernel takes: its K is even (the kernel copies rows in
    pieces of 2 bytes or more, ``int8_matmul.copy_width``)."""
    if op.op_type == "fc":
        return graph.vars[op.input("W")].shape[0] % 2 == 0
    if op.op_type == "mul":
        yd = int(op.attrs.get("y_num_col_dims", 1))
        return int(np.prod(graph.vars[op.input("Y")].shape[:yd])) % 2 == 0
    if op.op_type == "conv2d":
        kh, kw, c = graph.vars[op.input("Filter")].shape[:3]
        return (
            (kh, kw) == (1, 1)
            and normalize_2d(op.attrs.get("strides", (1, 1))) == (1, 1)
            and int(op.attrs.get("groups", 1)) == 1
            and not op.maybe_input("ResidualData")
            and c % 2 == 0
        )
    return False


def choose_kernel(graph, op) -> Optional[str]:
    """'cuda' for an op a kernel takes, else None (default impl)."""
    if op.op_type.startswith("multiclass_nms"):
        return "cuda"
    if not op.attrs.get("enable_int8") or op.attrs.get("fuse_act") not in ACTS:
        return None
    if op.op_type == "depthwise_conv2d":
        x = graph.vars[op.input("Input")]
        w = graph.vars[op.input("Filter")]
        if (depthwise.supported_general(op.attrs, x.shape, w.shape)
                and not op.maybe_input("ResidualData")):
            return "cuda"
        return None
    return "cuda" if gemm_eligible(graph, op) else None
