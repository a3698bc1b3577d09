"""Precision ops inserted by the cast pass: ``quantize`` / ``dequantize``.

Port of ``paddle_lite_tpu/ops/calib.py:26-47`` (the reference's ``calib``
kernels, ``lite/kernels/arm/calib_compute.cc``).
"""

from __future__ import annotations

from ..core.registry import OPS
from .common import dequantize as _dq
from .common import quantize as _q


@OPS.shape_fn("quantize")
def quantize_shape(attrs, in_shapes):
    return [in_shapes[0]]


@OPS.kernel("quantize", "torch")
def quantize_torch(ctx, op, ins):
    """fp32 -> int8 with the *output var's* recorded scale."""
    q = ctx.var_quant(op.output("Out"))
    return {"Out": [_q(ins["X"][0], q.scale[0])]}


@OPS.shape_fn("dequantize")
def dequantize_shape(attrs, in_shapes):
    return [in_shapes[0]]


@OPS.kernel("dequantize", "torch")
def dequantize_torch(ctx, op, ins):
    q = ctx.var_quant(op.input("X"))
    scale = q.scale_array() if q.per_channel else q.scale[0]
    return {"Out": [_dq(ins["X"][0], scale, axis=q.axis)]}
