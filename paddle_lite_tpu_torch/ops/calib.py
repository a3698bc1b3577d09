"""Precision ops inserted by the cast pass: ``quantize`` / ``dequantize``;
and ``assign``, the alias the fluid converter emits for a transpose that is
already the physical layout.

Port of ``paddle_lite_tpu/ops/calib.py:26-47`` (the reference's ``calib``
kernels, ``lite/kernels/arm/calib_compute.cc``) and of its ``assign``
(``:67-73``: the identity; the reference's ``feed`` / ``fetch`` /
``io_copy`` names there are later work).
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


@OPS.shape_fn("assign")
def assign_shape(attrs, in_shapes):
    return [in_shapes[0]]


@OPS.kernel("assign", "torch")
def assign_torch(ctx, op, ins):
    """The input itself (an alias: no copy)."""
    return {"Out": [next(iter(ins.values()))[0]]}
