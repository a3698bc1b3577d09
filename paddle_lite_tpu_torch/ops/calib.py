"""Precision and plumbing ops: ``quantize`` / ``dequantize`` (inserted by
the cast pass), ``calib`` (fp32 <-> int8 either way), the identities
``feed`` / ``fetch`` / ``io_copy`` / ``io_copy_once`` / ``assign`` and
``layout`` (NCHW <-> NHWC).

Port of ``paddle_lite_tpu/ops/calib.py`` (``:26-89``), the analog of the
reference's ``lite/kernels/arm/calib_compute.cc`` and
``layout_compute.cc``.  ``assign`` is also the alias the fluid converter
emits for a transpose that is already the physical layout.  The identities
return their input itself (an alias: no copy).
"""

from __future__ import annotations

import torch

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


def _same(attrs, in_shapes):
    return [in_shapes[0]]


@OPS.shape_fn("calib")
def calib_shape(attrs, in_shapes):
    return [in_shapes[0]]


@OPS.kernel("calib", "torch")
def calib_torch(ctx, op, ins):
    """fp32 <-> int8 as the reference's CalibCompute: an int8 input is
    dequantized with its own scale, anything else quantized with the
    output var's."""
    x = ins["X"][0]
    if x.dtype == torch.int8:
        return {"Out": [_dq(x, ctx.var_quant(op.input("X")).scale[0])]}
    return {"Out": [_q(x, ctx.var_quant(op.output("Out")).scale[0])]}


def identity_torch(ctx, op, ins):
    """The input itself (an alias: no copy)."""
    return {"Out": [next(iter(ins.values()))[0]]}


for _name in ("feed", "fetch", "io_copy", "io_copy_once", "assign"):
    OPS.register(_name, infer_shape=_same)
    OPS.get(_name).impls["torch"] = identity_torch


@OPS.shape_fn("layout")
def layout_shape(attrs, in_shapes):
    x = in_shapes[0]
    if attrs.get("to", "nhwc") == "nhwc":  # NCHW -> NHWC
        return [(x[0], x[2], x[3], x[1])]
    return [(x[0], x[3], x[1], x[2])]


@OPS.kernel("layout", "torch")
def layout_torch(ctx, op, ins):
    """A permuted view (``to`` = "nhwc": NCHW -> NHWC, else back)."""
    perm = (0, 2, 3, 1) if op.attrs.get("to", "nhwc") == "nhwc" else (0, 3, 1, 2)
    return {"Out": [ins["X"][0].permute(perm)]}
