"""Tensor-manipulation ops: ``reshape`` / ``reshape2`` and ``concat``.

Port of the reshape family head of ``paddle_lite_tpu/ops/manip.py``
(``:31-53``; int8 flows through unchanged, same scale) and of its
``concat`` (``:128-161``).
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.registry import OPS
from .common import INT8_MAX, INT8_MIN, dequantize, f32


@OPS.shape_fn("reshape")
def reshape_shape(attrs, in_shapes):
    x = in_shapes[0]
    shape = list(attrs["shape"])
    n = int(np.prod(x))
    for i, s in enumerate(shape):
        if s == 0:
            shape[i] = x[i]
    if -1 in shape:
        i = shape.index(-1)
        known = int(np.prod([s for s in shape if s != -1]))
        shape[i] = n // known
    return [tuple(shape)]


@OPS.kernel("reshape", "torch")
@OPS.kernel("reshape2", "torch")
def reshape_torch(ctx, op, ins):
    return {"Out": [ins["X"][0].reshape(ctx.var_shape(op.output("Out")))]}


OPS.register("reshape2", infer_shape=reshape_shape)


@OPS.shape_fn("concat")
def concat_shape(attrs, in_shapes):
    axis = int(attrs.get("axis", 0))
    out = list(in_shapes[0])
    out[axis] = sum(s[axis] for s in in_shapes)
    return [tuple(out)]


@OPS.kernel("concat", "torch")
def concat_torch(ctx, op, ins):
    """fp32 concat (int8 inputs dequantized), or — when the quantize pass
    gave the op an int8 region (``out_scale``) and every input is int8 —
    the int8 concat: each input requants to the common output scale with
    ``round(x·fp32(s_in/s_out))`` clipped to ±127 (the ratio taken in
    double, as the reference does)."""
    xs = ins["X"]
    axis = int(op.attrs.get("axis", 0))
    out_scale = op.attrs.get("out_scale")
    if out_scale is not None and all(x.dtype == torch.int8 for x in xs):
        parts = []
        for x, name in zip(xs, op.inputs["X"]):
            r = float(ctx.var_quant(name).scale[0]) / float(out_scale)
            if r == 1.0:
                parts.append(x)
            else:  # r <= 1 by construction (the out scale is the max)
                q = torch.round(x.to(torch.float32) * f32(r, x.device))
                parts.append(torch.clamp(q, INT8_MIN, INT8_MAX).to(torch.int8))
        return {"Out": [torch.cat(parts, dim=axis)]}
    fixed = [dequantize(x, ctx.var_quant(name).scale[0])
             if x.dtype == torch.int8 else x
             for x, name in zip(xs, op.inputs["X"])]
    return {"Out": [torch.cat(fixed, dim=axis)]}
