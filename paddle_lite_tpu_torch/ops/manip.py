"""Tensor-manipulation ops of the main path: ``reshape`` / ``reshape2``.

Port of the reshape family head of ``paddle_lite_tpu/ops/manip.py``
(``:31-53``).  Int8 flows through unchanged (same scale).
"""

from __future__ import annotations

import numpy as np

from ..core.registry import OPS


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
