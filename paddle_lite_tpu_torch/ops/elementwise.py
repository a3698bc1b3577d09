"""Elementwise / broadcast ops, scale, clip, cast, compare and logical ops.

Port of ``paddle_lite_tpu/ops/elementwise.py`` (the analog of
``lite/operators/elementwise_ops.cc`` and ``lite/kernels/arm/
elementwise_compute.cc``), under the ``"torch"`` tag.

Paddle's elementwise ops carry an ``axis`` attr saying where Y's dims align
into X's (Y is broadcast from that axis); numpy-style trailing broadcast is
the axis=-1 case.  int8 operands are dequantized to fp32 first (Y per
channel where its scale is); an ``out_scale`` attr requantizes the result —
MobileNetV3's SE gate multiply runs int8 in, int8 out this way.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.registry import OPS
from .common import apply_activation, dequantize, quantize


def _broadcast_shape(attrs, in_shapes):
    x, y = list(in_shapes[0]), list(in_shapes[1])
    axis = int(attrs.get("axis", -1))
    if axis == -1 or len(x) == len(y):
        out = list(np.broadcast_shapes(tuple(x), tuple(y)))
    else:
        # paddle axis semantics: y aligns to x at `axis`
        full = [1] * len(x)
        full[axis: axis + len(y)] = y
        out = list(np.broadcast_shapes(tuple(x), tuple(full)))
    return [tuple(out)]


def _align(x: torch.Tensor, y: torch.Tensor, axis: int) -> torch.Tensor:
    if axis == -1 or x.ndim == y.ndim:
        return y
    shape = [1] * x.ndim
    shape[axis: axis + y.ndim] = y.shape
    return y.reshape(shape)


_ELTWISE_FNS = {
    "elementwise_add": torch.add,
    "elementwise_sub": torch.sub,
    "elementwise_mul": torch.mul,
    "elementwise_div": torch.div,
    "elementwise_max": torch.maximum,
    "elementwise_min": torch.minimum,
    "elementwise_pow": torch.pow,
    "elementwise_mod": torch.remainder,  # jnp.mod: the sign of the divisor
    "elementwise_floordiv": torch.floor_divide,
}


def _make_eltwise(name, fn):
    def impl(ctx, op, ins):
        x, y = ins["X"][0], ins["Y"][0]
        if x.dtype == torch.int8:
            x = dequantize(x, ctx.var_quant(op.input("X")).scale[0])
        if y.dtype == torch.int8:
            yq = ctx.var_quant(op.input("Y"))
            y = dequantize(y, yq.scale_array() if yq.per_channel else yq.scale[0],
                           axis=yq.axis)
        out = fn(x, _align(x, y, int(op.attrs.get("axis", -1))))
        out = apply_activation(out, op.attrs.get("fuse_act"), op.attrs.get("act_attrs"))
        out_scale = op.attrs.get("out_scale")
        if out_scale is not None:
            out = quantize(out, out_scale)
        return {"Out": [out]}

    impl.__name__ = f"{name}_impl"
    return impl


for _name, _fn in _ELTWISE_FNS.items():
    OPS.register(_name, infer_shape=_broadcast_shape, input_slots=("X", "Y"))
    OPS.get(_name).impls["torch"] = _make_eltwise(_name, _fn)


# ---- scale / clip / cast --------------------------------------------------

def _same_shape(attrs, in_shapes):
    return [in_shapes[0]]


for _name in ("scale", "clip", "cast", "logical_not"):
    OPS.register(_name, infer_shape=_same_shape, input_slots=("X",))


@OPS.kernel("scale", "torch")
def scale_torch(ctx, op, ins):
    x = ins["X"][0]
    if x.dtype == torch.int8:
        x = dequantize(x, ctx.var_quant(op.input("X")).scale[0])
    s = op.attrs.get("scale", 1.0)
    b = op.attrs.get("bias", 0.0)
    if op.attrs.get("bias_after_scale", True):
        return {"Out": [x * s + b]}
    return {"Out": [(x + b) * s]}


@OPS.kernel("clip", "torch")
def clip_torch(ctx, op, ins):
    return {"Out": [torch.clamp(ins["X"][0], op.attrs.get("min", 0.0),
                                op.attrs.get("max", 1.0))]}


@OPS.kernel("cast", "torch")
def cast_torch(ctx, op, ins):
    dtype = np.dtype(op.attrs.get("out_dtype", "float32"))
    return {"Out": [ins["X"][0].to(torch.from_numpy(np.zeros(0, dtype)).dtype)]}


# ---- comparison / logical ops (control-flow support: lite/operators/
# compare_op.cc, logical_op.cc) ---------------------------------------------

_COMPARE_FNS = {
    "less_than": torch.lt,
    "less_equal": torch.le,
    "greater_than": torch.gt,
    "greater_equal": torch.ge,
    "equal": torch.eq,
    "not_equal": torch.ne,
    "logical_and": torch.logical_and,
    "logical_or": torch.logical_or,
    "logical_xor": torch.logical_xor,
}


def _make_compare(name, fn):
    def impl(ctx, op, ins):
        x, y = ins["X"][0], ins["Y"][0]
        y = torch.as_tensor(y, device=x.device)
        return {"Out": [fn(x, _align(x, y, int(op.attrs.get("axis", -1))))]}

    impl.__name__ = f"{name}_impl"
    return impl


for _name, _fn in _COMPARE_FNS.items():
    OPS.register(_name, infer_shape=_broadcast_shape, input_slots=("X", "Y"))
    OPS.get(_name).impls["torch"] = _make_compare(_name, _fn)


@OPS.kernel("logical_not", "torch")
def logical_not_torch(ctx, op, ins):
    return {"Out": [torch.logical_not(ins["X"][0])]}
