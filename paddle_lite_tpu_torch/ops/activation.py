"""Standalone activation ops — port of ``paddle_lite_tpu/ops/activation.py``
(``lite/operators/activation_ops.cc`` analog).

Each is a one-liner over :func:`common.apply_activation`; an int8 input is
dequantized with its var's scale first.
"""

from __future__ import annotations

import torch

from ..core.registry import OPS
from .common import apply_activation, dequantize

_SIMPLE_ACTS = [
    "relu", "relu6", "leaky_relu", "sigmoid", "tanh", "swish", "hard_swish",
    "hard_sigmoid", "relu_clipped", "gelu", "exp", "abs", "sqrt", "rsqrt",
    "square", "log", "floor", "mish", "elu", "softplus", "softsign", "silu",
    "reciprocal",
]


def _same_shape(attrs, in_shapes):
    return [in_shapes[0]]


def _make_impl(act_name):
    def impl(ctx, op, ins):
        x = ins["X"][0]
        if x.dtype == torch.int8:
            x = dequantize(x, ctx.var_quant(op.input("X")).scale[0])
        return {"Out": [apply_activation(x, act_name, op.attrs)]}

    impl.__name__ = f"{act_name}_impl"
    return impl


for _name in _SIMPLE_ACTS:
    OPS.register(_name, infer_shape=_same_shape, input_slots=("X",))
    OPS.get(_name).impls["torch"] = _make_impl(_name)
