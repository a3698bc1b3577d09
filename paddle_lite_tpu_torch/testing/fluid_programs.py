"""Fluid programs written at run time: MobileNetV1 as a Paddle export lays
it out.

The role of ``tests/fixtures/make_mnv1_fluid_fixture.py`` (which wrote the
committed ``tests/fixtures/mnv1_fluid/`` at width 0.25, 96 px, 100 classes,
seed 7), at any width, image size, class count and seed, where
``chip_smoke.py`` and the CLI can reach it: the full 13-block
depthwise-separable trunk (NCHW ``conv2d`` / ``depthwise_conv2d`` +
``batch_norm`` + ``relu`` chains), a global average ``pool2d``, the ``mul``
+ ``elementwise_add`` fc export form, ``softmax``, ``feed`` / ``fetch``,
and the params in the fluid wire format.  The parameters are drawn in the
fixture script's order from ``numpy.random.default_rng(seed)``, so the
fixture's arguments give its bytes.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np

from ..formats import fluid as F

# (stride, out_channels) — models/mobilenet_v1's blocks
BLOCKS = [
    (1, 64), (2, 128), (1, 128), (2, 256), (1, 256), (2, 512),
    (1, 512), (1, 512), (1, 512), (1, 512), (1, 512),
    (2, 1024), (1, 1024),
]


def _channels(width: float):
    return lambda ch: max(8, int(ch * width))


def mobilenet_v1_params(width: float = 1.0, classes: int = 1000,
                        seed: int = 0) -> Dict[str, np.ndarray]:
    """Seeded fp32 params by fluid var name: He-normal conv filters (OIHW),
    batch-norm statistics away from the identity, the fc weight (K, N)."""
    c = _channels(width)
    rng = np.random.default_rng(seed)
    p: Dict[str, np.ndarray] = {}

    def conv_w(name, oihw):
        fan_in = int(np.prod(oihw[1:]))
        p[name] = rng.normal(0, np.sqrt(2.0 / fan_in), oihw).astype(np.float32)

    def bn(name, ch):
        p[f"{name}_scale"] = (1 + 0.1 * rng.standard_normal(ch)).astype(np.float32)
        p[f"{name}_bias"] = (0.05 * rng.standard_normal(ch)).astype(np.float32)
        p[f"{name}_mean"] = (0.01 * rng.standard_normal(ch)).astype(np.float32)
        p[f"{name}_var"] = (1 + 0.1 * np.abs(rng.standard_normal(ch))).astype(np.float32)

    conv_w("conv1_w", (c(32), 3, 3, 3))
    bn("bn1", c(32))
    in_c = c(32)
    for i, (_, out_c) in enumerate(BLOCKS, 1):
        conv_w(f"dw{i}_w", (in_c, 1, 3, 3))        # depthwise OIHW (C,1,3,3)
        bn(f"bn_dw{i}", in_c)
        conv_w(f"pw{i}_w", (c(out_c), in_c, 1, 1))  # pointwise 1x1
        bn(f"bn_pw{i}", c(out_c))
        in_c = c(out_c)
    p["fc_w"] = rng.normal(0, np.sqrt(1.0 / in_c), (in_c, classes)).astype(np.float32)
    p["fc_b"] = (0.01 * rng.standard_normal(classes)).astype(np.float32)
    return p


def mobilenet_v1_program(width: float = 1.0, image_size: int = 224,
                         classes: int = 1000, seed: int = 0
                         ) -> Tuple[F.FluidProgram, Dict[str, np.ndarray]]:
    """The fluid program (batch dim -1, input ``image`` NCHW, output
    ``probs``) and its params."""
    c = _channels(width)
    prog = F.FluidProgram(blocks=[F.FluidBlock()])
    b = prog.main
    params = mobilenet_v1_params(width, classes, seed)

    def var(name, shape=(), persistable=False, kind=None):
        if kind is not None:
            b.vars[name] = F.FluidVar(name, kind=kind)
        else:
            b.vars[name] = F.FluidVar(name, shape=tuple(shape), dtype=F.VT_FP32,
                                      persistable=persistable)

    for n, v in params.items():
        var(n, v.shape, persistable=True)

    ops = []
    var("feed", kind=F.VT_FEED_MINIBATCH)
    var("fetch", kind=F.VT_FETCH_LIST)
    var("image", (-1, 3, image_size, image_size))
    ops.append(F.FluidOp("feed", {"X": ["feed"]}, {"Out": ["image"]}, {"col": 0}))

    def conv_bn_relu(x, name, w_name, bn_name, out_c, h, *, stride, depthwise=False):
        kind = "depthwise_conv2d" if depthwise else "conv2d"
        pad = 1 if params[w_name].shape[-1] == 3 else 0
        var(f"{name}_c", (-1, out_c, h, h))
        var(f"{name}_bn", (-1, out_c, h, h))
        var(name, (-1, out_c, h, h))
        ops.extend([
            F.FluidOp(kind, {"Input": [x], "Filter": [w_name]},
                      {"Output": [f"{name}_c"]},
                      {"strides": [stride, stride], "paddings": [pad, pad],
                       "dilations": [1, 1], "groups": out_c if depthwise else 1}),
            F.FluidOp("batch_norm",
                      {"X": [f"{name}_c"], "Scale": [f"{bn_name}_scale"],
                       "Bias": [f"{bn_name}_bias"], "Mean": [f"{bn_name}_mean"],
                       "Variance": [f"{bn_name}_var"]},
                      {"Y": [f"{name}_bn"]}, {"epsilon": 1e-5}),
            F.FluidOp("relu", {"X": [f"{name}_bn"]}, {"Out": [name]}, {}),
        ])
        return name

    h = (image_size + 2 - 3) // 2 + 1  # after the s2 stem
    x = conv_bn_relu("image", "t1", "conv1_w", "bn1", c(32), h, stride=2)
    in_c = c(32)
    for i, (stride, out_c) in enumerate(BLOCKS, 1):
        h = (h + 2 - 3) // stride + 1
        x = conv_bn_relu(x, f"tdw{i}", f"dw{i}_w", f"bn_dw{i}", in_c, h,
                         stride=stride, depthwise=True)
        x = conv_bn_relu(x, f"tpw{i}", f"pw{i}_w", f"bn_pw{i}", c(out_c), h, stride=1)
        in_c = c(out_c)

    var("pooled", (-1, in_c, 1, 1))
    var("fc_raw", (-1, classes))
    var("logits", (-1, classes))
    var("probs", (-1, classes))
    ops.extend([
        F.FluidOp("pool2d", {"X": [x]}, {"Out": ["pooled"]},
                  {"pooling_type": "avg", "global_pooling": True,
                   "ksize": [1, 1], "strides": [1, 1], "paddings": [0, 0]}),
        # the paddle fc export form: mul (x flattened past dim 1) + add
        F.FluidOp("mul", {"X": ["pooled"], "Y": ["fc_w"]}, {"Out": ["fc_raw"]},
                  {"x_num_col_dims": 1, "y_num_col_dims": 1}),
        F.FluidOp("elementwise_add", {"X": ["fc_raw"], "Y": ["fc_b"]},
                  {"Out": ["logits"]}, {"axis": -1}),
        F.FluidOp("softmax", {"X": ["logits"]}, {"Out": ["probs"]}, {"axis": -1}),
        F.FluidOp("fetch", {"X": ["probs"]}, {"Out": ["fetch"]}, {"col": 0}),
    ])
    b.ops = ops
    return prog, params


def write_mobilenet_v1(path: str, width: float = 1.0, image_size: int = 224,
                       classes: int = 1000, seed: int = 0) -> Dict[str, np.ndarray]:
    """Write the program and its combined params as a fluid model
    directory; returns the params."""
    prog, params = mobilenet_v1_program(width, image_size, classes, seed)
    F.save_fluid_dir(path, prog, params)
    return params
