"""MobileNetV3-Large — BASELINE config #3a (depthwise + SE blocks +
hard_swish; the SE gate's multiply and hard_swish run inside the int8
epilogues after fusion).

Port of ``paddle_lite_tpu/models/mobilenet_v3.py``: the same builder calls
in the same order, so one seed gives the same graph and weights, including
the ``ablate_*`` flags of its signature.  The SE module is emitted as its op
graph (global pool → 1x1 conv relu → 1x1 conv → hard_sigmoid →
elementwise_mul broadcast); the quantize pass runs the gate multiply int8
in, int8 out.
"""

from __future__ import annotations

from ..core.builder import GraphBuilder
from ..core.ir import Graph

# (kernel, exp_size, out_c, use_se, act, stride) — MobileNetV3-Large spec
_BLOCKS = [
    (3, 16, 16, False, "relu", 1),
    (3, 64, 24, False, "relu", 2),
    (3, 72, 24, False, "relu", 1),
    (5, 72, 40, True, "relu", 2),
    (5, 120, 40, True, "relu", 1),
    (5, 120, 40, True, "relu", 1),
    (3, 240, 80, False, "hard_swish", 2),
    (3, 200, 80, False, "hard_swish", 1),
    (3, 184, 80, False, "hard_swish", 1),
    (3, 184, 80, False, "hard_swish", 1),
    (3, 480, 112, True, "hard_swish", 1),
    (3, 672, 112, True, "hard_swish", 1),
    (5, 672, 160, True, "hard_swish", 2),
    (5, 960, 160, True, "hard_swish", 1),
    (5, 960, 160, True, "hard_swish", 1),
]


def _se(b: GraphBuilder, x: str, reduce_ratio: int = 4) -> str:
    c = b.g.vars[x].shape[-1]
    s = b.pool2d(x, "avg", global_pooling=True)  # (N,1,1,C)
    s = b.conv2d(s, max(c // reduce_ratio, 8), 1, bias=True)
    s = b.act(s, "relu")
    s = b.conv2d(s, c, 1, bias=True)
    s = b.act(s, "hard_sigmoid", slope=0.2, offset=0.5)
    return b.eltwise(x, s, "mul")


def _block(b: GraphBuilder, x: str, kernel: int, exp: int, out_c: int,
           use_se: bool, act: str, stride: int,
           skip_dw: bool = False) -> str:
    in_c = b.g.vars[x].shape[-1]
    shortcut = x if (stride == 1 and in_c == out_c) else None
    y = x
    if exp != in_c:
        y = b.conv_bn_act(y, exp, 1, act=act)
    if skip_dw and stride == 1:
        pass  # ablation: drop the (stride-1) depthwise stage entirely
    else:
        y = b.conv_bn_act(y, exp, kernel, stride=stride, padding=kernel // 2,
                          depthwise=True, act=act)
    if use_se:
        y = _se(b, y)
    y = b.conv2d(y, out_c, 1)
    y = b.batch_norm(y)
    if shortcut is not None:
        y = b.eltwise(y, shortcut, "add")
    return y


def build(batch: int = 1, image_size: int = 224, num_classes: int = 1000,
          seed: int = 0, with_softmax: bool = True,
          ablate_se: bool = False, ablate_dw: bool = False,
          ablate_hs: bool = False) -> Graph:
    """``ablate_*`` drop structural pieces (SE gates / depthwise convs /
    hard_swish→relu), for whole-model cost attribution by end-to-end
    deltas."""
    b = GraphBuilder("mobilenet_v3_large", seed=seed)
    x = b.input("image", (batch, image_size, image_size, 3))
    act0 = "relu" if ablate_hs else "hard_swish"
    x = b.conv_bn_act(x, 16, 3, stride=2, padding=1, act=act0)
    for kernel, exp, out_c, use_se, act, stride in _BLOCKS:
        if ablate_hs and act == "hard_swish":
            act = "relu"
        x = _block(b, x, kernel, exp, out_c, use_se and not ablate_se, act,
                   stride, skip_dw=ablate_dw)
    x = b.conv_bn_act(x, 960, 1, act="hard_swish")
    x = b.pool2d(x, "avg", global_pooling=True)
    x = b.conv2d(x, 1280, 1, bias=True)
    x = b.act(x, "hard_swish")
    x = b.reshape(x, (batch, 1280))
    x = b.fc(x, num_classes, name="classifier")
    if with_softmax:
        x = b.softmax(x)
    b.mark_output(x)
    return b.build()
