"""MobileNetV1 — the flagship BASELINE config (per-channel PTQ int8).

Port of ``paddle_lite_tpu/models/mobilenet_v1.py``: the same builder calls
in the same order, so one seed gives the same graph and weights.  Built as an *unfused* op graph (conv → batch_norm → relu chains) exactly as a
fluid export of MobileNetV1 would arrive at the reference's optimizer
(cf. the reference's ``mobilenetv1_test.cc`` / ``mobilenetv1_int8_test.cc``
integration tests); the fusion + quantization pipeline then does its work.
Layout is NHWC, as in the reference; classifier is global-avg-pool + fc + softmax.
"""

from __future__ import annotations

from ..core.builder import GraphBuilder
from ..core.ir import Graph

# (stride, out_channels) of the 13 depthwise-separable blocks
_BLOCKS = [
    (1, 64), (2, 128), (1, 128), (2, 256), (1, 256), (2, 512),
    (1, 512), (1, 512), (1, 512), (1, 512), (1, 512),
    (2, 1024), (1, 1024),
]


def build(
    batch: int = 1,
    image_size: int = 224,
    num_classes: int = 1000,
    width_mult: float = 1.0,
    seed: int = 0,
    with_softmax: bool = True,
) -> Graph:
    b = GraphBuilder(f"mobilenet_v1_{width_mult}x", seed=seed)
    x = b.input("image", (batch, image_size, image_size, 3))

    def c(ch: int) -> int:
        return max(8, int(ch * width_mult))

    x = b.conv_bn_act(x, c(32), 3, stride=2, padding=1)
    in_c = c(32)
    for stride, out_c in _BLOCKS:
        x = b.conv_bn_act(x, in_c, 3, stride=stride, padding=1, depthwise=True)
        x = b.conv_bn_act(x, c(out_c), 1)
        in_c = c(out_c)
    x = b.pool2d(x, "avg", global_pooling=True)
    x = b.reshape(x, (batch, in_c))
    x = b.fc(x, num_classes, name="classifier")
    if with_softmax:
        x = b.softmax(x)
    b.mark_output(x)
    return b.build()
