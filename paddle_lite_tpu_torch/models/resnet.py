"""ResNet-50 — BASELINE config #2 (the deeper conv stack; the reference's
``resnet50_test.cc`` integration model).

Port of ``paddle_lite_tpu/models/resnet.py``: the same builder calls in the
same order, so one seed gives the same graph and weights, including the
``ablate_*`` flags of its signature.  Bottleneck blocks are emitted unfused
(conv / batch_norm / relu / elementwise_add as separate ops); the pipeline
folds BN, fuses the shortcut add as ``ResidualData`` into the first conv
that feeds it (the projection in a stage's first block, the expansion in
the others) and the trailing relu into that conv's epilogue.

Under ``QuantConfig()`` the 7x7 stem stays fp32 (``skip_stem_conv``) on
the ``"torch"`` conv; the 16 reduce 1x1 convs, the 16 3x3 convs (through
their im2col rows), the 4 expansion convs without a residual, the 16 convs
that carry the int8 residual (added in the GEMM's epilogue) and the fc run
on the int8 GEMM: 53 launches (``ops/kernels/select.py``).
"""

from __future__ import annotations

from ..core.builder import GraphBuilder
from ..core.ir import Graph

_STAGES = [  # (num_blocks, mid_channels, out_channels, first_stride)
    (3, 64, 256, 1),
    (4, 128, 512, 2),
    (6, 256, 1024, 2),
    (3, 512, 2048, 2),
]


def _bottleneck(b: GraphBuilder, x: str, mid: int, out: int, stride: int,
                project: bool, residual: bool = True) -> str:
    if not residual:
        # ablation: the conv chain alone (no projection conv, no skip add)
        y = b.conv_bn_act(x, mid, 1, act="relu")
        y = b.conv_bn_act(y, mid, 3, stride=stride, padding=1, act="relu")
        y = b.conv2d(y, out, 1)
        y = b.batch_norm(y)
        return b.act(y, "relu")
    if project:
        shortcut = b.conv2d(x, out, 1, stride=stride)
        shortcut = b.batch_norm(shortcut)
    else:
        shortcut = x
    y = b.conv_bn_act(x, mid, 1, act="relu")
    y = b.conv_bn_act(y, mid, 3, stride=stride, padding=1, act="relu")
    y = b.conv2d(y, out, 1)
    y = b.batch_norm(y)
    y = b.eltwise(y, shortcut, "add")
    return b.act(y, "relu")


def build(batch: int = 1, image_size: int = 224, num_classes: int = 1000,
          seed: int = 0, with_softmax: bool = True,
          ablate_residual: bool = False, ablate_stem: bool = False,
          ablate_head: bool = False) -> Graph:
    """``ablate_*`` drop one structural piece each (the skip adds and
    projections / the 7x7 stem, replaced by a 1x1 stride-2 conv / the fc
    and softmax), for whole-model cost attribution by end-to-end deltas."""
    b = GraphBuilder("resnet50", seed=seed)
    x = b.input("image", (batch, image_size, image_size, 3))
    if ablate_stem:
        x = b.conv_bn_act(x, 64, 1, stride=2, act="relu")  # cheap 1x1 stem
    else:
        x = b.conv_bn_act(x, 64, 7, stride=2, padding=3, act="relu")
    x = b.pool2d(x, "max", ksize=3, stride=2, padding=1)
    for n_blocks, mid, out, stride in _STAGES:
        for i in range(n_blocks):
            x = _bottleneck(b, x, mid, out,
                            stride=stride if i == 0 else 1,
                            project=(i == 0),
                            residual=not ablate_residual)
    x = b.pool2d(x, "avg", global_pooling=True)
    x = b.reshape(x, (batch, 2048))
    if not ablate_head:
        x = b.fc(x, num_classes, name="classifier")
        if with_softmax:
            x = b.softmax(x)
    b.mark_output(x)
    return b.build()
