"""ResNet-50 (He et al. 2015, arXiv:1512.03385), plain PyTorch.

The 7x7 stride-2 stem with batch norm and ReLU, a 3x3 stride-2 max pool, 16
bottleneck blocks in four stages (1x1 reduce, 3x3 carrying the stage's
stride, 1x1 expand; a strided 1x1 projection on the shortcut of each stage's
first block), global average pooling and the classifier, NHWC with HWIO
weights, at the sizes of ``configs/resnet50_int8.json``.

The shortcut add and the ReLU after it belong to one conv's output, as the
int8 scheme quantizes them: in a stage's first block the expand conv's output
is requantized and added in the projection conv; in the others the block's
input is added in the expand conv.  :func:`params` lists the weights in the
order the model's layers use them (a first block's projection before its
reduce conv).
"""

from __future__ import annotations

from typing import Dict, List, Tuple

BN = ("gamma", "beta", "mean", "var")


def _blocks(cfg: dict):
    """(name, in channels, mid, out, stride, projects) of every block."""
    c_in = cfg["stem_channels"]
    for s, (n, mid, out, stride) in enumerate(cfg["stages"]):
        for i in range(n):
            yield (f"s{s}b{i}", c_in, mid, out, stride if i == 0 else 1, i == 0)
            c_in = out


def params(cfg: dict) -> List[Tuple[str, tuple, str]]:
    """(name, shape, kind) of every weight, in the layers' order."""
    out = []

    def conv(name, shape):
        out.append((f"{name}.w", shape, "conv"))
        out.extend((f"{name}.bn.{k}", (shape[-1],), f"bn_{k}") for k in BN)

    conv("stem", (7, 7, cfg["image_channels"], cfg["stem_channels"]))
    c_last = cfg["stem_channels"]
    for name, c_in, mid, c_out, _, project in _blocks(cfg):
        if project:
            conv(f"{name}.proj", (1, 1, c_in, c_out))
        conv(f"{name}.reduce", (1, 1, c_in, mid))
        conv(f"{name}.mid", (3, 3, mid, mid))
        conv(f"{name}.expand", (1, 1, mid, c_out))
        c_last = c_out
    out.append(("fc.w", (c_last, cfg["num_classes"]), "fc"))
    out.append(("fc.b", (cfg["num_classes"],), "bias"))
    return out


def fold(cfg: dict, raw: Dict[str, object]) -> dict:
    """Each conv's (weight, bias) with its batch norm folded in."""
    from .qref import fold_bn

    p = {}
    for name, _, kind in params(cfg):
        if kind == "conv":
            base = name[:-2]
            p[base] = fold_bn(raw[name], *(raw[f"{base}.bn.{k}"] for k in BN))
    p["fc"] = (raw["fc.w"], raw["fc.b"])
    return p


def forward(be, cfg: dict, p: dict, x):
    x = be.conv(x, p["stem"], stride=2, pad=3, act="relu")
    x = be.maxpool(x, 3, 2, 1)
    for name, _, _, _, stride, project in _blocks(cfg):
        y = be.conv(x, p[f"{name}.reduce"], act="relu")
        y = be.conv(y, p[f"{name}.mid"], stride=stride, pad=1, act="relu")
        if project:
            e = be.conv(y, p[f"{name}.expand"])
            x = be.conv(x, p[f"{name}.proj"], stride=stride, residual=e, act="relu")
        else:
            x = be.conv(y, p[f"{name}.expand"], residual=x, act="relu")
    return be.fc(be.avgpool(x), p["fc"])
