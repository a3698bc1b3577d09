"""MobileNetV1 (Howard et al. 2017, arXiv:1704.04861), plain PyTorch.

The stem 3x3 stride-2 conv, 13 depthwise-separable blocks (a 3x3 depthwise
conv and a 1x1 conv, each with batch norm and ReLU), global average pooling
and the classifier, NHWC with HWIO weights, at the sizes of
``configs/mobilenet_v1_int8.json``.  :func:`params` lists the weights in the
order the model's layers use them (conv weight, then its batch norm's scale,
shift, mean and variance; the classifier's weight and bias);
:func:`forward` runs over a backend of ``qref``.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

BN = ("gamma", "beta", "mean", "var")


def params(cfg: dict) -> List[Tuple[str, tuple, str]]:
    """(name, shape, kind) of every weight, in the layers' order."""
    out = []

    def conv(name, shape):
        out.append((f"{name}.w", shape, "conv"))
        out.extend((f"{name}.bn.{k}", (shape[-1],), f"bn_{k}") for k in BN)

    c_in = cfg["stem_channels"]
    conv("stem", (3, 3, cfg["image_channels"], c_in))
    for i, (_, c_out) in enumerate(cfg["blocks"]):
        conv(f"dw{i}", (3, 3, 1, c_in))
        conv(f"pw{i}", (1, 1, c_in, c_out))
        c_in = c_out
    out.append(("fc.w", (c_in, cfg["num_classes"]), "fc"))
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
    x = be.conv(x, p["stem"], stride=2, pad=1, act="relu")
    for i, (stride, _) in enumerate(cfg["blocks"]):
        x = be.conv(x, p[f"dw{i}"], stride=stride, pad=1,
                    groups=x.value.shape[-1], act="relu")
        x = be.conv(x, p[f"pw{i}"], act="relu")
    return be.fc(be.avgpool(x), p["fc"])
