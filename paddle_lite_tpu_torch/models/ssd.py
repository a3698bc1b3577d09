"""SSD-MobileNetV1 300x300 — BASELINE config #3b (detection head).

Port of ``paddle_lite_tpu/models/ssd.py``: the same builder calls in the
same order, so one seed gives the same graph, attrs and weights.  The
classic paddle ssd_mobilenet_v1 layout (the reference's SSD demo model,
``lite/demo/cxx`` mobilenetv1-ssd): MobileNetV1 backbone truncated after
conv11 (first head tap) and conv13, four extra conv stages, and per-tap
3x3 heads emitting box regression (4/prior) and class confidences.
Priors come from ``prior_box`` ops (computed once per op), decode via
``box_coder``, final selection via the fixed-shape ``multiclass_nms`` on
the NMS kernel.  The conv trunk quantizes int8; detection post-ops stay
fp32 islands exactly as in the reference.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np

from ..core.builder import GraphBuilder
from ..core.ir import Graph
from . import mobilenet_v1


def _backbone_taps(b: GraphBuilder, x: str) -> Tuple[str, str]:
    """MobileNetV1 trunk; returns (conv11_out, conv13_out)."""
    x = b.conv_bn_act(x, 32, 3, stride=2, padding=1)
    in_c = 32
    tap11 = None
    for i, (stride, out_c) in enumerate(mobilenet_v1._BLOCKS):
        x = b.conv_bn_act(x, in_c, 3, stride=stride, padding=1, depthwise=True)
        x = b.conv_bn_act(x, out_c, 1)
        in_c = out_c
        if i == 10:  # conv11: 512 channels, 19x19 at 300 input
            tap11 = x
    return tap11, x  # conv13: 1024ch 10x10


def build(batch: int = 1, image_size: int = 300, num_classes: int = 21,
          seed: int = 0) -> Graph:
    b = GraphBuilder("ssd_mobilenet_v1", seed=seed)
    image = b.input("image", (batch, image_size, image_size, 3))
    tap11, tap13 = _backbone_taps(b, image)

    taps: List[str] = [tap11, tap13]
    # extra feature stages: 1x1 reduce + 3x3 s2 expand
    extra_cfg = [(256, 512), (128, 256), (128, 256), (64, 128)]
    x = tap13
    for mid, out in extra_cfg:
        x = b.conv_bn_act(x, mid, 1)
        x = b.conv_bn_act(x, out, 3, stride=2, padding=1)
        taps.append(x)

    # per-tap prior config (paddle ssd_mobilenet_v1)
    min_ratio, max_ratio = 20, 90
    n_taps = len(taps)
    step = (max_ratio - min_ratio) // (n_taps - 2)
    min_sizes = [image_size * 0.1]
    max_sizes = [image_size * 0.2]
    r = min_ratio
    for _ in range(n_taps - 1):
        min_sizes.append(image_size * r / 100.0)
        max_sizes.append(image_size * (r + step) / 100.0)
        r += step
    aspect_ratios = [[2.0], [2.0, 3.0], [2.0, 3.0], [2.0, 3.0], [2.0, 3.0], [2.0, 3.0]]

    locs, confs, priors, prior_vars = [], [], [], []
    for i, tap in enumerate(taps):
        # matches prior_box's expansion: ar=1 + each ratio with its flip,
        # plus one extra box for max_size
        n_priors = (1 + 2 * len(aspect_ratios[i])) + 1
        loc = b.conv2d(tap, n_priors * 4, 3, padding=1, bias=True)
        conf = b.conv2d(tap, n_priors * num_classes, 3, padding=1, bias=True)
        n, h, w, _ = b.g.vars[loc].shape
        locs.append(b.reshape(loc, (n, h * w * n_priors, 4)))
        confs.append(b.reshape(conf, (n, h * w * n_priors, num_classes)))
        boxes, variances = b.op(
            "prior_box",
            {"Input": [tap], "Image": [image]},
            attrs={
                "min_sizes": [min_sizes[i]],
                "max_sizes": [max_sizes[i]],
                "aspect_ratios": aspect_ratios[i],
                "flip": True,
                "clip": True,
                "variances": [0.1, 0.1, 0.2, 0.2],
            },
            shape_args=[tap],
            out_slots=("Boxes", "Variances"),
        )
        h_, w_, np_, _ = b.g.vars[boxes].shape
        priors.append(b.reshape(boxes, (h_ * w_ * np_, 4)))
        prior_vars.append(b.reshape(variances, (h_ * w_ * np_, 4)))

    loc_all = b.concat(locs, axis=1)  # (N, P, 4)
    conf_all = b.concat(confs, axis=1)  # (N, P, C)
    prior_all = b.concat(priors, axis=0)  # (P, 4)
    pvar_all = b.concat(prior_vars, axis=0)

    scores = b.softmax(conf_all, axis=-1)
    decoded = b.op(
        "box_coder",
        {"PriorBox": [prior_all], "PriorBoxVar": [pvar_all],
         "TargetBox": [loc_all]},
        attrs={"code_type": "decode_center_size", "box_normalized": True},
        shape_args=[prior_all, pvar_all, loc_all],
        out_slots=("OutputBox",),
    )[0]
    out = b.op(
        "multiclass_nms",
        {"BBoxes": [decoded], "Scores": [scores]},
        attrs={"background_label": 0, "score_threshold": 0.01,
               "nms_top_k": 400, "nms_threshold": 0.45, "keep_top_k": 100,
               # candidate selection tier: the top 3 of each of 176
               # buckets of neighbouring priors (ops/kernels/ops_cuda.py,
               # bucket_candidates); False / True select each class's
               # exact top nms_top_k instead
               "approx_top_k": "bucket3",
               "bucket_candidates": 176},
        shape_args=[decoded, scores],
    )[0]
    b.mark_output(out)
    return b.build()
