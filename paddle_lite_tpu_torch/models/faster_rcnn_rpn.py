"""Faster R-CNN's region-proposal stage as one graph: ``anchor_generator``
→ ``generate_proposals`` → ``roi_align``.

The stage of PaddleDetection's ``faster_rcnn_r50_1x`` (R50-C4) between the
backbone and the box head, at its test settings by default: an 800×1333
image, the C4 map at stride 16 (50×84×1,024), 15 anchors a cell (sizes
32-512, ratios 0.5 / 1 / 2), the top 6,000 anchors by objectness, greedy
NMS at IoU 0.7 down to 1,000 proposals, and ``roi_align`` 14×14 over them.
The backbone and the RPN head's convs are cut: the map, the objectness
scores and the box deltas are graph inputs (:func:`feed` draws them from a
seed).  One image: ``roi_align`` takes the proposals of image 0, so the
(1, post, 4) proposals are reshaped to (post, 4) rows for it.

``tools.opt.optimize`` (or ``create_predictor``) tags ``generate_proposals``
``"cuda"``: its NMS runs on the NMS kernel without a host sync, so the
whole stage goes through ``Predictor`` as one CUDA graph.

Outputs: the proposals (1, post, 4), their scores (1, post) and the pooled
features (post, ph, pw, C).
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np

from ..core.builder import GraphBuilder
from ..core.ir import Graph

IMAGE = (800, 1333)
FEAT = (50, 84, 1024)
ATTRS = {
    "anchor_generator": {"anchor_sizes": [32.0, 64.0, 128.0, 256.0, 512.0],
                         "aspect_ratios": [0.5, 1.0, 2.0], "stride": [16.0, 16.0],
                         "variances": [1.0, 1.0, 1.0, 1.0], "offset": 0.5},
    "generate_proposals": {"pre_nms_topN": 6000, "post_nms_topN": 1000,
                           "nms_thresh": 0.7, "min_size": 0.0, "eta": 1.0},
    "roi_align": {"pooled_height": 14, "pooled_width": 14, "spatial_scale": 1.0 / 16,
                  "sampling_ratio": 0},
}


def anchors_a_cell(attrs=ATTRS) -> int:
    a = attrs["anchor_generator"]
    return len(a["anchor_sizes"]) * len(a["aspect_ratios"])


def build(feat: Tuple[int, int, int] = FEAT, attrs: Dict[str, dict] = ATTRS) -> Graph:
    """The stage over a (1, H, W, C) map; inputs ``feat``, ``scores`` (1, H,
    W, A), ``deltas`` (1, H, W, 4A) and ``im_shape`` (1, 2) [h, w]."""
    fh, fw, c = feat
    a = anchors_a_cell(attrs)
    b = GraphBuilder("faster_rcnn_rpn")
    x = b.input("feat", (1, fh, fw, c))
    scores = b.input("scores", (1, fh, fw, a))
    deltas = b.input("deltas", (1, fh, fw, 4 * a))
    im = b.input("im_shape", (1, 2))
    anc, var = b.op("anchor_generator", {"Input": [x]}, attrs=attrs["anchor_generator"],
                    out_slots=("Anchors", "Variances"))
    rois, probs = b.op("generate_proposals",
                       {"Scores": [scores], "BboxDeltas": [deltas], "ImShape": [im],
                        "Anchors": [anc], "Variances": [var]},
                       attrs=attrs["generate_proposals"], shape_args=[scores],
                       out_slots=("RpnRois", "RpnRoiProbs"))
    post = int(attrs["generate_proposals"]["post_nms_topN"])
    pooled = b.op("roi_align", {"X": [x], "ROIs": [b.reshape(rois, (post, 4))]},
                  attrs=attrs["roi_align"])[0]
    b.mark_output(rois, probs, pooled)
    return b.build()


def feed(feat: Tuple[int, int, int] = FEAT, image: Tuple[int, int] = IMAGE,
         attrs: Dict[str, dict] = ATTRS, seed: int = 14) -> Dict[str, np.ndarray]:
    """A random map (N(0, 1)), objectness scores (U(0, 1)) and deltas
    (0.2·N(0, 1)), drawn in that order from `seed`, and the image's size."""
    rng = np.random.default_rng(seed)
    fh, fw, c = feat
    a = anchors_a_cell(attrs)
    return {"feat": rng.normal(0, 1, (1, fh, fw, c)).astype(np.float32),
            "scores": rng.uniform(0, 1, (1, fh, fw, a)).astype(np.float32),
            "deltas": (rng.normal(0, 1, (1, fh, fw, 4 * a)) * 0.2).astype(np.float32),
            "im_shape": np.array([image], np.float32)}
