"""DBNet detection postprocessing — probability map → text boxes.

A copy of ``paddle_lite_tpu/tools/db_postprocess.py`` (the port may not
import the JAX package; this module is host-side numpy and imports neither
package).  The reference shipped it in its OCR demo (``lite/demo/cxx`` det
postprocess, clipper-based polygon handling).  It runs on the host on the
final probability map, after the device part of the model: binarize →
connected components (two-pass union-find) → per-component bounding boxes
with score filtering and box unclipping.
"""

from __future__ import annotations

import dataclasses
from typing import List

import numpy as np


@dataclasses.dataclass
class TextBox:
    x1: int
    y1: int
    x2: int
    y2: int
    score: float


def _connected_components(mask: np.ndarray) -> np.ndarray:
    """Two-pass 4-connectivity labeling; returns int32 label map (0 = bg)."""
    h, w = mask.shape
    labels = np.zeros((h, w), np.int32)
    parent: List[int] = [0]

    def find(a: int) -> int:
        while parent[a] != a:
            parent[a] = parent[parent[a]]
            a = parent[a]
        return a

    def union(a: int, b: int) -> None:
        ra, rb = find(a), find(b)
        if ra != rb:
            parent[max(ra, rb)] = min(ra, rb)

    nxt = 1
    for i in range(h):
        row = mask[i]
        for j in range(w):
            if not row[j]:
                continue
            up = labels[i - 1, j] if i else 0
            left = labels[i, j - 1] if j else 0
            if up and left:
                labels[i, j] = min(up, left)
                union(up, left)
            elif up or left:
                labels[i, j] = up or left
            else:
                parent.append(nxt)
                labels[i, j] = nxt
                nxt += 1
    # resolve
    flat = np.asarray([find(k) for k in range(nxt)], np.int32)
    return flat[labels]


def extract_boxes(
    prob_map: np.ndarray,
    *,
    bin_thresh: float = 0.3,
    box_thresh: float = 0.6,
    unclip_ratio: float = 1.5,
    min_size: int = 3,
    max_boxes: int = 100,
) -> List[TextBox]:
    """prob_map: (H, W) or (H, W, 1) fp32 in [0,1] from the DB head."""
    p = np.asarray(prob_map)
    if p.ndim == 3:
        p = p[..., 0]
    mask = p > bin_thresh
    if not mask.any():
        return []
    labels = _connected_components(mask)
    boxes: List[TextBox] = []
    for lab in np.unique(labels):
        if lab == 0:
            continue
        ys, xs = np.nonzero(labels == lab)
        if ys.size == 0:
            continue
        y1, y2 = int(ys.min()), int(ys.max())
        x1, x2 = int(xs.min()), int(xs.max())
        if (y2 - y1 + 1) < min_size or (x2 - x1 + 1) < min_size:
            continue
        score = float(p[ys, xs].mean())
        if score < box_thresh:
            continue
        # unclip: expand the box by area/perimeter * ratio (DB paper's
        # polygon offset, axis-aligned simplification)
        bw, bh = x2 - x1 + 1, y2 - y1 + 1
        delta = int(round(bw * bh * unclip_ratio / (2 * (bw + bh))))
        h, w = p.shape
        boxes.append(TextBox(
            x1=max(x1 - delta, 0), y1=max(y1 - delta, 0),
            x2=min(x2 + delta, w - 1), y2=min(y2 + delta, h - 1),
            score=score,
        ))
    boxes.sort(key=lambda b: -b.score)
    return boxes[:max_boxes]
