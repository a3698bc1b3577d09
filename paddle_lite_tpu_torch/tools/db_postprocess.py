"""DBNet detection postprocessing — probability map → text boxes.

Port of ``paddle_lite_tpu/tools/db_postprocess.py`` (the port may not
import the JAX package; this module is host-side numpy and imports neither
package).  The reference shipped it in its OCR demo (``lite/demo/cxx`` det
postprocess, clipper-based polygon handling).  It runs on the host on the
final probability map, after the device part of the model: binarize →
connected components → per-component bounding boxes with score filtering
and box unclipping.

The boxes are the reference's, box for box; the work is linear in the
pixels.  The reference labels components by a per-pixel union-find loop
in Python and then scans the whole map once per component, which on a
640×640 speckled map (thousands of components) takes about a minute a
call.  Here the components come from min-label hooking and pointer jumping
over the 4-neighbour edges (each component's label is its first pixel in
raster order, so the components come in the reference's order), and each
component's pixels are gathered once, in raster order, so a score is the
reference's float32 mean of the same values in the same order.
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
    """4-connectivity labels of `mask`, int32 (0 = background): components
    numbered 1, 2, ... in the raster order of their first pixels."""
    h, w = mask.shape
    flat = mask.ravel()
    pix = np.arange(h * w).reshape(h, w)
    right = pix[:, :-1][mask[:, :-1] & mask[:, 1:]]  # pixels joined to the next
    down = pix[:-1, :][mask[:-1, :] & mask[1:, :]]  # ... and to the one below
    a, b = np.concatenate([right, down]), np.concatenate([right + 1, down + w])
    parent = np.arange(h * w)
    while True:
        pa, pb = parent[a], parent[b]
        diff = pa != pb
        if not diff.any():
            break
        # hook each larger root under the smaller one, then jump pointers
        # until every pixel points at its root
        np.minimum.at(parent, np.maximum(pa, pb)[diff], np.minimum(pa, pb)[diff])
        while True:
            nxt = parent[parent]
            if np.array_equal(nxt, parent):
                break
            parent = nxt
    labels = np.zeros(h * w, np.int32)
    roots = parent[flat]
    labels[flat] = np.searchsorted(np.unique(roots), roots) + 1
    return labels.reshape(h, w)


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
    h, w = p.shape
    fg = np.flatnonzero(labels)  # raster order
    lab = labels.ravel()[fg]
    order = np.argsort(lab, kind="stable")  # by component, raster order within
    fg, lab = fg[order], lab[order]
    starts = np.flatnonzero(np.r_[True, lab[1:] != lab[:-1]])
    ends = np.r_[starts[1:], len(lab)]
    ys_all, xs_all = np.divmod(fg, w)
    vals = p.ravel()[fg]
    boxes: List[TextBox] = []
    for s0, s1 in zip(starts, ends):
        ys, xs = ys_all[s0:s1], xs_all[s0:s1]
        y1, y2 = int(ys.min()), int(ys.max())
        x1, x2 = int(xs.min()), int(xs.max())
        if (y2 - y1 + 1) < min_size or (x2 - x1 + 1) < min_size:
            continue
        score = float(vals[s0:s1].mean())
        if score < box_thresh:
            continue
        # unclip: expand the box by area/perimeter * ratio (DB paper's
        # polygon offset, axis-aligned simplification)
        bw, bh = x2 - x1 + 1, y2 - y1 + 1
        delta = int(round(bw * bh * unclip_ratio / (2 * (bw + bh))))
        boxes.append(TextBox(
            x1=max(x1 - delta, 0), y1=max(y1 - delta, 0),
            x2=min(x2 + delta, w - 1), y2=min(y2 + delta, h - 1),
            score=score,
        ))
    boxes.sort(key=lambda b: -b.score)
    return boxes[:max_boxes]
