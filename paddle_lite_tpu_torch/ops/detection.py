"""Detection ops under the ``torch`` tag: ``prior_box``,
``density_prior_box``, ``box_coder`` (decode), ``yolo_box`` and
``multiclass_nms`` / ``multiclass_nms2``.

Port of ``paddle_lite_tpu/ops/detection.py``: ``prior_box`` (``:35-104``),
``density_prior_box`` (``:107-160``), ``box_coder`` (``:169-203``),
``yolo_box`` (``:211-260``), the NMS shape function (``:321-325``),
``_iou_matrix`` / ``_nms_single_class`` (``:262-318``), ``_nms_merge``
(``:328-358``) and ``multiclass_nms_xla`` (``:361-396``).  The kernel form
of ``multiclass_nms`` (the reference's ``"pallas"`` impl) is in
``ops/kernels/ops_cuda.py``.  All of it runs in fp32, outside the int8
regions, as in the reference.

``prior_box`` and ``density_prior_box`` depend only on shapes, so each is
computed once per op (in numpy float32, the reference's arithmetic) and
kept on the device; XLA constant-folds them there.  ``density_prior_box``'s
shape function counts ``len(fixed_ratios)`` boxes for each density cell, as
its impl makes them in both packages; the reference's shape function
counts one (a fault there when there are several ratios).  Top-k selections follow ``jax.lax.top_k``
exactly (:func:`topk_stable`): descending in IEEE total order, so +0.0
ranks above −0.0, and equal values by lower index.

Faster R-CNN's RPN ops (``detection.py:523-684`` there):
``anchor_generator`` (shape-only, made once per op in numpy float32 as
``prior_box`` is), ``generate_proposals`` (top ``pre_nms_topN`` by
objectness, box decode and clip, the ``min_size`` filter, then greedy NMS
through :func:`nms_single_class` over the top ``post_nms_topN`` of those,
as the reference's ``_nms_single_class`` takes them) and ``roi_align``.
The ``"torch"`` ``generate_proposals`` reads the NMS fixed point back every
round, so it is marked ``syncs_host``; its ``"cuda"`` impl
(``ops/kernels/ops_cuda.py``) runs the same candidates through the NMS
kernel in the division form, with no host sync, and ``kernel_pick`` tags
every ``generate_proposals`` op with it.  ``roi_align`` processes the RoIs in chunks, so
that 1,000 RoIs × 1,024 channels never gather several GB at once.  One
departure, a fault there: the reference's ``roi_align`` pools every RoI
from image 0 whatever N is and ignores ``RoisBatchIndex``; the port raises
for N > 1.
"""

from __future__ import annotations

import math
from typing import List, Optional, Tuple

import numpy as np
import torch

from ..core.registry import OPS
from .common import f32

# (G, k, k) elements a batched Jacobi step materializes at once
_CHUNK_ELEMS = 1 << 24


def topk_stable(x: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The k greatest entries along the last axis as ``jax.lax.top_k``
    gives them: descending in IEEE total order (+0.0 above −0.0), equal
    values by lower index.  ``torch.topk`` promises no order among ties."""
    bits = x.contiguous().view(torch.int32)
    key = bits ^ ((bits >> 31) & 0x7FFFFFFF)  # float total order as int32
    idx = torch.sort(key, dim=-1, descending=True, stable=True).indices[..., :k]
    return x.gather(-1, idx), idx


def jacobi_keep(sup: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """Fixed point of ``keep[i] = valid[i] and no kept j with sup[j, i]``
    for (G, k, k) bool ``sup`` and (G, k) bool ``valid``, iterated from
    ``keep = valid`` for at most k rounds, as the reference's while loop."""
    keep = valid
    for _ in range(valid.shape[-1]):
        new = valid & ~(sup & keep.unsqueeze(-1)).any(dim=-2)
        if torch.equal(new, keep):
            break
        keep = new
    return keep


def chunks(g: int, k: int) -> List[slice]:
    """Slices of the instance axis that keep (G, k, k) temporaries bounded."""
    step = max(1, _CHUNK_ELEMS // max(1, k * k))
    return [slice(i, min(g, i + step)) for i in range(0, g, step)]


# ---------------------------------------------------------------------------
# prior_box (SSD anchors)
# ---------------------------------------------------------------------------

def _expand_aspect_ratios(attrs) -> List[float]:
    ars = [1.0]
    for ar in attrs.get("aspect_ratios", []):
        if not any(abs(ar - a) < 1e-6 for a in ars):
            ars.append(float(ar))
            if attrs.get("flip", True) and ar != 0:
                ars.append(1.0 / float(ar))
    return ars


def _prior_box_count(attrs) -> int:
    n_max = len(attrs.get("max_sizes", []))
    return len(attrs["min_sizes"]) * len(_expand_aspect_ratios(attrs)) + n_max


@OPS.shape_fn("prior_box")
def prior_box_shape(attrs, in_shapes):
    feat = in_shapes[0]  # NHWC feature map
    n = _prior_box_count(attrs)
    return [(feat[1], feat[2], n, 4), (feat[1], feat[2], n, 4)]


def prior_boxes(attrs, fh: int, fw: int, ih: int, iw: int):
    """(fh, fw, n, 4) boxes and variances, numpy float32."""
    f = np.float32
    step_w = attrs.get("step_w", 0.0) or iw / fw
    step_h = attrs.get("step_h", 0.0) or ih / fh
    offset = attrs.get("offset", 0.5)
    min_sizes = [float(s) for s in attrs["min_sizes"]]
    max_sizes = [float(s) for s in attrs.get("max_sizes", [])]
    ars = _expand_aspect_ratios(attrs)
    whs: List[Tuple[float, float]] = []
    for k, ms in enumerate(min_sizes):
        whs.append((ms, ms))  # ar = 1
        for ar in ars:
            if abs(ar - 1.0) < 1e-6:
                continue
            whs.append((ms * math.sqrt(ar), ms / math.sqrt(ar)))
        if k < len(max_sizes):
            big = math.sqrt(ms * max_sizes[k])
            whs.append((big, big))
    cx = (np.arange(fw, dtype=f) + f(offset)) * f(step_w)
    cy = (np.arange(fh, dtype=f) + f(offset)) * f(step_h)
    cxg, cyg = np.meshgrid(cx, cy)  # (fh, fw)
    wh = np.asarray(whs, f)
    cxg, cyg = cxg[:, :, None], cyg[:, :, None]
    bw = wh[None, None, :, 0] / f(2.0)
    bh = wh[None, None, :, 1] / f(2.0)
    boxes = np.stack([(cxg - bw) / f(iw), (cyg - bh) / f(ih),
                      (cxg + bw) / f(iw), (cyg + bh) / f(ih)], axis=-1)
    if attrs.get("clip", True):
        boxes = np.clip(boxes, f(0.0), f(1.0))
    var = np.asarray(attrs.get("variances", [0.1, 0.1, 0.2, 0.2]), f)
    return boxes.astype(f), np.broadcast_to(var, boxes.shape).copy()


@OPS.kernel("prior_box", "torch")
def prior_box_torch(ctx, op, ins):
    (_, fh, fw, _), (_, ih, iw, _) = ins["Input"][0].shape, ins["Image"][0].shape
    boxes, variances = ctx.const(op, "priors", lambda: tuple(
        ctx.tensor(a) for a in prior_boxes(op.attrs, fh, fw, ih, iw)))
    return {"Boxes": [boxes], "Variances": [variances]}


# ---------------------------------------------------------------------------
# box_coder (decode SSD regression against the priors)
# ---------------------------------------------------------------------------

@OPS.shape_fn("box_coder")
def box_coder_shape(attrs, in_shapes):
    # PriorBoxVar is optional, so TargetBox is the last shape argument
    return [in_shapes[-1]]


@OPS.kernel("box_coder", "torch")
def box_coder_torch(ctx, op, ins):
    prior = ins["PriorBox"][0].reshape(-1, 4)  # (M, 4) xyxy
    pvar = ins.get("PriorBoxVar", [None])[0]
    t = ins["TargetBox"][0]  # (N, M, 4) encoded deltas
    if op.attrs.get("code_type", "decode_center_size") != "decode_center_size":
        raise NotImplementedError("encode_center_size is a training-time op")
    one = 0.0 if op.attrs.get("box_normalized", True) else 1.0
    pw = prior[:, 2] - prior[:, 0] + one
    ph = prior[:, 3] - prior[:, 1] + one
    pcx = prior[:, 0] + pw * 0.5
    pcy = prior[:, 1] + ph * 0.5
    v = (pvar.reshape(-1, 4) if pvar is not None  # the reference's fp32 ones
         else torch.ones(prior.shape, dtype=torch.float32, device=prior.device))
    cx = v[:, 0] * t[..., 0] * pw + pcx
    cy = v[:, 1] * t[..., 1] * ph + pcy
    w = torch.exp(v[:, 2] * t[..., 2]) * pw
    h = torch.exp(v[:, 3] * t[..., 3]) * ph
    out = torch.stack([cx - w * 0.5, cy - h * 0.5,
                       cx + w * 0.5 - one, cy + h * 0.5 - one], dim=-1)
    return {"OutputBox": [out]}


# ---------------------------------------------------------------------------
# density_prior_box (``detection.py:107-160`` there)
# ---------------------------------------------------------------------------

def _density_count(attrs) -> int:
    cells = sum(int(d) * int(d) for _, d in zip(attrs.get("fixed_sizes", []),
                                                attrs.get("densities", [])))
    return cells * len(attrs.get("fixed_ratios", [1.0]))


@OPS.shape_fn("density_prior_box")
def density_prior_box_shape(attrs, in_shapes):
    feat = in_shapes[0]  # NHWC feature map
    n = _density_count(attrs)
    return [(feat[1], feat[2], n, 4), (feat[1], feat[2], n, 4)]


def density_prior_boxes(attrs, fh: int, fw: int, ih: int, iw: int):
    """(fh, fw, n, 4) boxes and variances, numpy float32: for each fixed
    size, ratio and density, a density × density grid of boxes around each
    cell's centre."""
    f = np.float32
    step_w = attrs.get("step_w", 0.0) or iw / fw
    step_h = attrs.get("step_h", 0.0) or ih / fh
    offset = attrs.get("offset", 0.5)
    whs: List[Tuple[float, float, float, float]] = []  # (dx, dy, w, h)
    for size, density in zip(attrs["fixed_sizes"], attrs["densities"]):
        size, density = float(size), int(density)
        for ar in attrs.get("fixed_ratios", [1.0]):
            bw = size * math.sqrt(float(ar))
            bh = size / math.sqrt(float(ar))
            step = size / density
            for di in range(density):
                for dj in range(density):
                    whs.append(((dj + 0.5) * step - size / 2.0,
                                (di + 0.5) * step - size / 2.0, bw, bh))
    cx = (np.arange(fw, dtype=f) + f(offset)) * f(step_w)
    cy = (np.arange(fh, dtype=f) + f(offset)) * f(step_h)
    cxg, cyg = np.meshgrid(cx, cy)
    d = np.asarray(whs, f).reshape(-1, 4)
    cxs = cxg[:, :, None] + d[None, None, :, 0]
    cys = cyg[:, :, None] + d[None, None, :, 1]
    bw = d[None, None, :, 2] / f(2.0)
    bh = d[None, None, :, 3] / f(2.0)
    boxes = np.stack([(cxs - bw) / f(iw), (cys - bh) / f(ih),
                      (cxs + bw) / f(iw), (cys + bh) / f(ih)], axis=-1)
    if attrs.get("clip", True):
        boxes = np.clip(boxes, f(0.0), f(1.0))
    var = np.asarray(attrs.get("variances", [0.1, 0.1, 0.2, 0.2]), f)
    return boxes.astype(f), np.broadcast_to(var, boxes.shape).copy()


@OPS.kernel("density_prior_box", "torch")
def density_prior_box_torch(ctx, op, ins):
    (_, fh, fw, _), (_, ih, iw, _) = ins["Input"][0].shape, ins["Image"][0].shape
    boxes, variances = ctx.const(op, "priors", lambda: tuple(
        ctx.tensor(a) for a in density_prior_boxes(op.attrs, fh, fw, ih, iw)))
    return {"Boxes": [boxes], "Variances": [variances]}


# ---------------------------------------------------------------------------
# yolo_box (``detection.py:211-260`` there)
# ---------------------------------------------------------------------------

@OPS.shape_fn("yolo_box")
def yolo_box_shape(attrs, in_shapes):
    n, h, w, _ = in_shapes[0]
    boxes = h * w * (len(attrs["anchors"]) // 2)
    return [(n, boxes, 4), (n, boxes, int(attrs["class_num"]))]


@OPS.kernel("yolo_box", "torch")
def yolo_box_torch(ctx, op, ins):
    """Decode a YOLOv3 head (N, H, W, an·(5 + classes)) NHWC against the
    image sizes (N, 2) [h, w]: boxes in pixels (clipped to the image with
    ``clip_bbox``), scores the class sigmoid times the objectness, zero
    where the objectness is not above ``conf_thresh``.  On the device."""
    x, img_size = ins["X"][0], ins["ImgSize"][0]
    a = op.attrs
    ncls = int(a["class_num"])
    n, h, w, _ = x.shape
    dev = x.device
    anchors = np.asarray(a["anchors"], np.float32).reshape(-1, 2)
    an = anchors.shape[0]
    down = a.get("downsample_ratio", 32)

    def make_consts():
        gx = np.broadcast_to(np.arange(w, dtype=np.float32)[None, :], (h, w))
        gy = np.broadcast_to(np.arange(h, dtype=np.float32)[:, None], (h, w))
        aw = anchors[:, 0] / np.float32(w * down)
        ah = anchors[:, 1] / np.float32(h * down)
        return tuple(ctx.tensor(v) for v in (gx, gy, aw, ah))

    gx, gy, aw, ah = ctx.const(op, "grid", make_consts)
    x = x.reshape(n, h, w, an, 5 + ncls)
    bx = (torch.sigmoid(x[..., 0]) + gx[None, :, :, None]) / f32(w, dev)
    by = (torch.sigmoid(x[..., 1]) + gy[None, :, :, None]) / f32(h, dev)
    bw = torch.exp(x[..., 2]) * aw
    bh = torch.exp(x[..., 3]) * ah
    conf = torch.sigmoid(x[..., 4])
    probs = torch.sigmoid(x[..., 5:]) * conf[..., None]
    probs = torch.where(conf[..., None] > f32(a.get("conf_thresh", 0.01), dev),
                        probs, torch.zeros((), dtype=probs.dtype, device=dev))
    imgh = img_size[:, 0].to(torch.float32)[:, None, None, None]
    imgw = img_size[:, 1].to(torch.float32)[:, None, None, None]
    half = f32(2.0, dev)
    boxes = torch.stack([(bx - bw / half) * imgw, (by - bh / half) * imgh,
                         (bx + bw / half) * imgw, (by + bh / half) * imgh], dim=-1)
    if a.get("clip_bbox", True):
        zero, one = f32(0.0, dev), f32(1.0, dev)
        boxes = torch.stack(
            [torch.minimum(torch.maximum(boxes[..., 0], zero), imgw - one),
             torch.minimum(torch.maximum(boxes[..., 1], zero), imgh - one),
             torch.minimum(torch.maximum(boxes[..., 2], zero), imgw - one),
             torch.minimum(torch.maximum(boxes[..., 3], zero), imgh - one)], dim=-1)
    return {"Boxes": [boxes.reshape(n, -1, 4)],
            "Scores": [probs.reshape(n, -1, ncls)]}


# ---------------------------------------------------------------------------
# multiclass_nms — fixed-size masked NMS
# ---------------------------------------------------------------------------

@OPS.shape_fn("multiclass_nms")
def multiclass_nms_shape(attrs, in_shapes):
    n = in_shapes[1][0]  # scores (N, M, C)
    return [(n, int(attrs.get("keep_top_k", 100)), 6)]


OPS.register("multiclass_nms2", infer_shape=multiclass_nms_shape)


def nms_attrs(attrs) -> dict:
    return {"iou_t": float(attrs.get("nms_threshold", 0.3)),
            "score_t": float(attrs.get("score_threshold", 0.01)),
            "nms_top_k": int(attrs.get("nms_top_k", 400)),
            "keep_top_k": int(attrs.get("keep_top_k", 100)),
            "background": int(attrs.get("background_label", 0))}


def exact_candidates(boxes: torch.Tensor, scores: torch.Tensor, k: int):
    """Each class's top-k scores and their boxes: (N, M, 4) boxes and
    (N, M, C) scores → (N, C, k) scores, (N, C, k, 4) boxes."""
    n, m, c = scores.shape
    top_s, idx = topk_stable(scores.transpose(1, 2), k)
    cand = boxes[:, None].expand(n, c, m, 4).gather(
        2, idx[..., None].expand(n, c, k, 4))
    return top_s, cand


def iou_matrix(boxes: torch.Tensor) -> torch.Tensor:
    """(..., K, 4) xyxy → (..., K, K) IoU."""
    zero = boxes.new_zeros(())
    area = (torch.maximum(boxes[..., 2] - boxes[..., 0], zero)
            * torch.maximum(boxes[..., 3] - boxes[..., 1], zero))
    lt = torch.maximum(boxes[..., :, None, :2], boxes[..., None, :, :2])
    rb = torch.minimum(boxes[..., :, None, 2:], boxes[..., None, :, 2:])
    wh = torch.maximum(rb - lt, zero)
    inter = wh[..., 0] * wh[..., 1]
    union = area[..., :, None] + area[..., None, :] - inter
    return inter / torch.maximum(union, f32(1e-10, boxes.device))


def nms_single_class(cand: torch.Tensor, top_scores: torch.Tensor,
                     iou_t: float, score_t: float) -> torch.Tensor:
    """Greedy NMS over score-descending candidates ((G, k, 4), (G, k)):
    the kept scores, suppressed and invalid entries +0.0.  The Jacobi fixed
    point of ``_nms_single_class`` there, ``iou > t`` by division."""
    g, k = top_scores.shape
    dev = cand.device
    tri = (torch.arange(k, device=dev)[:, None]
           < torch.arange(k, device=dev)[None, :])  # j < i
    valid = top_scores > f32(score_t, dev)
    keep = torch.empty_like(valid)
    for sl in chunks(g, k):
        sup = (iou_matrix(cand[sl]) > f32(iou_t, dev)) & tri
        keep[sl] = jacobi_keep(sup, valid[sl])
    return torch.where(keep, top_scores, top_scores.new_zeros(()))


def nms_merge(s_all: torch.Tensor, cand_all: torch.Tensor, *, background: int,
              keep_top_k: int, labels: Optional[torch.Tensor] = None):
    """Cross-class merge per image: (N, C, k) kept scores and (N, C, k, 4)
    boxes → (N, keep_top_k, 6) rows [label, score, x1, y1, x2, y2]; empty
    slots have label −1 (``_nms_merge`` there, batched over images).
    ``labels``: optional (C,) label per class row, for callers that removed
    the background row before NMS (then pass background=−1)."""
    n, c, k = s_all.shape
    dev = s_all.device
    cls = torch.arange(c, device=dev)
    s_all = torch.where((cls != background)[None, :, None], s_all,
                        s_all.new_zeros(()))
    s = s_all.reshape(n, c * k)
    b = cand_all.reshape(n, c * k, 4)
    lab = (labels.to(device=dev, dtype=torch.float32) if labels is not None
           else cls.to(torch.float32))
    lab = lab[:, None].expand(c, k).reshape(-1)
    kk = min(keep_top_k, c * k)
    top_s, idx = topk_stable(s, kk)
    rows = torch.cat([
        torch.where(top_s > 0, lab[idx], f32(-1.0, dev))[..., None],
        top_s[..., None],
        b.gather(1, idx[..., None].expand(n, kk, 4))], dim=-1)
    if kk < keep_top_k:
        pad = torch.zeros((n, keep_top_k - kk, 6), device=dev)
        pad[..., 0] = -1.0
        rows = torch.cat([rows, pad], dim=1)
    return rows


@OPS.kernel("multiclass_nms", "torch", syncs_host=True)
@OPS.kernel("multiclass_nms2", "torch", syncs_host=True)
def multiclass_nms_torch(ctx, op, ins):
    """Output per image: (keep_top_k, 6) rows — see :func:`nms_merge`.

    Marked ``syncs_host``: :func:`jacobi_keep` reads ``torch.equal`` back
    every round, so no CUDA graph can hold this impl.

    Candidates are each class's exact top ``min(nms_top_k, M)``.  The
    reference's ``approx_top_k`` tiers all land here as its
    ``approx_max_k`` tier (``detection.py:373-379``: a ``bucket*`` graph on
    this impl takes the approx tier), and ``approx_max_k`` on the CPU is an
    exact top-k, so every tier is the exact top-k here."""
    boxes = ins["BBoxes"][0].to(torch.float32)  # (N, M, 4)
    scores = ins["Scores"][0].to(torch.float32)  # (N, M, C)
    a = nms_attrs(op.attrs)
    n, m, c = scores.shape
    k = min(a["nms_top_k"], m)
    top_s, cand = exact_candidates(boxes, scores, k)
    kept = nms_single_class(cand.reshape(n * c, k, 4), top_s.reshape(n * c, k),
                            a["iou_t"], a["score_t"])
    out = nms_merge(kept.reshape(n, c, k), cand, background=a["background"],
                    keep_top_k=a["keep_top_k"])
    return {"Out": [out]}


# ---------------------------------------------------------------------------
# anchor_generator / roi_align / generate_proposals (Faster R-CNN's RPN)
# ---------------------------------------------------------------------------

@OPS.shape_fn("anchor_generator")
def anchor_generator_shape(attrs, in_shapes):
    h, w = in_shapes[0][1], in_shapes[0][2]
    n = len(attrs["anchor_sizes"]) * len(attrs["aspect_ratios"])
    return [(h, w, n, 4), (h, w, n, 4)]


def anchors(attrs, fh: int, fw: int):
    """(fh, fw, n, 4) anchors and variances, numpy float32: for each ratio
    r and size s, w = sqrt(s² / r), h = w·r (in double, then float32),
    centred at ``(i + offset) · stride``."""
    f = np.float32
    whs = []
    for r in (float(v) for v in attrs["aspect_ratios"]):
        for s in (float(v) for v in attrs["anchor_sizes"]):
            w_ = math.sqrt(s * s / r)
            whs.append((w_, w_ * r))
    stride = attrs.get("stride", [16.0, 16.0])
    offset = f(attrs.get("offset", 0.5))
    cx = (np.arange(fw, dtype=f) + offset) * f(stride[0])
    cy = (np.arange(fh, dtype=f) + offset) * f(stride[1])
    cxg, cyg = np.meshgrid(cx, cy)
    wh = np.asarray(whs, f)
    bw, bh = wh[None, None, :, 0] / f(2), wh[None, None, :, 1] / f(2)
    cxg, cyg = cxg[:, :, None], cyg[:, :, None]
    out = np.stack([cxg - bw, cyg - bh, cxg + bw, cyg + bh], axis=-1).astype(f)
    var = np.asarray(attrs.get("variances", [0.1, 0.1, 0.2, 0.2]), f)
    return out, np.ascontiguousarray(np.broadcast_to(var, out.shape))


@OPS.kernel("anchor_generator", "torch")
def anchor_generator_torch(ctx, op, ins):
    fh, fw = ins["Input"][0].shape[1:3]
    a, v = ctx.const(op, "anchors", lambda: tuple(
        ctx.tensor(t) for t in anchors(op.attrs, fh, fw)))
    return {"Anchors": [a], "Variances": [v]}


@OPS.shape_fn("roi_align")
def roi_align_shape(attrs, in_shapes):
    return [(in_shapes[1][0], int(attrs["pooled_height"]), int(attrs["pooled_width"]),
             in_shapes[0][3])]


# samples x channels a chunk of RoIs gathers at once (4 corners of these)
_ROI_CHUNK_ELEMS = 1 << 25


@OPS.kernel("roi_align", "torch")
def roi_align_torch(ctx, op, ins):
    """RoIAlign (NHWC, one image): each bin the mean of ``sampling_ratio``²
    bilinear samples (0 counts as 2), each RoI at least 1×1 after
    ``spatial_scale``; the reference's arithmetic, RoIs in chunks."""
    x, rois = ins["X"][0], ins["ROIs"][0]
    if x.shape[0] != 1:
        raise ValueError(
            f"roi_align: X holds {x.shape[0]} images; only one image is supported "
            f"(the RoIs carry no image index here), so run it once per image")
    a = op.attrs
    ph, pw = int(a["pooled_height"]), int(a["pooled_width"])
    ratio = int(a.get("sampling_ratio", 2) or 2)
    img = x[0]
    h, w, c = img.shape
    dev = x.device
    scale, rt = f32(float(a.get("spatial_scale", 1.0)), dev), f32(ratio, dev)
    one = f32(1.0, dev)
    iy = torch.arange(ph * ratio, device=dev, dtype=torch.float32) + 0.5
    ix = torch.arange(pw * ratio, device=dev, dtype=torch.float32) + 0.5
    out = x.new_empty((rois.shape[0], ph, pw, c))
    step = max(1, _ROI_CHUNK_ELEMS // (ph * pw * ratio * ratio * c))
    for r0 in range(0, rois.shape[0], step):
        r = rois[r0:r0 + step].to(torch.float32) * scale
        x1, y1, x2, y2 = r.unbind(-1)
        bin_h = torch.maximum(y2 - y1, one) / f32(ph, dev)
        bin_w = torch.maximum(x2 - x1, one) / f32(pw, dev)
        gy = y1[:, None] + iy * bin_h[:, None] / rt  # (R, ph·ratio)
        gx = x1[:, None] + ix * bin_w[:, None] / rt
        y0 = torch.floor(gy).to(torch.int64).clamp(0, h - 1)
        x0 = torch.floor(gx).to(torch.int64).clamp(0, w - 1)
        y1i, x1i = (y0 + 1).clamp(0, h - 1), (x0 + 1).clamp(0, w - 1)
        wy = torch.clamp(gy - y0, 0.0, 1.0)[:, :, None, None]
        wx = torch.clamp(gx - x0, 0.0, 1.0)[:, None, :, None]

        def at(yi, xi):
            return img[yi[:, :, None], xi[:, None, :]]  # (R, Sy, Sx, C)

        v = (at(y0, x0) * (1 - wy) * (1 - wx) + at(y0, x1i) * (1 - wy) * wx
             + at(y1i, x0) * wy * (1 - wx) + at(y1i, x1i) * wy * wx)
        out[r0:r0 + step] = v.reshape(-1, ph, ratio, pw, ratio, c).mean(dim=(2, 4))
    return {"Out": [out]}


@OPS.shape_fn("generate_proposals")
def generate_proposals_shape(attrs, in_shapes):
    post = int(attrs.get("post_nms_topN", 1000))
    return [(in_shapes[0][0], post, 4), (in_shapes[0][0], post)]


def proposal_candidates(ins, attrs):
    """The candidates of ``generate_proposals`` before its NMS, batched over
    the images: the top ``pre_nms_topN`` anchors by objectness, their boxes
    decoded and clipped to the image, those under ``min_size`` scored 0,
    then the top ``min(post_nms_topN, pre_nms_topN)`` of those
    (``detection.py:640-672`` there).  Returns (N, k2, 4) boxes and (N, k2)
    scores, score-descending in ``jax.lax.top_k``'s order."""
    scores, deltas = ins["Scores"][0], ins["BboxDeltas"][0]
    im_shape = ins["ImShape"][0].to(torch.float32)
    anc = ins["Anchors"][0].reshape(-1, 4)
    variances = ins.get("Variances", [None])[0]
    pre_n, post_n = int(attrs.get("pre_nms_topN", 6000)), int(attrs.get("post_nms_topN", 1000))
    min_size = float(attrs.get("min_size", 0.0))
    n, total = scores.shape[0], anc.shape[0]
    dev = scores.device
    var = variances.reshape(-1, 4) if variances is not None else anc.new_ones((total, 4))
    aw = anc[:, 2] - anc[:, 0] + 1.0
    ah = anc[:, 3] - anc[:, 1] + 1.0
    acx, acy = anc[:, 0] + aw * 0.5, anc[:, 1] + ah * 0.5
    k = min(pre_n, total)
    top_s, idx = topk_stable(scores.reshape(n, -1), k)  # (N, k)
    d = deltas.reshape(n, -1, 4).gather(1, idx[..., None].expand(n, k, 4))
    v = var[idx]
    cx = v[..., 0] * d[..., 0] * aw[idx] + acx[idx]
    cy = v[..., 1] * d[..., 1] * ah[idx] + acy[idx]
    clip = f32(4.135, dev)  # log(1000 / 16), as the reference
    bw = torch.exp(torch.minimum(v[..., 2] * d[..., 2], clip)) * aw[idx]
    bh = torch.exp(torch.minimum(v[..., 3] * d[..., 3], clip)) * ah[idx]
    zero = f32(0.0, dev)
    hi_h, hi_w = (im_shape[:, 0] - 1.0)[:, None], (im_shape[:, 1] - 1.0)[:, None]
    x1 = torch.minimum(torch.maximum(cx - bw * 0.5, zero), hi_w)
    y1 = torch.minimum(torch.maximum(cy - bh * 0.5, zero), hi_h)
    x2 = torch.minimum(torch.maximum(cx + bw * 0.5, zero), hi_w)
    y2 = torch.minimum(torch.maximum(cy + bh * 0.5, zero), hi_h)
    boxes = torch.stack([x1, y1, x2, y2], dim=-1)
    ok = ((x2 - x1 + 1.0) >= min_size) & ((y2 - y1 + 1.0) >= min_size)
    top_s = torch.where(ok, top_s, zero)
    k2 = min(post_n, k)
    s2, idx2 = topk_stable(top_s, k2)
    return boxes.gather(1, idx2[..., None].expand(n, k2, 4)), s2


def proposals_out(kept: torch.Tensor, cand: torch.Tensor, attrs) -> dict:
    """``generate_proposals``' outputs from the kept scores of its
    candidates: the kept ones to the front in score order, padded with
    zeros to ``post_nms_topN`` rows."""
    n, k2 = kept.shape
    post_n = int(attrs.get("post_nms_topN", 1000))
    kept, order = topk_stable(kept, k2)  # the kept ones to the front
    cand = cand.gather(1, order[..., None].expand(n, k2, 4))
    if k2 < post_n:
        kept = torch.cat([kept, kept.new_zeros((n, post_n - k2))], dim=1)
        cand = torch.cat([cand, cand.new_zeros((n, post_n - k2, 4))], dim=1)
    return {"RpnRois": [cand], "RpnRoiProbs": [kept]}


@OPS.kernel("generate_proposals", "torch", syncs_host=True)
def generate_proposals_torch(ctx, op, ins):
    """RPN proposals of each image, batched: (N, post_nms_topN, 4) boxes
    [x1, y1, x2, y2] and their scores, the kept ones first in score order,
    empty slots zero.  Marked ``syncs_host``: :func:`nms_single_class`'s
    fixed point reads back every round."""
    cand, s2 = proposal_candidates(ins, op.attrs)
    kept = nms_single_class(cand, s2, float(op.attrs.get("nms_thresh", 0.7)), 0.0)
    return proposals_out(kept, cand, op.attrs)
