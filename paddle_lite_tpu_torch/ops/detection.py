"""Detection ops of the SSD path under the ``torch`` tag: ``prior_box``,
``box_coder`` (decode) and ``multiclass_nms`` / ``multiclass_nms2``.

Port of ``paddle_lite_tpu/ops/detection.py``: ``prior_box`` (``:35-104``),
``box_coder`` (``:169-203``), the NMS shape function (``:321-325``),
``_iou_matrix`` / ``_nms_single_class`` (``:262-318``), ``_nms_merge``
(``:328-358``) and ``multiclass_nms_xla`` (``:361-396``).  The kernel form
of ``multiclass_nms`` (the reference's ``"pallas"`` impl) is in
``ops/kernels/ops_cuda.py``.  All of it runs in fp32, outside the int8
regions, as in the reference.

``prior_box`` depends only on shapes, so it is computed once per op (in
numpy float32, the reference's arithmetic) and kept on the device; XLA
constant-folds it there.  Top-k selections follow ``jax.lax.top_k``
exactly (:func:`topk_stable`): descending in IEEE total order, so +0.0
ranks above −0.0, and equal values by lower index.

Not ported yet: ``density_prior_box``, ``yolo_box``, ``anchor_generator``,
``roi_align``, ``generate_proposals`` (ROADMAP queue 1, item 10).
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
