"""Greedy NMS cores: the kept scores of G (image, class) instances.

Port of ``paddle_lite_tpu/ops/kernels/nms.py`` (``nms_keep_scores``
``:101``; Pallas kernel ``_nms_kernel`` ``:39``).  On a CUDA tensor
:func:`nms_keep_scores` launches the hand-written kernel ``csrc/nms.cu``
(one block per instance: a bitonic sort into precedence order, the
suppression relation as a shared-memory bitmask over ranks, a greedy
sweep by one warp; its header says what bounds it on an H100).  On a CPU tensor it runs :func:`nms_keep_scores_plain`,
the TPU kernel's Jacobi fixed point in plain PyTorch.  There is no
fallback from one to the other.

The function, kept verbatim from the TPU kernel: candidate j beats i iff
``s_j > s_i``, or ``s_j == s_i`` and ``j < i`` (candidates may come in any
order); j suppresses i iff j beats i and ``inter > iou_t·union`` with
``union = (area_j + area_i) − inter``, all in fp32 and each operation
rounded on its own; ``valid = s > score_t``; ``keep[i] = valid[i]`` and no
kept j suppresses i; the result is ``s·keep``.  Thresholds enter as fp32,
as JAX applies a Python float to an fp32 array.  Boxes must be finite.
"""

from __future__ import annotations

import numpy as np
import torch

from ..common import f32
from ..detection import chunks, jacobi_keep
from . import _build

# launches of the CUDA kernel, counted by the wrapper (CPU calls not counted)
launches = 0


def nms_keep_scores_plain(cand_boxes: torch.Tensor, cand_scores: torch.Tensor,
                          *, iou_t: float, score_t: float) -> torch.Tensor:
    """Plain PyTorch version: the (k, k) suppression matrix of each
    instance and the Jacobi rounds ``keep ← valid ∧ ¬any(sup ∧ keep)`` until
    ``keep`` stops changing (at most k rounds), as ``_nms_kernel`` runs
    them."""
    g, k, _ = cand_boxes.shape
    dev = cand_boxes.device
    b = cand_boxes.to(torch.float32)
    s = cand_scores.to(torch.float32)
    zero = b.new_zeros(())
    area = (torch.maximum(b[..., 2] - b[..., 0], zero)
            * torch.maximum(b[..., 3] - b[..., 1], zero))
    t_iou = f32(iou_t, dev)
    j_lt_i = (torch.arange(k, device=dev)[:, None]
              < torch.arange(k, device=dev)[None, :])
    valid = s > f32(score_t, dev)
    keep = torch.empty_like(valid)
    for sl in chunks(g, k):
        # j (the suppressor) along rows, i along columns
        bc, br = b[sl, :, None, :], b[sl, None, :, :]
        ix = torch.maximum(torch.minimum(bc[..., 2], br[..., 2])
                           - torch.maximum(bc[..., 0], br[..., 0]), zero)
        iy = torch.maximum(torch.minimum(bc[..., 3], br[..., 3])
                           - torch.maximum(bc[..., 1], br[..., 1]), zero)
        inter = ix * iy
        union = (area[sl, :, None] + area[sl, None, :]) - inter
        sc, sr = s[sl, :, None], s[sl, None, :]
        beats = (sc > sr) | ((sc == sr) & j_lt_i)
        keep[sl] = jacobi_keep(beats & (inter > t_iou * union), valid[sl])
    return s * keep.to(torch.float32)


def _check(t: torch.Tensor, name: str, shape, device) -> None:
    if t.dtype != torch.float32 or tuple(t.shape) != tuple(shape) \
            or t.device != device or not t.is_contiguous():
        raise ValueError(
            f"nms_keep_scores: {name} must be a contiguous float32 tensor of "
            f"shape {tuple(shape)} on {device}; got {t.dtype} "
            f"{tuple(t.shape)} on {t.device} (contiguous={t.is_contiguous()})")


def nms_keep_scores(cand_boxes: torch.Tensor, cand_scores: torch.Tensor, *,
                    iou_t: float, score_t: float) -> torch.Tensor:
    """(G, k, 4) fp32 candidate boxes in any order and (G, k) fp32 scores
    → (G, k) fp32 scores with suppressed and invalid entries zeroed."""
    if cand_boxes.device.type == "cpu":
        return nms_keep_scores_plain(cand_boxes, cand_scores, iou_t=iou_t,
                                     score_t=score_t)
    global launches
    dev = cand_boxes.device
    _build.require_current_device(dev, "nms_keep_scores")
    if cand_boxes.ndim != 3 or cand_scores.ndim != 2:
        raise ValueError("nms_keep_scores: boxes must be (G, k, 4) and "
                         "scores (G, k)")
    g, k = cand_scores.shape
    _check(cand_boxes, "cand_boxes", (g, k, 4), dev)
    _check(cand_scores, "cand_scores", (g, k), dev)
    out = torch.empty((g, k), device=dev, dtype=torch.float32)
    if g * k == 0:
        return out
    lib = _build.load("nms")
    limit = torch.cuda.get_device_properties(dev).shared_memory_per_block_optin
    if lib.plt_nms_smem_bytes(k) + 64 > limit:
        raise ValueError(f"nms_keep_scores: k={k} candidates need "
                         f"{lib.plt_nms_smem_bytes(k)} B of shared memory, "
                         f"over the card's {limit} B a block")
    rc = lib.plt_nms_keep(
        cand_boxes.data_ptr(), cand_scores.data_ptr(), out.data_ptr(), g, k,
        float(np.float32(iou_t)), float(np.float32(score_t)),
        torch.cuda.current_stream(dev).cuda_stream)
    _build.check(rc, "nms")
    launches += 1
    return out
