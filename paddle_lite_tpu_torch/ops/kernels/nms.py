"""Greedy NMS cores: the kept scores of G (image, class) instances.

Port of ``paddle_lite_tpu/ops/kernels/nms.py`` (``nms_keep_scores``
``:101``; Pallas kernel ``_nms_kernel`` ``:39``).  On a CUDA tensor
:func:`nms_keep_scores` launches the hand-written kernel ``csrc/nms.cu``
with the carve-up :func:`plan` gives (one block per instance: a bitonic
sort into precedence order in registers and shuffles, then word by word of
32 ranks the kept ranks' rows tested against the word's columns and the
word's ranks settled against its diagonal tile; its header says what
bounds it on an H100).  On a CPU
tensor it runs :func:`nms_keep_scores_plain`, the TPU kernel's Jacobi
fixed point in plain PyTorch.  There is no fallback from one to the other.

The function, kept verbatim from the TPU kernel: candidate j beats i iff
``s_j > s_i``, or ``s_j == s_i`` and ``j < i`` (candidates may come in any
order); j suppresses i iff j beats i and ``inter > iou_t·union`` with
``union = (area_j + area_i) − inter``, all in fp32 and each operation
rounded on its own; ``valid = s > score_t``; ``keep[i] = valid[i]`` and no
kept j suppresses i; the result is ``s·keep``.  Thresholds enter as fp32,
as JAX applies a Python float to an fp32 array.  Boxes must be finite.

``iou_form="div"`` tests ``inter / max(union, 1e-10) > iou_t`` instead
(an IEEE division), the test of the reference's ``_nms_single_class``
(``paddle_lite_tpu/ops/detection.py:262-271``), which
``generate_proposals`` runs through
:func:`~..detection.nms_single_class`; the two forms round differently near
the threshold.  Over score-sorted candidates (a ``topk_stable`` output)
``beats(j, i)`` is ``j < i`` for every valid pair, so the ``"div"`` form
computes ``nms_single_class``'s kept scores, up to the sign of a zero
(``s·0`` is −0.0 for a negative score, where that function gives +0.0).
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional

import numpy as np
import torch

from ..common import f32
from ..detection import chunks, jacobi_keep
from . import _build

# launches of the CUDA kernel, counted by the wrapper (CPU calls not counted)
launches = 0


IOU_FORMS = ("mul", "div")


def _iou_form(iou_form: str) -> bool:
    """True for the division form; raises for a form not in IOU_FORMS."""
    if iou_form not in IOU_FORMS:
        raise ValueError(f"nms_keep_scores: iou_form must be one of {IOU_FORMS}, "
                         f"got {iou_form!r}")
    return iou_form == "div"


def nms_keep_scores_plain(cand_boxes: torch.Tensor, cand_scores: torch.Tensor,
                          *, iou_t: float, score_t: float,
                          iou_form: str = "mul") -> torch.Tensor:
    """Plain PyTorch version: the (k, k) suppression matrix of each
    instance and the Jacobi rounds ``keep ← valid ∧ ¬any(sup ∧ keep)`` until
    ``keep`` stops changing (at most k rounds), as ``_nms_kernel`` runs
    them; ``iou_form="div"`` with ``nms_single_class``'s IoU test."""
    div = _iou_form(iou_form)
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
        over = (inter / torch.maximum(union, f32(1e-10, dev)) > t_iou if div
                else inter > t_iou * union)
        keep[sl] = jacobi_keep(beats & over, valid[sl])
    return s * keep.to(torch.float32)


def _check(t: torch.Tensor, name: str, shape, device) -> None:
    if t.dtype != torch.float32 or tuple(t.shape) != tuple(shape) \
            or t.device != device or not t.is_contiguous():
        raise ValueError(
            f"nms_keep_scores: {name} must be a contiguous float32 tensor of "
            f"shape {tuple(shape)} on {device}; got {t.dtype} "
            f"{tuple(t.shape)} on {t.device} (contiguous={t.is_contiguous()})")


# ---- the kernel's carve-up (csrc/nms.cu takes these numbers as given) ----

THREADS = 128    # a block: four warps
WARPS = THREADS // 32
MAX_SORT = 2048  # keys the sort holds (16 a thread)


class Layout(NamedTuple):
    """The kernel's thread layout and what the card holds of it, as the
    built library reports them (``plt_nms_layout``): threads a block, the
    most blocks an SM holds by registers and threads, the card's SMs, the
    shared bytes an SM has, the bytes the runtime keeps for each block, and
    the most one block may take."""
    threads: int
    blocks_per_sm: int
    sms: int
    smem_per_sm: int
    smem_reserved: int
    smem_per_block: int


def layout(device: Optional[int] = None) -> Layout:
    """:class:`Layout` of the kernel on CUDA device `device` (the current
    one by default)."""
    return _layout(torch.cuda.current_device() if device is None else device)


@functools.lru_cache(maxsize=None)
def _layout(device: int) -> Layout:
    import ctypes

    with torch.cuda.device(device):
        lib = _build.load("nms")
        vals = [ctypes.c_int() for _ in Layout._fields]
        _build.check(lib.plt_nms_layout(*[ctypes.byref(v) for v in vals]), "nms layout")
    return Layout(*(v.value for v in vals))


class Plan(NamedTuple):
    """One block's carve-up for k candidates: ``sort_n`` keys sorted
    (``per_thread`` in each thread's registers), ``words`` word columns of
    32 ranks, the bytes of each shared region (boxes and areas by rank,
    rank of each slot, kept word of each column, the counts: valid
    candidates of each warp, the ranks kept so far and the removed bits of
    each column; then the sort's keys and after them the diagonal tiles and
    the kept ranks in one region), the block's shared bytes, and the blocks
    an SM holds."""
    threads: int
    sort_n: int
    per_thread: int
    words: int
    box_bytes: int
    area_bytes: int
    rank_bytes: int
    kept_bytes: int
    count_bytes: int
    region_bytes: int
    smem_bytes: int
    blocks_per_sm: int


def _up16(n: int) -> int:
    return -(-n // 16) * 16


def modeled_pair_tests(scores: torch.Tensor, out: torch.Tensor, score_t: float) -> int:
    """Pair tests the kernel's schedule makes on (G, k) `scores` whose
    result is `out`, modeled from its loops (the kernel counts nothing):
    for each instance, 32x32 for each diagonal tile of its
    ceil(nv / 32) word columns, and for each word column the ranks kept
    before it, in warps of 32, against its 32 columns (a kept candidate is
    a valid one with a nonzero result, which holds for score_t >= 0).  At
    SSD's data (nv = 528, 69 % kept) about 130,000 an instance, against
    nv (nv - 1) / 2 = 139,128 pairs."""
    s = scores.detach().double().cpu()
    kept = out.detach().cpu() != 0
    valid = s > float(np.float32(score_t))
    total = 0
    for g in range(s.shape[0]):
        idx = torch.nonzero(valid[g]).flatten()
        order = idx[torch.sort(-s[g, idx], stable=True).indices]  # rank order
        before = torch.cumsum(kept[g, order].long(), 0)
        words = -(-len(order) // 32)
        total += 1024 * (words + sum(-(-int(before[32 * u - 1]) // 32)
                                     for u in range(1, words)))
    return total


@functools.lru_cache(maxsize=None)
def plan(k: int, lay: Layout) -> Plan:
    """The carve-up of one block for k candidates on a card with layout
    `lay`: pure Python, so the CPU tests check it; the wrapper holds it to
    the kernel's own (``plt_nms_smem_bytes``) and raises if they differ.
    Raises ValueError for a k past the sort's keys or whose block does
    not fit the card's shared memory."""
    if k < 1:
        raise ValueError(f"nms: k must be >= 1, got {k}")
    sort_n = THREADS
    while sort_n < k:
        sort_n *= 2
    if sort_n > MAX_SORT:
        raise ValueError(f"nms_keep_scores: k={k} candidates need {sort_n} sort keys, past "
                         f"the {MAX_SORT} the kernel's sort holds in registers "
                         f"({MAX_SORT // THREADS} a thread)")
    words = -(-k // 32)
    rows = 32 * words
    box, area, rank = 16 * rows, 4 * rows, 4 * rows
    kept, counts = _up16(4 * words), _up16(4 * (WARPS + 1 + words))
    region = max(256 * words, 8 * sort_n)
    smem = box + area + rank + kept + counts + region
    if smem > lay.smem_per_block:
        raise ValueError(f"nms_keep_scores: k={k} candidates need {smem} B of shared "
                         f"memory, over the card's {lay.smem_per_block} B a block")
    bps = min(lay.blocks_per_sm, lay.smem_per_sm // (smem + lay.smem_reserved))
    return Plan(THREADS, sort_n, sort_n // THREADS, words, box, area, rank, kept, counts,
                region, smem, bps)


def waves(g: int, p: Plan, lay: Layout) -> float:
    """Rounds of G blocks over the card's resident blocks (1.0: one wave,
    every SM full)."""
    return g / (lay.sms * p.blocks_per_sm)


@functools.lru_cache(maxsize=None)
def _plan_on(device: int, k: int) -> Plan:
    p = plan(k, layout(device))
    with torch.cuda.device(device):
        own = _build.load("nms").plt_nms_smem_bytes(k)
    if own != p.smem_bytes:
        raise ValueError(f"nms_keep_scores: the plan's {p.smem_bytes} shared bytes at "
                         f"k={k} differ from the kernel's {own}")
    return p


def nms_keep_scores(cand_boxes: torch.Tensor, cand_scores: torch.Tensor, *,
                    iou_t: float, score_t: float, iou_form: str = "mul") -> torch.Tensor:
    """(G, k, 4) fp32 candidate boxes in any order and (G, k) fp32 scores
    → (G, k) fp32 scores with suppressed and invalid entries zeroed;
    `iou_form` the pair test's form (the module's docstring)."""
    div = _iou_form(iou_form)
    if cand_boxes.device.type == "cpu":
        return nms_keep_scores_plain(cand_boxes, cand_scores, iou_t=iou_t,
                                     score_t=score_t, iou_form=iou_form)
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
    _plan_on(dev.index, k)
    if cand_boxes.data_ptr() % 16:
        raise ValueError("nms_keep_scores: cand_boxes' data is not 16-byte aligned, "
                         "as the kernel's box loads need")
    lib = _build.load("nms")
    rc = lib.plt_nms_keep(
        cand_boxes.data_ptr(), cand_scores.data_ptr(), out.data_ptr(), g, k,
        float(np.float32(iou_t)), float(np.float32(score_t)), int(div),
        torch.cuda.current_stream(dev).cuda_stream)
    _build.check(rc, "nms")
    launches += 1
    return out
