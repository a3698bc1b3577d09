"""Op implementations registered under the ``"cuda"`` kernel tag.

Port of ``paddle_lite_tpu/ops/kernels/ops_pallas.py``: thin wrappers that
read quant metadata from the graph and call the hand-written kernels; and
of ``multiclass_nms_pallas`` (``ops/detection.py:399-513`` there), whose
candidate selection and cross-class merge are plain torch around the NMS
kernel.  One
change: the reference's impls fall back to the XLA impl when dtypes or
shapes do not fit (``ops_pallas.py:38-41``, ``:58-61``, ``:94-97``,
``:128-131``).  Here the kernel-pick pass (``ops/kernels/select.py``) has
already checked eligibility, so a mismatch raises instead of silently
running another implementation.

Per-op constants — the folded s_x·s_w scales and the GEMM weights repacked
to (N, K) — are made once per op on its first run (``ctx.const``).

Under bf16 islands (``graph.meta["island_dtype"]``) the int8 operands and
outputs are as without them; a bias staged as bf16 is upcast to fp32 here,
keeping its bf16-rounded values, as the reference upcasts it
(``ops/kernels/depthwise.py:112`` there), and an fp32 output is rounded to
bf16 by the executor.  The wrappers themselves take only int8 and fp32
tensors and raise on a bf16 one.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch
import torch.nn.functional as F

from ...core.registry import OPS
from ..common import conv_out_size, normalize_2d, normalize_paddings, upcast
from ..detection import exact_candidates, nms_attrs, nms_merge
from ..nn import eff_scale
from . import depthwise
from .int8_matmul import int8_matmul
from .nms import nms_keep_scores


def _require(ok: bool, op, why: str) -> None:
    if not ok:
        raise ValueError(f"{op.op_type} (kernel='cuda'): {why}")


def _int8(op, *ts: torch.Tensor) -> None:
    _require(all(t.dtype == torch.int8 for t in ts), op,
             f"needs int8 operands, got {[t.dtype for t in ts]}")


def _packed(ctx, op, w2: torch.Tensor):
    """(K, N) weight repacked to (N, K) once; the CPU path needs none."""
    if w2.device.type == "cpu":
        return None
    return ctx.const(op, "w_nk", lambda: w2.t().contiguous())


def _bias(bias):
    """The kernels' fp32 bias: a bf16-staged one upcast, values kept."""
    return None if bias is None else upcast(bias)


def _gemm(ctx, op, x2, w2, x_name, w_name, bias):
    _int8(op, x2, w2)
    return int8_matmul(
        x2.contiguous(), w2, eff_scale(ctx, op, x_name, w_name), _bias(bias),
        act=op.attrs.get("fuse_act"), act_attrs=op.attrs.get("act_attrs"),
        out_scale=op.attrs.get("out_scale"), w_nk=_packed(ctx, op, w2))


@OPS.kernel("fc", "cuda")
def fc_cuda(ctx, op, ins):
    x, w = ins["Input"][0], ins["W"][0]
    bias = ins.get("Bias", [None])[0]
    ncd = int(op.attrs.get("in_num_col_dims", x.ndim - 1))
    lead = tuple(x.shape[:ncd])
    x2 = x.reshape((-1, int(np.prod(x.shape[ncd:]))))
    y = _gemm(ctx, op, x2, w, op.input("Input"), op.input("W"), bias)
    return {"Out": [y.reshape(lead + (w.shape[1],))]}


@OPS.kernel("mul", "cuda")
def mul_cuda(ctx, op, ins):
    x, w = ins["X"][0], ins["Y"][0]
    xd = int(op.attrs.get("x_num_col_dims", 1))
    yd = int(op.attrs.get("y_num_col_dims", 1))
    lead, tail = tuple(x.shape[:xd]), tuple(w.shape[yd:])
    x2 = x.reshape((-1, int(np.prod(x.shape[xd:]))))
    w2 = w.reshape((int(np.prod(w.shape[:yd])), -1))
    y = _gemm(ctx, op, x2, w2, op.input("X"), op.input("Y"), None)
    return {"Out": [y.reshape(lead + tail)]}


def _out_hw(x: torch.Tensor, kh: int, kw: int, strides, paddings):
    """(OH, OW) of a dilation-1 conv of the NHWC `x`."""
    (sh, sw), (ph, pw) = normalize_2d(strides), normalize_paddings(paddings)
    return (conv_out_size(x.shape[1], kh, sh, ph, 1),
            conv_out_size(x.shape[2], kw, sw, pw, 1))


def im2col_nhwc(x: torch.Tensor, kh: int, kw: int, strides, paddings) -> torch.Tensor:
    """(N, H, W, C) int8 → its (N·OH·OW, kh·kw·C) im2col rows, each row in
    (i, j, c) order: the row order of an HWIO filter reshaped to
    (kh·kw·C, OC).  The input is zero-padded (zero is int8's zero point:
    the port's quantization is symmetric) and the kh·kw strided tap slices
    are concatenated on the last axis.  A 1x1 conv without padding has one
    tap: at stride 1 its rows are a view of `x`, at another stride one
    strided copy."""
    n, _, _, c = x.shape
    (sh, sw), ((pt, pb), (pl, pr)) = normalize_2d(strides), normalize_paddings(paddings)
    oh, ow = _out_hw(x, kh, kw, strides, paddings)
    xp = x if (pt, pb, pl, pr) == (0, 0, 0, 0) else F.pad(x, (0, 0, pl, pr, pt, pb))
    taps = [xp[:, i:i + sh * (oh - 1) + 1:sh, j:j + sw * (ow - 1) + 1:sw]
            for i in range(kh) for j in range(kw)]
    cols = taps[0] if len(taps) == 1 else torch.cat(taps, dim=-1)
    return cols.reshape(n * oh * ow, kh * kw * c)


@OPS.kernel("conv2d", "cuda")
def conv2d_cuda(ctx, op, ins):
    """Group-1 conv without residual as the int8 GEMM over its im2col rows
    (the reference's ``conv_gemmlike`` path, ``ops_pallas.py:79-80``):
    int32 accumulation, exact for any K."""
    x, w = ins["Input"][0], ins["Filter"][0]
    bias = ins.get("Bias", [None])[0]
    kh, kw, c, oc = w.shape
    _require(
        int(op.attrs.get("groups", 1)) == 1
        and normalize_2d(op.attrs.get("dilations", (1, 1))) == (1, 1)
        and "ResidualData" not in ins, op,
        "only group-1, dilation-1 convs without residual run as the GEMM")
    _int8(op, x, w)
    geom = (kh, kw, op.attrs.get("strides", (1, 1)), op.attrs.get("paddings", (0, 0)))
    y = _gemm(ctx, op, im2col_nhwc(x, *geom), w.reshape((kh * kw * c, oc)),
              op.input("Input"), op.input("Filter"), bias)
    return {"Output": [y.reshape((x.shape[0], *_out_hw(x, *geom), oc))]}


@OPS.kernel("depthwise_conv2d", "cuda")
def depthwise_cuda(ctx, op, ins):
    """int8 depthwise conv (k ∈ {3, 5}, stride ∈ {1, 2}, SAME padding)."""
    x, w = ins["Input"][0], ins["Filter"][0]
    bias = ins.get("Bias", [None])[0]
    _int8(op, x, w)
    _require("ResidualData" not in ins
             and depthwise.supported_general(op.attrs, x.shape, w.shape), op,
             "outside the kernel's k ∈ {3,5} / stride ∈ {1,2} / SAME domain")
    y = depthwise.dw_conv_int8(
        x, w, eff_scale(ctx, op, op.input("Input"), op.input("Filter")), _bias(bias),
        stride=normalize_2d(op.attrs.get("strides", (1, 1)))[0],
        act=op.attrs.get("fuse_act"), act_attrs=op.attrs.get("act_attrs"),
        out_scale=op.attrs.get("out_scale"))
    return {"Output": [y]}


# ---------------------------------------------------------------------------
# multiclass_nms: candidate selection → NMS kernel → cross-class merge
# ---------------------------------------------------------------------------

def bucket_candidates(boxes: torch.Tensor, scores: torch.Tensor, topn: int,
                      loc: int):
    """The ``bucket<N>`` tier: the M priors in ``loc`` buckets of
    ``bs = ceil(M / loc)`` neighbours (the tail padded with −1e30), and the
    top ``topn`` of each bucket by successive first-maxes, each further max
    with the taken entries masked to −inf.  (N, M, 4), (N, M, C) →
    (N, C, topn·loc) scores and (N, C, topn·loc, 4) boxes, in bucket order.

    The reference takes each max's box by a one-hot sum over the bucket;
    ``argmax`` returns the same first maximal index, and while the boxes are
    finite the gather gives the same values as that sum."""
    n, m, c = scores.shape
    bs = -(-m // loc)
    pad = loc * bs - m
    sc_b = F.pad(scores.transpose(1, 2), (0, pad), value=-1e30)
    sc_b = sc_b.reshape(n, c, loc, bs)
    bx_b = F.pad(boxes, (0, 0, 0, pad)).reshape(n, 1, loc, bs, 4)
    bx_b = bx_b.expand(n, c, loc, bs, 4)
    tops, cands = [], []
    for r in range(topn):
        idx = sc_b.argmax(dim=-1, keepdim=True)  # (N, C, loc, 1): first max
        tops.append(sc_b.gather(-1, idx).squeeze(-1))
        cands.append(bx_b.gather(3, idx[..., None].expand(n, c, loc, 1, 4))
                     .squeeze(3))
        if r + 1 < topn:
            sc_b = sc_b.scatter(-1, idx, float("-inf"))
    return torch.cat(tops, dim=-1), torch.cat(cands, dim=2)


def select_candidates(boxes: torch.Tensor, scores: torch.Tensor, attrs: dict):
    """The candidate tier of ``attrs["approx_top_k"]``: (N, M, 4) boxes and
    (N, M, C) scores → (N, C, k) scores and (N, C, k, 4) boxes.  False:
    each class's exact top ``min(nms_top_k, M)``; True: the reference's
    ``approx_max_k`` (an exact top-k on the CPU, where the reference is
    tested), so the same exact top-k here; ``"bucket<N>"`` with
    ``bucket_candidates`` buckets, while M exceeds them:
    :func:`bucket_candidates`."""
    n, m, c = scores.shape
    approx = attrs.get("approx_top_k", False)
    bucket = isinstance(approx, str) and approx.startswith("bucket")
    topn = int(approx[6:] or 1) if bucket else 1
    loc = int(attrs.get("bucket_candidates", 512 // topn))
    if bucket and topn >= 1 and m > loc:
        return bucket_candidates(boxes, scores, topn, loc)
    return exact_candidates(boxes, scores, min(nms_attrs(attrs)["nms_top_k"], m))


def multiclass_nms(boxes: torch.Tensor, scores: torch.Tensor, attrs: dict,
                   keep: Callable = nms_keep_scores) -> torch.Tensor:
    """(N, M, 4) boxes, (N, M, C) scores → (N, keep_top_k, 6) rows, the
    ``multiclass_nms_pallas`` contract: :func:`select_candidates`, the
    kept scores of every (image, class) instance, then the cross-class
    merge.  ``keep`` computes the kept scores: the kernel, or
    :func:`~.nms.nms_keep_scores_plain` to check it."""
    a = nms_attrs(attrs)
    top_s, cand = select_candidates(boxes.to(torch.float32),
                                    scores.to(torch.float32), attrs)
    n, c, k = top_s.shape
    kept = keep(cand.reshape(n * c, k, 4).contiguous(),
                top_s.reshape(n * c, k).contiguous(),
                iou_t=a["iou_t"], score_t=a["score_t"])
    return nms_merge(kept.reshape(n, c, k), cand, background=a["background"],
                     keep_top_k=a["keep_top_k"])


@OPS.kernel("multiclass_nms", "cuda")
@OPS.kernel("multiclass_nms2", "cuda")
def multiclass_nms_cuda(ctx, op, ins):
    return {"Out": [multiclass_nms(ins["BBoxes"][0], ins["Scores"][0],
                                   op.attrs)]}
