"""The long tail of ``lite/operators/``: the scatter / gather family, index
and slice variants, fill and range constants, extra activations,
``max_pool2d_with_index``, ``matrix_nms``, ``grid_sampler``, the seeded
random ops and the rest of the tensor math.

Port of ``paddle_lite_tpu/ops/longtail.py`` (all 50 names).  None of them
reads a value back to the host, so each runs inside a CUDA graph.  Ops
whose fluid semantics depend on values (``range``, ``linspace``,
``sequence_mask``'s length) take their sizes from attrs, as there.

Where the reference's arithmetic has a bit-exact torch form, the port uses
it:
- ``range`` is ``np.arange`` (``jnp.arange`` with constant bounds is it);
- ``linspace`` from 0 is ``quant/calibrate.hist_edges``, XLA's folded form
  of ``jnp.linspace``; from another start it is that form's arithmetic
  unfused, where XLA on the CPU may contract a product into an FMA (a
  rounding apart, within one ulp of the larger bound);
- ``uniform_random`` / ``gaussian_random`` draw ``jax.random``'s bits:
  threefry2x32 (:func:`threefry2x32`) keyed by ``PRNGKey(seed)`` over the
  flat index as two 32-bit words (JAX 0.9's partitionable threefry), on
  int64 tensors masked to 32 bits.  ``uniform`` maps the bits as
  ``jax.random.uniform`` does (its scale and shift one FMA, as XLA fuses
  them on the CPU); ``normal`` goes through ``erfinv``, whose
  torch form differs from XLA's in the last bits.  Both are constants of
  the graph, made once per op.
- integer ``scatter`` / ``scatter_nd_add`` results are exact; float
  accumulation (``overwrite=False``, ``scatter_nd_add``) goes through
  ``index_put_(accumulate=True)``, atomics on the card, in another order
  than XLA's.  As in JAX, an index in [-n, 0) counts from the end and one
  outside [-n, n) is dropped; ``gather_nd`` clamps it instead, as JAX's
  indexing does, and ``index_select`` fills it (``jnp.take``).

One departure, a fault there: the reference's ``max_pool2d_with_index``
pools patches of the zero-padded input, so a window that touches the
padding competes with 0 and may return an index outside the image.  Here
the padding never wins (it is -inf) and every index lies in the image.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from ..core.registry import OPS
from .common import f32, normalize_2d, normalize_paddings
from .detection import iou_matrix, topk_stable
from .manip import take_rows


def _same(attrs, in_shapes):
    return [in_shapes[0]]


def _reg(name, shape_fn, impl, **kw):
    OPS.register(name, infer_shape=shape_fn, **kw)
    OPS.get(name).impls["torch"] = impl


def _const(ctx, op, make):
    """`make()` (a numpy array) on the op's device, once per op."""
    return ctx.const(op, "value", lambda: ctx.tensor(make()))


# ---- elementwise-unary long tail ---------------------------------------------

def _unary(fn):
    def impl(ctx, op, ins):
        return {"Out": [fn(ins["X"][0], op.attrs)]}
    return impl


def _where0(keep, x):
    return torch.where(keep, x, x.new_zeros(()))


def _clip_by_norm(x, a):
    norm = torch.clamp_min(torch.sqrt(torch.sum(x * x)), f32(1e-12, x.device))
    return x * torch.clamp_max(f32(a.get("max_norm", 1.0), x.device) / norm, 1.0)


_reg("pow", _same, _unary(lambda x, a: torch.pow(x, a.get("factor", 1.0))))
_reg("increment", _same, _unary(lambda x, a: x + a.get("step", 1.0)))
_reg("thresholded_relu", _same,
     _unary(lambda x, a: _where0(x > a.get("threshold", 1.0), x)))
_reg("brelu", _same,
     _unary(lambda x, a: torch.clamp(x, a.get("t_min", 0.0), a.get("t_max", 24.0))))
_reg("hard_shrink", _same,
     _unary(lambda x, a: _where0(torch.abs(x) > a.get("threshold", 0.5), x)))
_reg("softshrink", _same,
     _unary(lambda x, a: torch.sign(x)
            * torch.clamp_min(torch.abs(x) - a.get("lambda", 0.5), 0.0)))
_reg("tanh_shrink", _same, _unary(lambda x, a: x - torch.tanh(x)))
_reg("log_softmax", _same,
     _unary(lambda x, a: torch.log_softmax(x, dim=int(a.get("axis", -1)))))
_reg("fill_any_like", _same,
     _unary(lambda x, a: torch.full_like(x, a.get("value", 0.0))))
_reg("fill_zeros_like", _same, _unary(lambda x, a: torch.zeros_like(x)))
_reg("clip_by_norm", _same, _unary(_clip_by_norm))
_reg("lod_reset", _same, _unary(lambda x, a: x))  # dense tensors: the identity


def _binary(fn):
    def impl(ctx, op, ins):
        return {"Out": [fn(ins["X"][0], ins["Y"][0])]}
    return impl


for _name, _fn in (("bitwise_and", torch.bitwise_and), ("bitwise_or", torch.bitwise_or),
                   ("bitwise_xor", torch.bitwise_xor)):
    _reg(_name, _same, _binary(_fn), input_slots=("X", "Y"))
_reg("bitwise_not", _same, _unary(lambda x, a: torch.bitwise_not(x)))


# ---- constants / ranges --------------------------------------------------------

def _range_shape(attrs, in_shapes):
    start, end, step = (float(attrs["start"]), float(attrs["end"]),
                        float(attrs.get("step", 1.0)))
    return [(max(int(np.ceil((end - start) / step)), 0),)]


_reg("range", _range_shape, lambda ctx, op, ins: {"Out": [_const(ctx, op, lambda: np.arange(
    op.attrs["start"], op.attrs["end"], op.attrs.get("step", 1.0),
    dtype=np.dtype(op.attrs.get("dtype", "float32"))))]})


def linspace_f32(start: float, stop: float, num: int) -> np.ndarray:
    """``jnp.linspace(start, stop, num)`` in float32: ``start·(1 − i·r) +
    i·(stop·r)`` for i < num − 1 (``r`` the float32 reciprocal of num − 1),
    then ``stop``.  From 0 this is :func:`quant.calibrate.hist_edges`, bit
    for bit."""
    from ..quant.calibrate import hist_edges

    f = np.float32
    start, stop = f(start), f(stop)
    if num < 2:
        return np.full((num,), start, f)
    if start == 0 and stop > 1e-10:
        return hist_edges(float(stop), num - 1)
    i = np.arange(num - 1, dtype=f)
    r = f(1) / f(num - 1)
    return np.append(start * (f(1) - i * r) + i * (stop * r), stop).astype(f)


def _linspace_impl(ctx, op, ins):
    a = op.attrs
    dt = np.dtype(a.get("dtype", "float32"))

    def make():
        v = linspace_f32(a["start"], a["stop"], int(a["num"]))
        return (np.floor(v) if dt.kind in "iu" else v).astype(dt)

    return {"Out": [_const(ctx, op, make)]}


_reg("linspace", lambda attrs, in_shapes: [(int(attrs["num"]),)], _linspace_impl)


def _fcbsl_shape(attrs, in_shapes):
    shape = [int(s) for s in attrs["shape"]]
    shape[int(attrs.get("output_dim_idx", 0))] = in_shapes[0][int(attrs.get("input_dim_idx", 0))]
    return [tuple(shape)]


_reg("fill_constant_batch_size_like", _fcbsl_shape,
     lambda ctx, op, ins: {"Out": [_const(ctx, op, lambda: np.full(
         ctx.var_shape(op.output("Out")), op.attrs.get("value", 0.0),
         dtype=np.dtype(op.attrs.get("dtype", "float32"))))]},
     input_slots=("Input",))


def _assign_value(attrs) -> np.ndarray:
    if attrs.get("fp32_values"):
        vals = np.asarray(attrs["fp32_values"], np.float32)
    elif attrs.get("int32_values"):
        vals = np.asarray(attrs["int32_values"], np.int32)
    else:
        vals = np.asarray(attrs.get("int64_values", []), np.int64)
    return vals.reshape([int(s) for s in attrs["shape"]])


_reg("assign_value", lambda attrs, in_shapes: [tuple(int(s) for s in attrs["shape"])],
     lambda ctx, op, ins: {"Out": [_const(ctx, op, lambda: _assign_value(op.attrs))]})


# ---- expand variants ---------------------------------------------------------------

def _expand_v2_shape(attrs, in_shapes):
    x = list(in_shapes[0])
    out = [int(s) for s in attrs["shape"]]
    for i in range(1, len(x) + 1):  # trailing-aligned; -1 keeps the input dim
        if out[-i] == -1:
            out[-i] = x[-i]
    return [tuple(out)]


_reg("expand_v2", _expand_v2_shape,
     lambda ctx, op, ins: {"Out": [ins["X"][0].expand(ctx.var_shape(op.output("Out")))]})
_reg("expand_as_v2", lambda attrs, in_shapes: [in_shapes[1]],
     lambda ctx, op, ins: {"Out": [ins["X"][0].expand(ins["Y"][0].shape)]},
     input_slots=("X", "Y"))


# ---- scatter / gather family ----------------------------------------------------------

def _wrap(idx: torch.Tensor, n: int):
    """(index with [-n, 0) counted from the end, in-range mask)."""
    idx = idx.to(torch.int64)
    return torch.where(idx < 0, idx + n, idx), (idx >= -n) & (idx < n)


def _scatter_rows(x: torch.Tensor, rows: torch.Tensor, ok: torch.Tensor,
                  upd: torch.Tensor, accumulate: bool) -> torch.Tensor:
    """x with upd written (or added) at the first-axis `rows`; a row not
    `ok` lands in a spare row that is cut off (JAX drops it)."""
    n = x.shape[0]
    out = torch.cat([x, x.new_zeros((1,) + tuple(x.shape[1:]))])
    rows = torch.where(ok, rows, n).reshape(-1)
    out.index_put_((rows,), upd.reshape((rows.shape[0],) + tuple(x.shape[1:])).to(x.dtype),
                   accumulate=accumulate)
    return out[:n]


def _scatter_impl(ctx, op, ins):
    x, ids, upd = ins["X"][0], ins["Ids"][0], ins["Updates"][0]
    rows, ok = _wrap(ids.reshape(-1), x.shape[0])
    return {"Out": [_scatter_rows(x, rows, ok, upd,
                                  accumulate=not op.attrs.get("overwrite", True))]}


_reg("scatter", _same, _scatter_impl, input_slots=("X", "Ids", "Updates"))


def _scatter_nd_add_impl(ctx, op, ins):
    """``x.at[idx[..., 0], ..., idx[..., k-1]].add(upd)``: the first k axes
    flattened to one, an update with any index out of range dropped."""
    x, idx, upd = ins["X"][0], ins["Index"][0], ins["Updates"][0]
    k = idx.shape[-1]
    lead = x.shape[:k]
    flat = torch.zeros(idx.shape[:-1], dtype=torch.int64, device=x.device)
    ok = torch.ones(idx.shape[:-1], dtype=torch.bool, device=x.device)
    for j in range(k):
        i, in_range = _wrap(idx[..., j], lead[j])
        flat = flat * lead[j] + i
        ok &= in_range
    xf = x.reshape((math.prod(lead),) + tuple(x.shape[k:]))
    return {"Out": [_scatter_rows(xf, flat.reshape(-1), ok.reshape(-1), upd,
                                  accumulate=True).reshape(x.shape)]}


_reg("scatter_nd_add", _same, _scatter_nd_add_impl, input_slots=("X", "Index", "Updates"))


def _gather_nd_shape(attrs, in_shapes):
    x, idx = in_shapes[0], in_shapes[1]
    return [tuple(idx[:-1]) + tuple(x[idx[-1]:])]


def _gather_nd_impl(ctx, op, ins):
    """``x[idx[..., 0], ..., idx[..., k-1]]``, JAX's indexing: an index in
    [-n, 0) counts from the end, then every index is clamped into range."""
    x, idx = ins["X"][0], ins["Index"][0]
    parts = []
    for j in range(idx.shape[-1]):
        i, _ = _wrap(idx[..., j], x.shape[j])
        parts.append(i.clamp(0, x.shape[j] - 1))
    return {"Out": [x[tuple(parts)]]}


_reg("gather_nd", _gather_nd_shape, _gather_nd_impl, input_slots=("X", "Index"))


def _index_select_shape(attrs, in_shapes):
    x = list(in_shapes[0])
    x[int(attrs.get("dim", 0))] = in_shapes[1][0]
    return [tuple(x)]


def _index_select_impl(ctx, op, ins):
    """``jnp.take(x, index, axis=dim)``: its fill mode, as ``gather``."""
    dim = int(op.attrs.get("dim", 0))
    x = ins["X"][0]
    return {"Out": [take_rows(x.movedim(dim, 0), ins["Index"][0]).movedim(0, dim)]}


_reg("index_select", _index_select_shape, _index_select_impl, input_slots=("X", "Index"))


# ---- slicing / reordering -----------------------------------------------------------------

def _strided_slice_shape(attrs, in_shapes):
    x = list(in_shapes[0])
    for ax, st, en, sd in zip(attrs["axes"], attrs["starts"], attrs["ends"],
                              attrs.get("strides", [1] * len(attrs["axes"]))):
        dim = x[ax]
        st = max(st + dim, 0) if st < 0 else min(st, dim)
        en = max(en + dim, -1) if en < 0 else min(en, dim)
        x[ax] = max(0, (en - st + (sd - (1 if sd > 0 else -1))) // sd)
    return [tuple(x)]


def _strided_slice_impl(ctx, op, ins):
    """Python slicing on each axis; a negative stride (which torch's
    slicing lacks) as an index list."""
    x = ins["X"][0]
    a = op.attrs
    for ax, st, en, sd in zip(a["axes"], a["starts"], a["ends"],
                              a.get("strides", [1] * len(a["axes"]))):
        if sd > 0:
            idx = [slice(None)] * x.ndim
            idx[ax] = slice(st, en, sd)
            x = x[tuple(idx)]
        else:
            keep = list(range(*slice(st, en, sd).indices(x.shape[ax])))
            x = x.index_select(ax, ctx.const(op, f"rows{ax}", lambda keep=keep: ctx.tensor(
                np.asarray(keep, np.int64))))
    return {"Out": [x]}


_reg("strided_slice", _strided_slice_shape, _strided_slice_impl)
_reg("flip", _same, lambda ctx, op, ins: {"Out": [torch.flip(
    ins["X"][0], dims=[int(d) for d in op.attrs["axis"]])]})
_reg("reverse", _same, lambda ctx, op, ins: {"Out": [torch.flip(
    ins["X"][0], dims=[int(d) for d in op.attrs["axis"]])]})
_reg("roll", _same, lambda ctx, op, ins: {"Out": [torch.roll(
    ins["X"][0], [int(s) for s in op.attrs["shifts"]],
    dims=[int(d) for d in op.attrs["axis"]])]})


def _unbind_shape(attrs, in_shapes):
    x = list(in_shapes[0])
    axis = int(attrs.get("axis", 0)) % len(x)
    return [tuple(x[:axis] + x[axis + 1:])] * x[axis]


_reg("unbind", _unbind_shape, lambda ctx, op, ins: {"Out": list(torch.unbind(
    ins["X"][0], dim=int(op.attrs.get("axis", 0)) % ins["X"][0].ndim))})


def _crop_impl(ctx, op, ins):
    """``lax.dynamic_slice``: each start clamped so the window fits."""
    x = ins["X"][0]
    offs = [int(o) for o in op.attrs.get("offsets", [0] * x.ndim)]
    for ax, (o, s) in enumerate(zip(offs, [int(s) for s in op.attrs["shape"]])):
        x = x.narrow(ax, min(max(o, 0), x.shape[ax] - s), s)
    return {"Out": [x]}


for _name in ("crop", "crop_tensor"):
    _reg(_name, lambda attrs, in_shapes: [tuple(int(s) for s in attrs["shape"])], _crop_impl)


# ---- sort / argmin ----------------------------------------------------------------------------

def _argsort_impl(ctx, op, ins):
    """``jnp.argsort`` (of ``-x`` when descending): a stable sort, NaN last,
    -0.0 equal to 0.0, as ``torch.sort(stable=True)`` orders."""
    x = ins["X"][0]
    axis = int(op.attrs.get("axis", -1))
    key = -x if op.attrs.get("descending", False) else x
    idx = torch.sort(key, dim=axis, stable=True).indices
    return {"Out": [torch.gather(x, axis, idx)], "Indices": [idx]}


OPS.register("argsort", infer_shape=lambda attrs, in_shapes: [in_shapes[0], in_shapes[0]],
             output_slots=("Out", "Indices"))
OPS.get("argsort").impls["torch"] = _argsort_impl


def _argmin_shape(attrs, in_shapes):
    x = list(in_shapes[0])
    axis = int(attrs.get("axis", -1)) % len(x)
    if attrs.get("keepdims", False):
        x[axis] = 1
        return [tuple(x)]
    return [tuple(x[:axis] + x[axis + 1:])]


_reg("arg_min", _argmin_shape, lambda ctx, op, ins: {"Out": [torch.argmin(
    ins["X"][0], dim=int(op.attrs.get("axis", -1)),
    keepdim=bool(op.attrs.get("keepdims", False)))]})


# ---- reductions / norms -------------------------------------------------------------------------

_reg("mean", lambda attrs, in_shapes: [(1,)],
     lambda ctx, op, ins: {"Out": [torch.mean(ins["X"][0]).reshape(1)]})
_reg("size", lambda attrs, in_shapes: [(1,)],
     lambda ctx, op, ins: {"Out": [_const(ctx, op, lambda: np.asarray(
         [ins["Input"][0].numel()], np.int64))]},
     input_slots=("Input",))


def _p_norm_impl(ctx, op, ins):
    x = ins["X"][0]
    p = float(op.attrs.get("porder", 2.0))
    s = torch.sum(torch.abs(x) ** p, dim=int(op.attrs.get("axis", -1)),
                  keepdim=bool(op.attrs.get("keepdim", False)))
    return {"Out": [s ** (1.0 / p)]}


_reg("p_norm", lambda attrs, in_shapes: _argmin_shape(
    {"axis": attrs.get("axis", -1), "keepdims": attrs.get("keepdim", False)}, in_shapes),
    _p_norm_impl)


def _cos_sim_impl(ctx, op, ins):
    x, y = ins["X"][0], ins["Y"][0]
    num = torch.sum(x * y, dim=-1, keepdim=True)
    den = (torch.sqrt(torch.sum(x * x, dim=-1, keepdim=True))
           * torch.sqrt(torch.sum(y * y, dim=-1, keepdim=True)))
    return {"Out": [num / torch.clamp_min(den, f32(1e-12, x.device))]}


_reg("cos_sim", lambda attrs, in_shapes: [tuple(in_shapes[0][:-1]) + (1,)], _cos_sim_impl,
     input_slots=("X", "Y"))


# ---- bmm, affine_channel, pixel_unshuffle, pad3d ---------------------------------------------------

_reg("bmm", lambda attrs, in_shapes: [(in_shapes[0][0], in_shapes[0][1], in_shapes[1][2])],
     lambda ctx, op, ins: {"Out": [torch.bmm(ins["X"][0].to(torch.float32),
                                             ins["Y"][0].to(torch.float32))]},
     input_slots=("X", "Y"))
_reg("affine_channel", _same,
     lambda ctx, op, ins: {"Out": [ins["X"][0] * ins["Scale"][0] + ins["Bias"][0]]},
     input_slots=("X", "Scale", "Bias"))


def _pixel_unshuffle_shape(attrs, in_shapes):
    n, h, w, c = in_shapes[0]
    r = int(attrs.get("downscale_factor", 2))
    return [(n, h // r, w // r, c * r * r)]


def _pixel_unshuffle_impl(ctx, op, ins):
    x = ins["X"][0]
    n, h, w, c = x.shape
    r = int(op.attrs.get("downscale_factor", 2))
    y = x.reshape(n, h // r, r, w // r, r, c).permute(0, 1, 3, 2, 4, 5)
    return {"Out": [y.reshape(n, h // r, w // r, r * r * c)]}


_reg("pixel_unshuffle", _pixel_unshuffle_shape, _pixel_unshuffle_impl)


def _pad3d_shape(attrs, in_shapes):
    n, d, h, w, c = in_shapes[0]
    p = attrs["paddings"]  # [front, back, top, bottom, left, right]
    return [(n, d + p[0] + p[1], h + p[2] + p[3], w + p[4] + p[5], c)]


def _pad3d_impl(ctx, op, ins):
    """NDHWC constant padding."""
    f, b, t, bo, l, r = (int(v) for v in op.attrs["paddings"])
    return {"Out": [F.pad(ins["X"][0], (0, 0, l, r, t, bo, f, b),
                          value=float(op.attrs.get("value", 0.0)))]}


_reg("pad3d", _pad3d_shape, _pad3d_impl)


# ---- sequence_mask (dense) ------------------------------------------------------------------------

def _sequence_mask_impl(ctx, op, ins):
    x = ins["X"][0]
    maxlen = int(op.attrs["maxlen"])
    ar = torch.arange(maxlen, device=x.device)
    mask = ar < x.reshape(tuple(x.shape) + (1,))
    return {"Y": [mask.to(getattr(torch, op.attrs.get("out_dtype", "float32")))]}


OPS.register("sequence_mask", output_slots=("Y",),
             infer_shape=lambda attrs, in_shapes: [tuple(in_shapes[0]) + (int(attrs["maxlen"]),)])
OPS.get("sequence_mask").impls["torch"] = _sequence_mask_impl


# ---- max_pool2d_with_index ---------------------------------------------------------------------------

def _max_pool_index_shape(attrs, in_shapes):
    n, h, w, c = in_shapes[0]
    kh, kw = normalize_2d(attrs.get("ksize", (2, 2)))
    sh, sw = normalize_2d(attrs.get("strides", (kh, kw)))
    (ph0, ph1), (pw0, pw1) = normalize_paddings(attrs.get("paddings", (0, 0)))
    oh = (h + ph0 + ph1 - kh) // sh + 1
    ow = (w + pw0 + pw1 - kw) // sw + 1
    return [(n, oh, ow, c), (n, oh, ow, c)]


def _max_pool_index_impl(ctx, op, ins):
    """Max pool (NHWC) and the flat index ``h·W + w`` of each window's
    first greatest element in the unpadded image (fluid's Mask, int32).
    The padding is -inf, so it never wins over an element of the image."""
    x = ins["X"][0]
    n, h, w, c = x.shape
    a = op.attrs
    kh, kw = normalize_2d(a.get("ksize", (2, 2)))
    sh, sw = normalize_2d(a.get("strides", (kh, kw)))
    (pt, pb), (pl, pr) = normalize_paddings(a.get("paddings", (0, 0)))
    xp = F.pad(x.permute(0, 3, 1, 2), (pl, pr, pt, pb), value=float("-inf"))
    win = xp.unfold(2, kh, sh).unfold(3, kw, sw)  # (N, C, OH, OW, kh, kw)
    oh, ow = win.shape[2], win.shape[3]
    out, k = win.reshape(n, c, oh, ow, kh * kw).max(dim=-1)
    dev = x.device
    oy = (torch.arange(oh, device=dev) * sh - pt).reshape(oh, 1)
    ox = (torch.arange(ow, device=dev) * sw - pl).reshape(1, ow)
    flat = (oy + torch.div(k, kw, rounding_mode="floor")) * w + (ox + k % kw)
    return {"Out": [out.permute(0, 2, 3, 1)],
            "Mask": [flat.to(torch.int32).permute(0, 2, 3, 1)]}


OPS.register("max_pool2d_with_index", infer_shape=_max_pool_index_shape,
             output_slots=("Out", "Mask"))
OPS.get("max_pool2d_with_index").impls["torch"] = _max_pool_index_impl


# ---- box_clip / matrix_nms (detection long tail) -------------------------------------------------------

def _box_clip_impl(ctx, op, ins):
    boxes, im_info = ins["Input"][0], ins["ImInfo"][0]
    lead = (-1,) + (1,) * (boxes.ndim - 1)  # im_info rows: (h, w, scale)
    hi_h = im_info[..., 0].reshape(lead) - 1
    hi_w = im_info[..., 1].reshape(lead) - 1
    zero = boxes.new_zeros(())
    x1, y1, x2, y2 = torch.split(boxes, 1, dim=-1)
    return {"Output": [torch.cat([
        torch.minimum(torch.maximum(x1, zero), hi_w), torch.minimum(torch.maximum(y1, zero), hi_h),
        torch.minimum(torch.maximum(x2, zero), hi_w), torch.minimum(torch.maximum(y2, zero), hi_h)],
        dim=-1)]}


OPS.register("box_clip", infer_shape=_same, input_slots=("Input", "ImInfo"),
             output_slots=("Output",))
OPS.get("box_clip").impls["torch"] = _box_clip_impl


def _matrix_nms_shape(attrs, in_shapes):
    n, c, m = in_shapes[1]  # Scores (N, C, M)
    keep = int(attrs.get("keep_top_k", 100))
    return [(n, keep if keep >= 0 else c * m, 6)]


def _matrix_nms_impl(ctx, op, ins):
    """Matrix NMS: each class's boxes sorted by score (stable), each score
    decayed by the min over higher-scored boxes of the IoU transform
    (linear or gaussian), then the top ``keep_top_k`` of all classes as
    rows [class, score, x1, y1, x2, y2], padded with -1.  Batched over
    images and classes."""
    bboxes, scores = ins["BBoxes"][0], ins["Scores"][0]
    a = op.attrs
    score_thr = float(a.get("score_threshold", 0.05))
    post_thr = float(a.get("post_threshold", 0.0))
    keep = int(a.get("keep_top_k", 100))
    sigma = f32(a.get("gaussian_sigma", 2.0), scores.device)
    n, c, m = scores.shape
    keep = c * m if keep < 0 else keep
    dev = scores.device
    s = torch.where(scores >= score_thr, scores, scores.new_zeros(()))
    order = torch.sort(-s, dim=-1, stable=True).indices  # (N, C, M)
    s = s.gather(-1, order)
    b = bboxes[:, None].expand(n, c, m, 4).gather(2, order[..., None].expand(n, c, m, 4))
    tri = torch.arange(m, device=dev)[:, None] > torch.arange(m, device=dev)[None, :]
    lower = torch.where(tri, iou_matrix(b), s.new_zeros(()))  # [j, i] = iou, i < j
    comp = lower.amax(dim=-1)  # each box's own max IoU with a higher one
    if a.get("use_gaussian", False):
        decay = torch.exp(-(torch.square(lower) - torch.square(comp)[..., None, :]) / sigma)
    else:
        decay = (1.0 - lower) / torch.clamp_min(1.0 - comp[..., None, :], f32(1e-10, dev))
    ds = torch.where(tri, decay, s.new_ones(())).amin(dim=-1) * s  # (N, C, M)
    flat = ds.reshape(n, c * m)
    flat = torch.where(flat >= post_thr, flat, flat.new_zeros(()))
    k = min(keep, c * m)
    top_s, top_i = topk_stable(flat, k)
    cls = torch.div(top_i, m, rounding_mode="floor").to(torch.float32)
    rows = torch.cat([cls[..., None], top_s[..., None],
                      b.reshape(n, c * m, 4).gather(1, top_i[..., None].expand(n, k, 4))], dim=-1)
    if k < keep:
        rows = torch.cat([rows, rows.new_full((n, keep - k, 6), -1.0)], dim=1)
    return {"Out": [rows]}


OPS.register("matrix_nms", infer_shape=_matrix_nms_shape, input_slots=("BBoxes", "Scores"))
OPS.get("matrix_nms").impls["torch"] = _matrix_nms_impl


# ---- grid_sampler (TPS / STN recognition models) ----------------------------------------------------------

def _grid_sampler_impl(ctx, op, ins):
    """Bilinear grid sample (NHWC), zeros outside, ``align_corners`` per
    attr; the grid holds (x, y) in [-1, 1]."""
    x, grid = ins["X"][0], ins["Grid"][0]
    n, h, w, c = x.shape
    gx, gy = grid[..., 0], grid[..., 1]
    if op.attrs.get("align_corners", True):
        fx = (gx + 1) * 0.5 * (w - 1)
        fy = (gy + 1) * 0.5 * (h - 1)
    else:
        fx = ((gx + 1) * w - 1) * 0.5
        fy = ((gy + 1) * h - 1) * 0.5
    x0, y0 = torch.floor(fx), torch.floor(fy)
    wx, wy = (fx - x0)[..., None], (fy - y0)[..., None]
    batch = torch.arange(n, device=x.device).reshape(n, 1, 1)

    def sample(yy, xx):
        valid = (yy >= 0) & (yy < h) & (xx >= 0) & (xx < w)
        v = x[batch, yy.clamp(0, h - 1).to(torch.int64), xx.clamp(0, w - 1).to(torch.int64)]
        return v * valid[..., None]

    out = (sample(y0, x0) * (1 - wx) * (1 - wy) + sample(y0, x0 + 1) * wx * (1 - wy)
           + sample(y0 + 1, x0) * (1 - wx) * wy + sample(y0 + 1, x0 + 1) * wx * wy)
    return {"Output": [out]}


OPS.register("grid_sampler", input_slots=("X", "Grid"), output_slots=("Output",),
             infer_shape=lambda attrs, in_shapes: [
                 (in_shapes[0][0], in_shapes[1][1], in_shapes[1][2], in_shapes[0][3])])
OPS.get("grid_sampler").impls["torch"] = _grid_sampler_impl


# ---- random: jax.random's bits, seeded -----------------------------------------------------------------

_M32 = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


def threefry2x32(k0: int, k1: int, x0: torch.Tensor, x1: torch.Tensor):
    """The Threefry-2x32 hash (20 rounds) of the counter words (x0, x1)
    under the key (k0, k1): int64 tensors holding unsigned 32-bit values."""
    def rotl(v, r):
        return ((v << r) | (v >> (32 - r))) & _M32

    ks = (k0, k1, k0 ^ k1 ^ 0x1BD11BDA)
    x0, x1 = (x0 + ks[0]) & _M32, (x1 + ks[1]) & _M32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & _M32
            x1 = rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & _M32
        x1 = (x1 + ks[(i + 2) % 3] + i + 1) & _M32
    return x0, x1


def random_bits(seed: int, shape, device) -> torch.Tensor:
    """``jax.random.bits(PRNGKey(seed), shape)`` (uint32, as int64): the
    key is (0, seed mod 2^32) for a 32-bit seed; the counter of an element
    is its flat index as (high, low) words; the bits are the two hash
    words xor-ed."""
    seed = int(seed)
    k0 = 0 if -2 ** 31 <= seed < 2 ** 31 else (seed >> 32) & _M32
    idx = torch.arange(math.prod(shape), dtype=torch.int64, device=device)
    y0, y1 = threefry2x32(k0, seed & _M32, idx >> 32, idx & _M32)
    return (y0 ^ y1).reshape(tuple(shape))


def uniform_f32(seed: int, shape, lo: float, hi: float, device) -> torch.Tensor:
    """``jax.random.uniform(PRNGKey(seed), shape, minval=lo, maxval=hi)``:
    the bits' top 23 as a mantissa in [1, 2), less 1, times ``hi − lo``
    plus ``lo`` (float32 operands) as one fused multiply-add, as XLA
    contracts it on the CPU, at least ``lo``.  The FMA is computed in
    float64, where the product of two float32 values is exact and, for
    bounds within 2^29 of each other's scale, so is the sum, so the one
    rounding to float32 is the FMA's."""
    one = np.array(1.0, np.float32).view(np.uint32)
    bits = (random_bits(seed, shape, device) >> 9) | int(one)
    u = bits.to(torch.int32).view(torch.float32) - 1.0
    lo32, hi32 = np.float32(lo), np.float32(hi)
    y = (u.to(torch.float64) * float(hi32 - lo32) + float(lo32)).to(torch.float32)
    return torch.maximum(f32(lo32, device), y)


def normal_f32(seed: int, shape, device) -> torch.Tensor:
    """``jax.random.normal(PRNGKey(seed), shape)``: √2 · erfinv(u), u
    uniform in (-1, 1) from the same bits."""
    lo = np.nextafter(np.float32(-1.0), np.float32(0.0), dtype=np.float32)
    u = uniform_f32(seed, shape, float(lo), 1.0, device)
    return f32(np.float32(np.sqrt(2)), device) * torch.special.erfinv(u)


def _rand_shape(attrs, in_shapes):
    return [tuple(int(s) for s in attrs["shape"])]


def _uniform_random_impl(ctx, op, ins):
    a = op.attrs
    return {"Out": [ctx.const(op, "value", lambda: uniform_f32(
        a.get("seed", 0), [int(s) for s in a["shape"]], a.get("min", -1.0),
        a.get("max", 1.0), ctx.device))]}


def _gaussian_random_impl(ctx, op, ins):
    a = op.attrs
    return {"Out": [ctx.const(op, "value", lambda: a.get("mean", 0.0) + a.get("std", 1.0)
                              * normal_f32(a.get("seed", 0), [int(s) for s in a["shape"]],
                                           ctx.device))]}


_reg("uniform_random", _rand_shape, _uniform_random_impl)
_reg("gaussian_random", _rand_shape, _gaussian_random_impl)
