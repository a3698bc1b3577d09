"""Tensor-manipulation ops: ``reshape`` / ``reshape2``, ``flatten`` /
``flatten2``, ``squeeze`` / ``squeeze2``, ``unsqueeze`` / ``unsqueeze2``,
``transpose`` / ``transpose2``, ``concat``, ``split``, ``stack``,
``slice``, ``lookup_table`` / ``lookup_table_v2``, the interpolations,
``pixel_shuffle``, the reductions ``reduce_mean`` / ``_sum`` / ``_max`` /
``_min`` / ``_prod``, ``arg_max``, ``fill_constant``, ``shape``, and
``expand``, ``gather``, ``norm``, ``pad2d``, ``shuffle_channel``,
``space_to_depth`` and ``top_k``.

Port of the reshape family head of ``paddle_lite_tpu/ops/manip.py``
(``:31-110``; int8 flows through unchanged, same scale), of its
``transpose`` (``:113-125``), ``concat`` (``:128-161``), ``split``
(``:164-190``), ``stack`` (``:193-203``), ``slice`` (``:206-229``),
``lookup_table`` (``:423-441``), of ``interp_xla`` (``:277-345``), of
the reductions and ``arg_max`` (``:346-396``), of ``fill_constant`` and
``shape`` (``:444-463``), of ``pixel_shuffle`` (``ops/extra.py:95-110``)
and of ``expand`` (``:233-243``), ``shuffle_channel`` (``:247-256``),
``pad2d`` (``:260-274``), ``top_k`` (``:399-408``), ``gather``
(``:412-419``), ``norm`` (``:466-477``) and ``space_to_depth``
(``:480-499``).
None of them reads a value back to the host, so each runs inside a CUDA
graph; ``fill_constant``'s and ``shape``'s outputs depend on attrs and
shapes only, so each is made once per op and kept on the device, as XLA
folds them.

Two departures from the reference, each a fault there:
- ``reduce_*`` with ``reduce_all`` set reduces every axis, whatever
  ``dim`` says (fluid's contract: ``layers.reduce_mean(x)`` exports
  ``dim=[0], reduce_all=True``); the reference reads only ``dim``;
- ``arg_max`` with ``keepdims`` set keeps the reduced axis as 1; the
  reference drops it either way.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.registry import OPS
from .common import INT8_MAX, INT8_MIN, dequantize, f32, upcast


@OPS.shape_fn("reshape")
def reshape_shape(attrs, in_shapes):
    x = in_shapes[0]
    shape = list(attrs["shape"])
    n = int(np.prod(x))
    for i, s in enumerate(shape):
        if s == 0:
            shape[i] = x[i]
    if -1 in shape:
        i = shape.index(-1)
        known = int(np.prod([s for s in shape if s != -1]))
        shape[i] = n // known
    return [tuple(shape)]


@OPS.kernel("reshape", "torch")
@OPS.kernel("reshape2", "torch")
def reshape_torch(ctx, op, ins):
    return {"Out": [ins["X"][0].reshape(ctx.var_shape(op.output("Out")))]}


OPS.register("reshape2", infer_shape=reshape_shape)


@OPS.shape_fn("transpose")
def transpose_shape(attrs, in_shapes):
    x = in_shapes[0]
    return [tuple(x[a] for a in attrs["axis"])]


@OPS.kernel("transpose", "torch")
@OPS.kernel("transpose2", "torch")
def transpose_torch(ctx, op, ins):
    """``axis`` is the permutation; any dtype (data movement only)."""
    return {"Out": [ins["X"][0].permute(*op.attrs["axis"])]}


OPS.register("transpose2", infer_shape=transpose_shape)


@OPS.shape_fn("concat")
def concat_shape(attrs, in_shapes):
    axis = int(attrs.get("axis", 0))
    out = list(in_shapes[0])
    out[axis] = sum(s[axis] for s in in_shapes)
    return [tuple(out)]


@OPS.kernel("concat", "torch")
def concat_torch(ctx, op, ins):
    """fp32 concat (int8 inputs dequantized), or — when the quantize pass
    gave the op an int8 region (``out_scale``) and every input is int8 —
    the int8 concat: each input requants to the common output scale with
    ``round(x·fp32(s_in/s_out))`` clipped to ±127 (the ratio taken in
    double, as the reference does)."""
    xs = ins["X"]
    axis = int(op.attrs.get("axis", 0))
    out_scale = op.attrs.get("out_scale")
    if out_scale is not None and all(x.dtype == torch.int8 for x in xs):
        parts = []
        for x, name in zip(xs, op.inputs["X"]):
            r = float(ctx.var_quant(name).scale[0]) / float(out_scale)
            if r == 1.0:
                parts.append(x)
            else:  # r <= 1 by construction (the out scale is the max)
                q = torch.round(x.to(torch.float32) * f32(r, x.device))
                parts.append(torch.clamp(q, INT8_MIN, INT8_MAX).to(torch.int8))
        return {"Out": [torch.cat(parts, dim=axis)]}
    fixed = [dequantize(x, ctx.var_quant(name).scale[0])
             if x.dtype == torch.int8 else x
             for x, name in zip(xs, op.inputs["X"])]
    return {"Out": [torch.cat(fixed, dim=axis)]}


@OPS.shape_fn("split")
def split_shape(attrs, in_shapes):
    x = list(in_shapes[0])
    axis = int(attrs.get("axis", 0))
    sections = attrs.get("sections")
    if sections:
        outs = []
        for s in sections:
            shp = list(x)
            shp[axis] = s
            outs.append(tuple(shp))
        return outs
    num = int(attrs["num"])
    shp = list(x)
    shp[axis] = x[axis] // num
    return [tuple(shp)] * num


@OPS.kernel("split", "torch")
def split_torch(ctx, op, ins):
    """Pieces of the given ``sections`` along ``axis``, or ``num`` equal
    pieces (``num`` must divide the axis, as ``jnp.split`` requires)."""
    x = ins["X"][0]
    axis = int(op.attrs.get("axis", 0))
    sections = op.attrs.get("sections")
    if sections:
        return {"Out": list(torch.split(x, [int(s) for s in sections], dim=axis))}
    num = int(op.attrs["num"])
    if x.shape[axis] % num:
        raise ValueError(f"split: axis {axis} of {tuple(x.shape)} does not divide "
                         f"into {num} equal pieces")
    return {"Out": list(torch.split(x, x.shape[axis] // num, dim=axis))}


@OPS.shape_fn("slice")
def slice_shape(attrs, in_shapes):
    x = list(in_shapes[0])
    for ax, st, en in zip(attrs["axes"], attrs["starts"], attrs["ends"]):
        dim = x[ax]
        st = max(st + dim, 0) if st < 0 else min(st, dim)
        en = max(en + dim, 0) if en < 0 else min(en, dim)
        x[ax] = max(en - st, 0)
    out = tuple(x)
    for ax in sorted(attrs.get("decrease_axis", []), reverse=True):
        out = out[:ax] + out[ax + 1:]
    return [out]


@OPS.kernel("slice", "torch")
def slice_torch(ctx, op, ins):
    """``x[starts:ends]`` on each of ``axes``, with Python's bounds (a
    negative bound counts from the end, a bound past the end is clamped),
    then the ``decrease_axis`` dims dropped."""
    x = ins["X"][0]
    idx = [slice(None)] * x.ndim
    for ax, st, en in zip(op.attrs["axes"], op.attrs["starts"], op.attrs["ends"]):
        idx[ax] = slice(int(st), int(en))
    y = x[tuple(idx)]
    if op.attrs.get("decrease_axis"):
        y = y.reshape(ctx.var_shape(op.output("Out")))
    return {"Out": [y]}


@OPS.shape_fn("lookup_table")
def lookup_table_shape(attrs, in_shapes):
    w, ids = in_shapes[0], in_shapes[1]
    out = tuple(ids)
    if out and out[-1] == 1:
        out = out[:-1]
    return [out + (w[-1],)]


def take_rows(w: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """``jnp.take(w, ids, axis=0)`` in its fill mode: an id in [-V, 0)
    counts from the end, an id outside [-V, V) gives a filled row (NaN for
    a float table, the dtype's minimum for a signed integer one, its
    maximum for an unsigned one, True for a boolean one).  Computed on the
    device without a host sync: the ids wrapped and clamped into range,
    the rows gathered, the invalid ones replaced."""
    ids = ids.to(torch.int32)
    v = w.shape[0]
    valid = (ids >= -v) & (ids < v)
    rows = w.index_select(0, torch.where(ids < 0, ids + v, ids).clamp(0, v - 1).reshape(-1))
    rows = rows.reshape(tuple(ids.shape) + tuple(w.shape[1:]))
    if w.is_floating_point():
        fill = float("nan")
    elif w.dtype == torch.bool:
        fill = True
    else:
        fill = torch.iinfo(w.dtype).min if w.dtype.is_signed else torch.iinfo(w.dtype).max
    invalid = ~valid.reshape(tuple(ids.shape) + (1,) * (w.ndim - 1))
    return rows.masked_fill(invalid, fill)


@OPS.kernel("lookup_table", "torch")
@OPS.kernel("lookup_table_v2", "torch")
def lookup_table_torch(ctx, op, ins):
    """Rows of ``W`` (V, D) at ``Ids`` (int32 after the reference's cast;
    a trailing dim of 1 squeezed), as :func:`take_rows` gives them."""
    w, ids = ins["W"][0], ins["Ids"][0]
    if ids.ndim and ids.shape[-1] == 1:
        ids = ids.squeeze(-1)
    return {"Out": [take_rows(w, ids)]}


OPS.register("lookup_table_v2", infer_shape=lookup_table_shape)


# ---------------------------------------------------------------------------
# nearest_interp / bilinear_interp (``manip.py:277-345`` there)
# ---------------------------------------------------------------------------

def _interp_shape(attrs, in_shapes):
    n, h, w, c = in_shapes[0]
    if attrs.get("out_h", -1) > 0:
        return [(n, int(attrs["out_h"]), int(attrs["out_w"]), c)]
    s = attrs.get("scale", 2.0)
    return [(n, int(h * s), int(w * s), c)]


def nearest_index(m: int, n: int) -> np.ndarray:
    """The source pixel of each of `n` outputs from `m` inputs, as
    ``jax.image.resize(method="nearest")`` takes it: floor((i + 0.5)·m / n),
    computed in float32."""
    f = np.float32
    return np.floor((np.arange(n, dtype=f) + f(0.5)) * f(m) / f(n)).astype(np.int64)


def linear_weights(m: int, n: int) -> np.ndarray:
    """(m, n) float32 weights of ``jax.image.resize(method="bilinear")``
    (``compute_weight_mat``, antialias on): a triangle kernel at the
    half-pixel sample points, widened by the scale when downsampling,
    normalized over the inputs, zero for samples outside the input."""
    f = np.float32
    inv = f(1.0 / (n / m))
    sample = (np.arange(n, dtype=f) + f(0.5)) * inv - f(0.5)
    kscale = max(inv, f(1.0))
    x = np.abs(sample[None, :] - np.arange(m, dtype=f)[:, None]) / kscale
    w = np.maximum(f(0.0), f(1.0) - x).astype(f)
    total = w.sum(axis=0, keepdims=True, dtype=f)
    w = np.where(np.abs(total) > f(1000.0 * np.finfo(np.float32).eps),
                 w / np.where(total != 0, total, f(1.0)), f(0.0))
    inside = (sample >= -0.5) & (sample <= f(m) - f(0.5))
    return np.where(inside[None, :], w, f(0.0)).astype(f)


def _align_corners(x: torch.Tensor, oh: int, ow: int) -> torch.Tensor:
    """Bilinear with align_corners (the reference's gather form)."""
    ih, iw = x.shape[1], x.shape[2]
    ys = torch.linspace(0.0, ih - 1.0, oh, device=x.device)
    xs = torch.linspace(0.0, iw - 1.0, ow, device=x.device)
    y0, x0 = torch.floor(ys).long(), torch.floor(xs).long()
    y1, x1 = torch.clamp(y0 + 1, max=ih - 1), torch.clamp(x0 + 1, max=iw - 1)
    wy = (ys - y0)[None, :, None, None].to(x.dtype)
    wx = (xs - x0)[None, None, :, None].to(x.dtype)

    def g(yi, xi):
        return x[:, yi][:, :, xi]

    return (g(y0, x0) * (1 - wy) * (1 - wx) + g(y0, x1) * (1 - wy) * wx
            + g(y1, x0) * wy * (1 - wx) + g(y1, x1) * wy * wx)


def interp_torch(ctx, op, ins):
    """Nearest or bilinear resize of an NHWC tensor to the output var's
    shape.  A nearest interp whose output var is INT8 copies int8 values
    (the same scale); any other int8 input is dequantized first.  Nearest
    by an integer factor is a broadcast; otherwise nearest gathers the
    reference's source pixels, and bilinear (without align_corners)
    contracts H and W with the reference's weight matrices, in float32."""
    x = ins["X"][0]
    nearest = op.op_type.startswith("nearest")
    if x.dtype == torch.int8 and not (
            nearest and ctx.graph.vars[op.output("Out")].precision.name == "INT8"):
        x = dequantize(x, ctx.var_quant(op.input("X")).scale[0])
    n, oh, ow, c = ctx.var_shape(op.output("Out"))
    ih, iw = x.shape[1], x.shape[2]
    align = op.attrs.get("align_corners", False)
    if not nearest and align:
        return {"Out": [_align_corners(x, oh, ow)]}
    if nearest and not align and oh % ih == 0 and ow % iw == 0:
        fh, fw = oh // ih, ow // iw
        out = x[:, :, None, :, None, :].expand(n, ih, fh, iw, fw, c)
        return {"Out": [out.reshape(n, oh, ow, c)]}
    if nearest:
        iy, ix = (ctx.const(op, key, lambda m=m, o=o: ctx.tensor(nearest_index(m, o)))
                  for key, m, o in (("iy", ih, oh), ("ix", iw, ow)))
        return {"Out": [x.index_select(1, iy).index_select(2, ix)]}
    wy, wx = (ctx.const(op, key, lambda m=m, o=o: ctx.tensor(linear_weights(m, o)))
              for key, m, o in (("wy", ih, oh), ("wx", iw, ow)))
    xf = upcast(x)
    y = torch.einsum("nhwc,hH->nHwc", xf, wy.to(xf.dtype))
    y = torch.einsum("nHwc,wW->nHWc", y, wx.to(xf.dtype))
    return {"Out": [y.to(x.dtype)]}


for _name in ("nearest_interp", "bilinear_interp"):
    OPS.register(_name, infer_shape=_interp_shape)
    OPS.get(_name).impls["torch"] = interp_torch


# ---------------------------------------------------------------------------
# pixel_shuffle (``extra.py:95-110`` there)
# ---------------------------------------------------------------------------

@OPS.shape_fn("pixel_shuffle")
def pixel_shuffle_shape(attrs, in_shapes):
    n, h, w, c = in_shapes[0]
    r = int(attrs.get("upscale_factor", 2))
    return [(n, h * r, w * r, c // (r * r))]


@OPS.kernel("pixel_shuffle", "torch")
def pixel_shuffle_torch(ctx, op, ins):
    """NHWC depth-to-space; input channels in (dy, dx, c) order, the order
    ``deconv_pack`` packs its heads in.  Any dtype: data movement only."""
    x = ins["X"][0]
    r = int(op.attrs.get("upscale_factor", 2))
    n, h, w, c = x.shape
    co = c // (r * r)
    y = x.reshape(n, h, w, r, r, co).permute(0, 1, 3, 2, 4, 5)
    return {"Out": [y.reshape(n, h * r, w * r, co)]}


# ---------------------------------------------------------------------------
# flatten / squeeze / unsqueeze (``manip.py:56-110`` there): views
# ---------------------------------------------------------------------------

@OPS.shape_fn("flatten")
def flatten_shape(attrs, in_shapes):
    x = in_shapes[0]
    axis = int(attrs.get("axis", 1))
    lead = int(np.prod(x[:axis])) if axis else 1
    return [(lead, int(np.prod(x[axis:])))]


def _squeeze_shape(attrs, in_shapes):
    x = list(in_shapes[0])
    axes = attrs.get("axes", [])
    if axes:
        drop = [a % len(x) for a in axes]
        keep = [d for i, d in enumerate(x) if i not in drop]
    else:
        keep = [d for d in x if d != 1]
    return [tuple(keep)]


def _unsqueeze_shape(attrs, in_shapes):
    x = list(in_shapes[0])
    for a in sorted(attrs["axes"]):
        x.insert(a if a >= 0 else a + len(x) + 1, 1)
    return [tuple(x)]


for _name, _shape in (("flatten", flatten_shape), ("flatten2", flatten_shape),
                      ("squeeze", _squeeze_shape), ("squeeze2", _squeeze_shape),
                      ("unsqueeze", _unsqueeze_shape), ("unsqueeze2", _unsqueeze_shape)):
    OPS.register(_name, infer_shape=_shape)
    OPS.get(_name).impls["torch"] = reshape_torch  # a view; int8 keeps its scale


# ---------------------------------------------------------------------------
# stack (``manip.py:193-203`` there)
# ---------------------------------------------------------------------------

@OPS.shape_fn("stack")
def stack_shape(attrs, in_shapes):
    axis = int(attrs.get("axis", 0))
    out = list(in_shapes[0])
    out.insert(axis if axis >= 0 else axis + len(out) + 1, len(in_shapes))
    return [tuple(out)]


@OPS.kernel("stack", "torch")
def stack_torch(ctx, op, ins):
    return {"Y": [torch.stack(ins["X"], dim=int(op.attrs.get("axis", 0)))]}


# ---------------------------------------------------------------------------
# reductions and arg_max (``manip.py:346-396`` there)
# ---------------------------------------------------------------------------

def reduce_dims(attrs, rank: int):
    """The reduced axes, non-negative: every axis when ``reduce_all`` is set
    or ``dim`` is absent, else ``dim``."""
    if attrs.get("reduce_all") or "dim" not in attrs:
        return tuple(range(rank))
    return tuple(sorted({int(d) % rank for d in attrs["dim"]}))


def _reduce_shape(attrs, in_shapes):
    x = list(in_shapes[0])
    dims = reduce_dims(attrs, len(x))
    if attrs.get("keep_dim"):
        return [tuple(1 if i in dims else d for i, d in enumerate(x))]
    out = tuple(d for i, d in enumerate(x) if i not in dims)
    return [out if out else (1,)]


_NARROW_INTS = (torch.int16, torch.int32, torch.uint8)


def reduce_impl(fn):
    """The impl of a reduction `fn(x, dims, keep_dim)`: int8 input
    dequantized; a 0-d result as shape (1,), as the reference gives it."""
    def impl(ctx, op, ins):
        x = ins["X"][0]
        if x.dtype == torch.int8:
            x = dequantize(x, ctx.var_quant(op.input("X")).scale[0])
        dims = reduce_dims(op.attrs, x.ndim)
        # no axis reduces nothing, as jnp's axis=() (torch's dim=() is all)
        y = fn(x, dims, bool(op.attrs.get("keep_dim"))) if dims else x
        if y.dtype == torch.int64 != x.dtype and x.dtype in _NARROW_INTS:
            y = y.to(x.dtype)  # torch sums ints in int64, jnp in their own type
        return {"Out": [y.reshape(1) if y.ndim == 0 else y]}

    return impl


def _prod(x, dims, keep):
    for d in sorted(dims, reverse=True):  # torch.prod takes one axis at a time
        x = torch.prod(x, dim=d, keepdim=keep)
    return x


REDUCES = {
    "reduce_mean": lambda x, dims, keep: torch.mean(x, dim=dims, keepdim=keep),
    "reduce_sum": lambda x, dims, keep: torch.sum(x, dim=dims, keepdim=keep),
    "reduce_max": lambda x, dims, keep: torch.amax(x, dim=dims, keepdim=keep),
    "reduce_min": lambda x, dims, keep: torch.amin(x, dim=dims, keepdim=keep),
    "reduce_prod": _prod,
}

for _name, _fn in REDUCES.items():
    OPS.register(_name, infer_shape=_reduce_shape)
    OPS.get(_name).impls["torch"] = reduce_impl(_fn)


@OPS.shape_fn("arg_max")
def argmax_shape(attrs, in_shapes):
    x = list(in_shapes[0])
    axis = int(attrs.get("axis", -1)) % len(x)
    if attrs.get("keepdims"):
        x[axis] = 1
    else:
        del x[axis]
    return [tuple(x) if x else (1,)]


@OPS.kernel("arg_max", "torch")
def argmax_torch(ctx, op, ins):
    """int64 index of the first greatest value along ``axis`` (NaN ranks
    above every number, as in ``jnp.argmax``)."""
    y = torch.argmax(ins["X"][0], dim=int(op.attrs.get("axis", -1)),
                     keepdim=bool(op.attrs.get("keepdims")))
    return {"Out": [y.reshape(ctx.var_shape(op.output("Out")))]}


# ---------------------------------------------------------------------------
# fill_constant and shape (``manip.py:444-463`` there): constants
# ---------------------------------------------------------------------------

@OPS.shape_fn("fill_constant")
def fill_constant_shape(attrs, in_shapes):
    return [tuple(attrs["shape"])]


@OPS.kernel("fill_constant", "torch")
def fill_constant_torch(ctx, op, ins):
    """``value`` cast to ``dtype`` (a numpy dtype name) over ``shape``, as
    ``jnp.full`` makes it; made once per op."""
    return {"Out": [ctx.const(op, "value", lambda: ctx.tensor(np.full(
        tuple(op.attrs["shape"]), op.attrs.get("value", 0.0),
        dtype=np.dtype(op.attrs.get("dtype", "float32")))))]}


@OPS.shape_fn("shape")
def shape_shape(attrs, in_shapes):
    return [(len(in_shapes[0]),)]


@OPS.kernel("shape", "torch")
def shape_torch(ctx, op, ins):
    """The input's shape as int32; made once per op."""
    shape = tuple(ins["Input"][0].shape)
    return {"Out": [ctx.const(op, "shape", lambda: ctx.tensor(
        np.asarray(shape, np.int32)))]}



# ---------------------------------------------------------------------------
# expand, shuffle_channel, pad2d, space_to_depth (``manip.py:233-274``,
# ``:480-499`` there): data movement
# ---------------------------------------------------------------------------

@OPS.shape_fn("expand")
def expand_shape(attrs, in_shapes):
    times = attrs["expand_times"]
    return [tuple(d * t for d, t in zip(in_shapes[0], times))]


@OPS.kernel("expand", "torch")
def expand_torch(ctx, op, ins):
    """``jnp.tile`` by ``expand_times``."""
    return {"Out": [ins["X"][0].repeat(*[int(t) for t in op.attrs["expand_times"]])]}


@OPS.shape_fn("shuffle_channel")
def shuffle_channel_shape(attrs, in_shapes):
    return [in_shapes[0]]


@OPS.kernel("shuffle_channel", "torch")
def shuffle_channel_torch(ctx, op, ins):
    x = ins["X"][0]  # NHWC
    g = int(op.attrs["group"])
    n, h, w, c = x.shape
    return {"Out": [x.reshape(n, h, w, g, c // g).transpose(3, 4).reshape(n, h, w, c)]}


@OPS.shape_fn("pad2d")
def pad2d_shape(attrs, in_shapes):
    n, h, w, c = in_shapes[0]
    p = attrs["paddings"]  # [top, bottom, left, right]
    return [(n, h + p[0] + p[1], w + p[2] + p[3], c)]


_PAD_MODES = {"reflect": "reflect", "edge": "replicate"}


@OPS.kernel("pad2d", "torch")
def pad2d_torch(ctx, op, ins):
    """NHWC padding: ``constant`` (``pad_value``), ``reflect`` (no edge
    repeat, ``jnp.pad``'s reflect) or ``edge``."""
    x = ins["X"][0]
    t, b, l, r = (int(p) for p in op.attrs["paddings"])
    mode = op.attrs.get("mode", "constant")
    if mode == "constant":
        return {"Out": [torch.nn.functional.pad(
            x, (0, 0, l, r, t, b), value=float(op.attrs.get("pad_value", 0.0)))]}
    y = torch.nn.functional.pad(x.permute(0, 3, 1, 2), (l, r, t, b), mode=_PAD_MODES[mode])
    return {"Out": [y.permute(0, 2, 3, 1)]}


@OPS.shape_fn("space_to_depth")
def space_to_depth_shape(attrs, in_shapes):
    n, h, w, c = in_shapes[0]
    bh, bw = attrs.get("blocks", (2, 2))
    return [(n, h // bh, w // bw, c * bh * bw)]


@OPS.kernel("space_to_depth", "torch")
def space_to_depth_torch(ctx, op, ins):
    """NHWC space-to-depth; output channels in (bh, bw, c) order."""
    x = ins["X"][0]
    bh, bw = (int(b) for b in op.attrs.get("blocks", (2, 2)))
    n, h, w, c = x.shape
    y = x.reshape(n, h // bh, bh, w // bw, bw, c).permute(0, 1, 3, 2, 4, 5)
    return {"Out": [y.reshape(n, h // bh, w // bw, bh * bw * c)]}


# ---------------------------------------------------------------------------
# top_k, gather, norm (``manip.py:399-419``, ``:466-477`` there)
# ---------------------------------------------------------------------------

@OPS.shape_fn("top_k")
def topk_shape(attrs, in_shapes):
    x = list(in_shapes[0])
    x[-1] = int(attrs["k"])
    return [tuple(x), tuple(x)]


def topk_lax(x: torch.Tensor, k: int):
    """``jax.lax.top_k`` along the last axis: descending, ties by lower
    index; floats in IEEE total order (``detection.topk_stable``)."""
    from .detection import topk_stable

    if x.is_floating_point():
        v, i = topk_stable(x.to(torch.float32), k)
        return v.to(x.dtype), i
    i = torch.sort(x, dim=-1, descending=True, stable=True).indices[..., :k]
    return x.gather(-1, i), i


@OPS.kernel("top_k", "torch")
def topk_torch(ctx, op, ins):
    v, i = topk_lax(ins["X"][0], int(op.attrs["k"]))
    return {"Out": [v], "Indices": [i.to(torch.int64)]}


@OPS.shape_fn("gather")
def gather_shape(attrs, in_shapes):
    x, idx = in_shapes[0], in_shapes[1]
    return [tuple(idx[:1]) + tuple(x[1:])]


@OPS.kernel("gather", "torch")
def gather_torch(ctx, op, ins):
    """Rows of ``X`` at ``Index``, ``jnp.take(x, idx, axis=0)``'s fill mode
    (:func:`take_rows`), on the device."""
    return {"Out": [take_rows(ins["X"][0], ins["Index"][0])]}


@OPS.shape_fn("norm")
def norm_shape(attrs, in_shapes):
    return [in_shapes[0]]


@OPS.kernel("norm", "torch")
def norm_torch(ctx, op, ins):
    """``x / sqrt(sum(x², axis) + epsilon)``."""
    x = ins["X"][0]
    axis = int(op.attrs.get("axis", -1))
    eps = f32(op.attrs.get("epsilon", 1e-10), x.device)
    return {"Out": [x / torch.sqrt(torch.sum(x * x, dim=axis, keepdim=True) + eps)]}
