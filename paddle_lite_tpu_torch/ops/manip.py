"""Tensor-manipulation ops: ``reshape`` / ``reshape2``, ``concat``, the
interpolations and ``pixel_shuffle``.

Port of the reshape family head of ``paddle_lite_tpu/ops/manip.py``
(``:31-53``; int8 flows through unchanged, same scale), of its ``concat``
(``:128-161``), of ``interp_xla`` (``:277-345``) and of ``pixel_shuffle``
(``ops/extra.py:95-110``).
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
