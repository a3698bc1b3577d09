"""Core NN ops of the main path under the ``torch`` tag: conv2d /
depthwise_conv2d / fc / mul / batch_norm / pool2d / softmax.

Port of ``paddle_lite_tpu/ops/nn.py`` (``conv2d_xla`` ``:94-170``,
``fc_xla`` ``:257``, ``mul_xla`` ``:284``, ``batch_norm_xla`` ``:361``,
``pool2d_xla`` ``:395``, ``softmax_xla`` ``:463``), the analog of the
reference's ``lite/kernels/arm/{conv,fc,pool,softmax}_compute.cc``.

Tensors are NHWC / HWIO at every function boundary, as in the JAX package;
convolutions permute to torch's NCHW / OIHW inside the op (the permuted
input is a channels-last view, so no copy is made).

Int8 semantics: int8×int8→int32 accumulation, then the epilogue
``acc·(s_x·s_w[c]) + bias → act → optional round(y / out_scale)`` clipped
to ±127.  torch has no int8 convolution, so an int8 conv runs as fp32
convs followed by ``round``.  One fp32 conv is exact while every partial
sum stays below 2^24, which holds for every int8 input up to K = kh·kw·C =
:data:`FP32_EXACT_K`; past it the input channels are split into chunks of
K ≤ :data:`FP32_EXACT_K`, each chunk's conv is rounded, and the chunks are
summed in int32: the reference's int32 accumulator on its target
(``preferred_element_type=jnp.int32``, ``nn.py:158-160``), exact for any
K, converted to fp32 once.  The int8 fc / mul run as a float64 matmul cast
back to an integer-valued fp32 tensor, exact for |acc| < 2^53.

Float ops on bf16 island values (``graph.meta["island_dtype"]``) take
bf16 operands with fp32 accumulation and give fp32, as the reference's
``preferred_element_type=jnp.float32``: the operands are upcast (a bf16
product is exact in fp32) and the executor rounds the output to bf16.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from ..core.registry import OPS
from .common import (
    apply_activation,
    conv_out_size,
    dequantize,
    effective_conv_scale,
    f32,
    normalize_2d,
    normalize_paddings,
    quantize,
    upcast,
)

# an fp32 conv of int8 operands is exact for every input while every
# partial sum stays below 2^24: K·127² < 2^24 up to K = 1040
FP32_EXACT_K = 1040

# ---------------------------------------------------------------------------
# conv2d / depthwise_conv2d
# ---------------------------------------------------------------------------


def _conv_shape(attrs, in_shapes):
    (n, h, w, _), (kh, kw, _, oc) = in_shapes[0], in_shapes[1]
    sh, sw = normalize_2d(attrs.get("strides", (1, 1)))
    dh, dw = normalize_2d(attrs.get("dilations", (1, 1)))
    ph, pw = normalize_paddings(attrs.get("paddings", (0, 0)))
    return [(n, conv_out_size(h, kh, sh, ph, dh), conv_out_size(w, kw, sw, pw, dw), oc)]


@OPS.shape_fn("conv2d")
def conv2d_shape(attrs, in_shapes):
    return _conv_shape(attrs, in_shapes)


@OPS.shape_fn("depthwise_conv2d")
def dw_conv2d_shape(attrs, in_shapes):
    return _conv_shape(attrs, in_shapes)


def eff_scale(ctx, op, x_name: str, w_name: str) -> torch.Tensor:
    """s_x·s_w[c] as a device tensor, folded once per op."""
    return ctx.const(op, "eff", lambda: ctx.tensor(effective_conv_scale(
        ctx.var_quant(x_name).scale[0], ctx.var_quant(w_name).scale_array())))


def _check_dtypes(op, a: torch.Tensor, b: torch.Tensor) -> bool:
    """True for int8×int8, False for float×float; mixed operands (the
    weight-only storage mode) are not ported yet."""
    a_int, b_int = a.dtype == torch.int8, b.dtype == torch.int8
    if a_int != b_int or (not a_int and not (a.is_floating_point()
                                             and b.is_floating_point())):
        raise NotImplementedError(
            f"{op.op_type}: operands {a.dtype} x {b.dtype} (weight-only or "
            f"mixed precision) are not ported yet"
        )
    return a_int


def _conv_epilogue(ctx, op, acc, x_name, w_name, bias, residual, residual_name,
                   int8_acc: bool = False):
    """Shared conv/fc epilogue (``nn.py:65-91`` there).  ``int8_acc`` marks
    a float accumulator that holds exact int8×int8 sums."""
    attrs = op.attrs
    y = acc * eff_scale(ctx, op, x_name, w_name) if int8_acc else acc
    if bias is not None:
        y = y + bias.to(torch.float32)
    if residual is not None:
        if residual.dtype == torch.int8:
            residual = dequantize(residual, ctx.var_quant(residual_name).scale[0])
        y = y + residual
    y = apply_activation(y, attrs.get("fuse_act"), attrs.get("act_attrs"))
    out_scale = attrs.get("out_scale")
    if out_scale is not None:
        y = quantize(y, out_scale)
    return y


def conv_nhwc(x: torch.Tensor, w_oihw: torch.Tensor, strides, padding,
              dilations, groups: int) -> torch.Tensor:
    """NHWC float conv through torch's NCHW conv; returns NHWC."""
    xn = x.permute(0, 3, 1, 2)
    (ph0, ph1), (pw0, pw1) = padding
    if ph0 == ph1 and pw0 == pw1 and ph0 >= 0 and pw0 >= 0:
        pad = (ph0, pw0)
    else:
        xn = F.pad(xn, (pw0, pw1, ph0, ph1))
        pad = (0, 0)
    y = F.conv2d(xn, w_oihw, stride=strides, padding=pad, dilation=dilations,
                 groups=groups)
    return y.permute(0, 2, 3, 1).contiguous()


@OPS.kernel("conv2d", "torch")
@OPS.kernel("depthwise_conv2d", "torch")
def conv2d_torch(ctx, op, ins):
    x = ins["Input"][0]
    w = ins["Filter"][0]
    bias = ins.get("Bias", [None])[0]
    residual = ins.get("ResidualData", [None])[0]
    attrs = op.attrs
    strides = normalize_2d(attrs.get("strides", (1, 1)))
    dilations = normalize_2d(attrs.get("dilations", (1, 1)))
    padding = normalize_paddings(attrs.get("paddings", (0, 0)))
    groups = int(attrs.get("groups", 1))
    if op.op_type == "depthwise_conv2d":
        groups = x.shape[-1]
    int8_path = _check_dtypes(op, x, w)
    kh, kw, c_per_group = w.shape[:3]
    step = FP32_EXACT_K // (kh * kw) if int8_path else c_per_group
    if step < c_per_group and (groups != 1 or step == 0):
        raise NotImplementedError(
            f"{op.op_type}: an int8 conv with {groups} groups and K = "
            f"{kh * kw * c_per_group} a group is not exact on this route")
    # HWIO -> OIHW once per op (channels-last, the layout cuDNN reads NHWC
    # with), split into input-channel chunks of K <= FP32_EXACT_K if int8
    chunks = ctx.const(op, "w_oihw", lambda: [
        (c0, w[:, :, c0:c0 + step].to(torch.float32).permute(3, 2, 0, 1)
         .contiguous(memory_format=torch.channels_last))
        for c0 in range(0, c_per_group, step)])
    xf = x.to(torch.float32)  # a bf16 island value: exact products in fp32
    if len(chunks) == 1:
        acc = conv_nhwc(xf, chunks[0][1], strides, padding, dilations, groups)
        if int8_path:
            acc = torch.round(acc)
    else:  # exact per chunk; the int32 sum is exact, converted to fp32 once
        acc = sum(torch.round(conv_nhwc(xf[..., c0:c0 + wc.shape[1]], wc, strides,
                                        padding, dilations, 1)).to(torch.int32)
                  for c0, wc in chunks).to(torch.float32)
    y = _conv_epilogue(ctx, op, acc, op.input("Input"), op.input("Filter"),
                       bias, residual, op.maybe_input("ResidualData"),
                       int8_acc=int8_path)
    return {"Output": [y]}


# ---------------------------------------------------------------------------
# conv2d_transpose (``nn.py:173-253`` there)
# ---------------------------------------------------------------------------

@OPS.shape_fn("conv2d_transpose")
def conv2d_transpose_shape(attrs, in_shapes):
    (n, h, w, _), (kh, kw, _, oc_per_g) = in_shapes[0], in_shapes[1]
    sh, sw = normalize_2d(attrs.get("strides", (1, 1)))
    dh, dw = normalize_2d(attrs.get("dilations", (1, 1)))
    (ph0, ph1), (pw0, pw1) = normalize_paddings(attrs.get("paddings", (0, 0)))
    groups = int(attrs.get("groups", 1))
    oph, opw = normalize_2d(attrs.get("output_padding", (0, 0)))
    oh = (h - 1) * sh - ph0 - ph1 + dh * (kh - 1) + 1 + oph
    ow = (w - 1) * sw - pw0 - pw1 + dw * (kw - 1) + 1 + opw
    return [(n, oh, ow, oc_per_g * groups)]


@OPS.kernel("conv2d_transpose", "torch")
def conv2d_transpose_torch(ctx, op, ins):
    """Transposed conv in fp32: int8 operands dequantized, bf16 ones upcast
    (fp32 products and sums, the reference's ``preferred_element_type``).
    kernel == stride without padding is one (N·H·W, Ci)·(Ci, kh·kw·Co)
    product and a depth-to-space; otherwise the gradient form: the input
    dilated by the stride, padded by ``d·(k−1) − p`` (cropped where that is
    negative), convolved with the spatially flipped HWIO filter."""
    x, w = ins["Input"][0], ins["Filter"][0]
    bias = ins.get("Bias", [None])[0]
    attrs = op.attrs
    sh, sw = normalize_2d(attrs.get("strides", (1, 1)))
    dh, dw = normalize_2d(attrs.get("dilations", (1, 1)))
    (ph0, ph1), (pw0, pw1) = normalize_paddings(attrs.get("paddings", (0, 0)))
    oph, opw = normalize_2d(attrs.get("output_padding", (0, 0)))
    groups = int(attrs.get("groups", 1))
    if x.dtype == torch.int8:
        x = dequantize(x, ctx.var_quant(op.input("Input")).scale[0])
    if w.dtype == torch.int8:
        wq = ctx.var_quant(op.input("Filter"))
        w = dequantize(w, wq.scale_array(), axis=wq.axis)
    x, w = upcast(x), upcast(w)
    kh, kw, ci, co = w.shape
    n, h, wd, _ = x.shape
    if ((sh, sw) == (kh, kw) and dh == dw == 1 and groups == 1
            and ph0 == ph1 == pw0 == pw1 == 0 and oph == opw == 0):
        wm = w.permute(2, 0, 1, 3).reshape(ci, kh * kw * co)
        acc = (x.reshape(n * h * wd, ci) @ wm).reshape(n, h, wd, kh, kw, co)
        acc = acc.permute(0, 1, 3, 2, 4, 5).reshape(n, h * kh, wd * kw, co)
    else:
        xd = x.new_zeros((n, (h - 1) * sh + 1, (wd - 1) * sw + 1, x.shape[3]))
        xd[:, ::sh, ::sw] = x
        pads = (dh * (kh - 1) - ph0, dh * (kh - 1) - ph1 + oph,
                dw * (kw - 1) - pw0, dw * (kw - 1) - pw1 + opw)
        xn = F.pad(xd.permute(0, 3, 1, 2), (pads[2], pads[3], pads[0], pads[1]))
        wf = torch.flip(w, dims=(0, 1)).permute(3, 2, 0, 1)
        acc = F.conv2d(xn, wf, dilation=(dh, dw), groups=groups)
        acc = acc.permute(0, 2, 3, 1).contiguous()
    y = _conv_epilogue(ctx, op, acc, op.input("Input"), op.input("Filter"),
                       bias, None, None)
    return {"Output": [y]}


# ---------------------------------------------------------------------------
# fc / mul
# ---------------------------------------------------------------------------

def _matmul_acc(x2: torch.Tensor, w: torch.Tensor, int8_path: bool) -> torch.Tensor:
    if int8_path:
        # float64 holds every int8·int8 sum exactly; cast to fp32 rounds the
        # same integer the way an int32 -> fp32 conversion does
        return (x2.to(torch.float64) @ w.to(torch.float64)).to(torch.float32)
    return upcast(x2) @ upcast(w)  # bf16 operands: fp32 products and sums


@OPS.shape_fn("fc")
def fc_shape(attrs, in_shapes):
    x, w = in_shapes[0], in_shapes[1]
    in_num_col_dims = int(attrs.get("in_num_col_dims", len(x) - 1))
    return [tuple(x[:in_num_col_dims]) + (w[1],)]


@OPS.kernel("fc", "torch")
def fc_torch(ctx, op, ins):
    x = ins["Input"][0]
    w = ins["W"][0]  # (K, O)
    bias = ins.get("Bias", [None])[0]
    in_num_col_dims = int(op.attrs.get("in_num_col_dims", x.ndim - 1))
    lead = tuple(x.shape[:in_num_col_dims])
    x2 = x.reshape((-1, int(np.prod(x.shape[in_num_col_dims:]))))
    int8_path = _check_dtypes(op, x2, w)
    acc = _matmul_acc(x2, w, int8_path)
    y = _conv_epilogue(ctx, op, acc, op.input("Input"), op.input("W"),
                       bias, None, None, int8_acc=int8_path)
    return {"Out": [y.reshape(lead + (w.shape[1],))]}


@OPS.shape_fn("mul")
def mul_shape(attrs, in_shapes):
    x, y = in_shapes[0], in_shapes[1]
    xd = int(attrs.get("x_num_col_dims", 1))
    yd = int(attrs.get("y_num_col_dims", 1))
    return [tuple(x[:xd]) + tuple(y[yd:])]


@OPS.kernel("mul", "torch")
def mul_torch(ctx, op, ins):
    x, w = ins["X"][0], ins["Y"][0]
    xd = int(op.attrs.get("x_num_col_dims", 1))
    yd = int(op.attrs.get("y_num_col_dims", 1))
    lead, tail = tuple(x.shape[:xd]), tuple(w.shape[yd:])
    x2 = x.reshape((int(np.prod(lead)) if lead else 1, -1))
    w2 = w.reshape((-1, int(np.prod(tail)) if tail else 1))
    int8_path = _check_dtypes(op, x2, w2)
    acc = _matmul_acc(x2, w2, int8_path)
    y = _conv_epilogue(ctx, op, acc, op.input("X"), op.input("Y"),
                       None, None, None, int8_acc=int8_path)
    return {"Out": [y.reshape(lead + tail)]}


# ---------------------------------------------------------------------------
# batch_norm (standalone; usually folded into conv by conv_bn_fuse)
# ---------------------------------------------------------------------------

@OPS.shape_fn("batch_norm")
def bn_shape(attrs, in_shapes):
    return [in_shapes[0]]


@OPS.kernel("batch_norm", "torch")
def batch_norm_torch(ctx, op, ins):
    x = ins["X"][0]
    scale, bias = ins["Scale"][0], ins["Bias"][0]
    mean, var = ins["Mean"][0], ins["Variance"][0]
    eps = op.attrs.get("epsilon", 1e-5)
    inv = torch.rsqrt(var + eps) * scale
    return {"Y": [x * inv + (bias - mean * inv)]}


# ---------------------------------------------------------------------------
# pool2d
# ---------------------------------------------------------------------------

@OPS.shape_fn("pool2d")
def pool2d_shape(attrs, in_shapes):
    n, h, w, c = in_shapes[0]
    adaptive_1x1 = attrs.get("adaptive") and tuple(attrs.get("ksize") or ()) == (1, 1)
    if attrs.get("global_pooling") or adaptive_1x1:
        return [(n, 1, 1, c)]
    kh, kw = normalize_2d(attrs["ksize"])
    sh, sw = normalize_2d(attrs.get("strides", (1, 1)))
    (ph0, ph1), (pw0, pw1) = normalize_paddings(attrs.get("paddings", (0, 0)))
    if attrs.get("ceil_mode"):
        oh = -(-(h + ph0 + ph1 - kh) // sh) + 1
        ow = -(-(w + pw0 + pw1 - kw) // sw) + 1
    else:
        oh = (h + ph0 + ph1 - kh) // sh + 1
        ow = (w + pw0 + pw1 - kw) // sw + 1
    return [(n, oh, ow, c)]


def _round_int8(y: torch.Tensor) -> torch.Tensor:
    return torch.clamp(torch.round(y), -127, 127).to(torch.int8)


@OPS.kernel("pool2d", "torch")
def pool2d_torch(ctx, op, ins):
    x = ins["X"][0]
    attrs = op.attrs
    ptype = attrs.get("pooling_type", "max")
    is_int8 = x.dtype == torch.int8
    if attrs.get("global_pooling"):
        if ptype == "avg":
            if is_int8:
                # int32 sum / count in fp32, rounded half to even (nn.py:403-406)
                s = x.to(torch.int32).sum(dim=(1, 2), keepdim=True)
                cnt = f32(x.shape[1] * x.shape[2], x.device)
                y = _round_int8(s.to(torch.float32) / cnt)
            else:
                y = x.mean(dim=(1, 2), keepdim=True)
        else:
            y = x.amax(dim=(1, 2), keepdim=True)
        return {"Out": [y]}

    kh, kw = normalize_2d(attrs["ksize"])
    sh, sw = normalize_2d(attrs.get("strides", (1, 1)))
    (ph0, ph1), (pw0, pw1) = normalize_paddings(attrs.get("paddings", (0, 0)))
    n, h, w, c = x.shape
    if attrs.get("ceil_mode"):
        # extend right/bottom padding so the window grid covers the input
        oh = -(-(h + ph0 + ph1 - kh) // sh) + 1
        ow = -(-(w + pw0 + pw1 - kw) // sw) + 1
        ph1 = max(ph1, (oh - 1) * sh + kh - h - ph0)
        pw1 = max(pw1, (ow - 1) * sw + kw - w - pw0)
    pads = (pw0, pw1, ph0, ph1)
    xn = x.permute(0, 3, 1, 2).to(torch.float32)
    if ptype == "max":
        y = F.max_pool2d(F.pad(xn, pads, value=float("-inf")), (kh, kw), (sh, sw))
        y = y.permute(0, 2, 3, 1).contiguous()
        return {"Out": [y.to(torch.int8) if is_int8 else y]}
    s = F.avg_pool2d(F.pad(xn, pads), (kh, kw), (sh, sw), divisor_override=1)
    if attrs.get("exclusive", True):
        ones = F.pad(torch.ones((1, 1, h, w), device=x.device), pads)
        cnt = F.avg_pool2d(ones, (kh, kw), (sh, sw), divisor_override=1)
    else:
        cnt = f32(kh * kw, x.device)
    y = (s / cnt).permute(0, 2, 3, 1).contiguous()
    return {"Out": [_round_int8(y) if is_int8 else y]}


# ---------------------------------------------------------------------------
# softmax (an fp island: never int8, as in the reference)
# ---------------------------------------------------------------------------

@OPS.shape_fn("softmax")
def softmax_shape(attrs, in_shapes):
    return [in_shapes[0]]


@OPS.kernel("softmax", "torch")
def softmax_torch(ctx, op, ins):
    axis = int(op.attrs.get("axis", -1))
    return {"Out": [torch.softmax(ins["X"][0].to(torch.float32), dim=axis)]}
